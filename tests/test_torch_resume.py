"""A resumed training run is bit-exact (the port's own promise: a crash
costs no more than the steps since the last checkpoint).

* The embedding's backward (``layers.segment_sum_rows``) sums repeated
  token ids in a fixed order: its gradient matches the plain gather's at
  float32 tolerance and keeps its bits from call to call, and so does
  every leaf of a train step's ``value_and_grad``.
* The train CLI (``--smoke``, on the CPU) crashed by
  ``--inject-failure-at`` and then resumed ends on a final checkpoint whose
  every leaf has the bytes of an uninterrupted run's, with and without
  ``--grad-compression`` (whose error-feedback residual is checkpointed).
* A checkpoint written without the residual still restores, with a
  warning.
* ``segment_sum_rows``, made free of host syncs (ROADMAP C.3), gives the
  bits of its earlier version (copied here) on seeded ids with long runs,
  no repeats and one id.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.launch.steps import make_loss_fn, value_and_grad
from repro_torch.models import family_module, reduced
from repro_torch.models.layers import embed, segment_sum_rows
from repro_torch.models.tree import leaves

ARCHS = ["qwen3-8b", "rwkv6-3b", "zamba2-2.7b"]


def test_segment_sum_matches_the_plain_gather_and_keeps_its_bits():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((512, 256))
                             .astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 40, size=(8, 256)))
    g = torch.from_numpy(rng.standard_normal((8, 256, 256))
                         .astype(np.float32))
    want = torch.zeros_like(table).index_add_(0, ids.reshape(-1),
                                              g.reshape(-1, 256))
    got = [segment_sum_rows(g, ids, 512) for _ in range(5)]
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)
    tf = table.clone().requires_grad_()
    got += [torch.autograd.grad(embed({"table": tf}, ids), tf, g)[0]
            for _ in range(5)]
    for other in got[1:]:
        assert torch.equal(other, got[0])
    # through autograd, in bfloat16 as on the card
    t = table.to(torch.bfloat16).requires_grad_()
    out = embed({"table": t}, ids)
    gb = g.to(torch.bfloat16)
    (gt,) = torch.autograd.grad(out, t, gb)
    assert gt.dtype == torch.bfloat16      # summed in float32, then cast
    assert torch.equal(gt, segment_sum_rows(gb, ids, 512).to(torch.bfloat16))
    want_b = torch.zeros_like(table).index_add_(0, ids.reshape(-1),
                                                gb.float().reshape(-1, 256))
    torch.testing.assert_close(gt.float(), want_b, rtol=1e-2, atol=1e-2)


def _segment_sum_before(grad, ids, rows):
    """``segment_sum_rows`` as it stood with host syncs (run lengths read
    back to size its levels and masks), the bits to keep."""
    d = grad.shape[-1]
    ids = ids.reshape(-1)
    vals = grad.reshape(-1, d).float()
    ids_sorted, order = torch.sort(ids, stable=True)
    vals = vals[order]
    uniq, counts = torch.unique_consecutive(ids_sorted, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    run = torch.repeat_interleave(torch.arange(len(uniq)), counts)
    pos = torch.arange(len(ids)) - starts[run]
    cnt = counts[run]
    longest = int(counts.max()) if len(counts) else 0
    stride = 1
    while stride < longest:
        recv = torch.nonzero(((pos % (2 * stride)) == 0)
                             & (pos + stride < cnt))[:, 0]
        vals[recv] = vals[recv] + vals[recv + stride]
        stride *= 2
    out = vals.new_zeros((rows, d))
    out[uniq] = vals[starts]
    return out


SEGMENT_IDS = {
    "long-runs": lambda rng: rng.integers(0, 5, size=(4, 300)),
    "no-repeats": lambda rng: rng.permutation(1000)[:777].reshape(7, 111),
    "one-id": lambda rng: np.full((3, 50), 7),
    "mixed": lambda rng: rng.integers(0, 40, size=(8, 257)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(SEGMENT_IDS))
def test_segment_sum_keeps_the_bits_of_its_synced_version(case, dtype):
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(SEGMENT_IDS[case](rng))
    g = torch.from_numpy(rng.standard_normal((*ids.shape, 33))
                         .astype(np.float32)).to(dtype)
    got = segment_sum_rows(g, ids, 1000)
    want = _segment_sum_before(g, ids, 1000)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_value_and_grad_is_bit_stable(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    mod = family_module(cfg)
    params = mod.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    # 2048 tokens over 40 ids: the plain gather's backward varies here
    toks = torch.from_numpy(rng.integers(0, 40, size=(8, 257)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_fn = make_loss_fn(cfg, impl="torch")
    runs = [value_and_grad(loss_fn, params, batch) for _ in range(6)]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(leaves(grads), leaves(runs[0][1])):
            assert torch.equal(a, b)


def _files(ckdir: Path, step: int) -> dict[str, bytes]:
    d = ckdir / f"step-{step:012d}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    return {k: (d / e["file"]).read_bytes() for k, e in manifest.items()}


def _run(ckdir, *extra):
    train.main(["--smoke", "--device", "cpu", "--steps", "8",
                "--checkpoint-every", "3", "--checkpoint-dir", str(ckdir),
                *extra])


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "grad-compression"])
@pytest.mark.parametrize("arch", ARCHS)
def test_crashed_and_resumed_run_ends_on_the_same_bits(tmp_path, arch,
                                                       compress):
    extra = ["--arch", arch] + (["--grad-compression"] if compress else [])
    _run(tmp_path / "whole", *extra)
    with pytest.raises(SystemExit, match="injected failure at step 5"):
        _run(tmp_path / "crashed", *extra, "--inject-failure-at", "5")
    _run(tmp_path / "crashed", *extra)
    name = reduced(get_config(arch)).name
    want = _files(tmp_path / "whole" / name, 7)
    got = _files(tmp_path / "crashed" / name, 7)
    assert set(got) == set(want)
    assert len({k.split("__")[0] for k in got}) == (3 if compress else 2)
    for key in want:
        assert got[key] == want[key], key


def test_a_checkpoint_without_the_residual_restores(tmp_path, capsys):
    args = ["--arch", "qwen3-8b", "--steps", "4"]
    train.main(["--smoke", "--device", "cpu", "--checkpoint-every", "2",
                "--checkpoint-dir", str(tmp_path), *args])
    ckdir = tmp_path / reduced(get_config("qwen3-8b")).name
    from repro_torch.ft import CheckpointManager
    assert CheckpointManager(ckdir).arity(3) == 2
    with pytest.warns(UserWarning, match="restarts at zero"):
        train.main(["--smoke", "--device", "cpu", "--checkpoint-dir",
                    str(tmp_path), "--grad-compression", "--arch",
                    "qwen3-8b", "--steps", "6"])
    assert "resumed from checkpoint step 3" in capsys.readouterr().out
    assert CheckpointManager(ckdir).arity(5) == 3
