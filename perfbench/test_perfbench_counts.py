"""The benchmark's own arithmetic at the cells' shapes: the roofline bounds
(the attention and mamba2 counts at zamba2-2.7b's shapes, kept for the
program's other kernel ops), the parameter counts, the model FLOPs, the
quantiles; and the reference's parameter tree against the program's."""
import json
from pathlib import Path

import pytest

from perfbench import counts, weights
from perfbench.counts import Meta
from perfbench.reference import rwkv6

HERE = Path(__file__).resolve().parent
H100 = counts.peaks("NVIDIA H100 80GB HBM3")
BF16, F32 = 2, 4


def _model(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["model"]


def _meta(shape, itemsize=BF16, stride=None):
    if stride is None:
        stride, acc = [], 1
        for s in reversed(shape):
            stride.insert(0, acc)
            acc *= s
    return Meta(tuple(shape), tuple(stride), itemsize)


def test_flash_attention_bound_at_zamba2_shape():
    q = _meta((1, 4096, 32, 80))
    ops, nbytes = counts.attention_cost(q, q, q, causal=True)
    assert ops == 4 * 32 * 80 * 4096 * 4097 // 2
    assert counts.bound_s(ops, nbytes, H100) * 1e3 == pytest.approx(
        0.0869, abs=5e-5)
    assert ops / H100["bf16_flops"] > nbytes / H100["hbm_bytes_per_s"]


def test_mamba2_bound_at_zamba2_shape():
    x = _meta((1, 4096, 80, 64))
    a = _meta((1, 4096, 80))
    bc = _meta((1, 4096, 80, 64), stride=(4096 * 64, 64, 0, 1))
    ops, nbytes = counts.mamba2_cost(x, a, bc, bc, None)
    assert bc.stored == 4096 * 64 * BF16            # read once, not per head
    assert nbytes == 2 * 4096 * 80 * 64 * BF16 + 4096 * 80 * BF16 \
        + 2 * 4096 * 64 * BF16 + 80 * 64 * 64 * F32
    assert counts.bound_s(ops, nbytes, H100) * 1e3 == pytest.approx(
        0.0259, abs=5e-5)


def test_rwkv6_bound_at_rwkv6_shape():
    t = _meta((1, 4096, 40, 64))
    u = _meta((40, 64))
    ops, nbytes = counts.rwkv6_cost(t, t, t, t, u, None)
    assert ops == (4 * 64 * 64 + 3 * 16 * 64 + 16 * 64) * 4096 * 40
    assert counts.bound_s(ops, nbytes, H100) * 1e3 == pytest.approx(
        0.0315, abs=5e-5)


def test_call_cost_takes_the_recorded_call():
    q = _meta((1, 64, 4, 16))
    assert counts.call_cost("attention", [q, q, q], {"causal": False}) \
        == counts.attention_cost(q, q, q, causal=False)
    assert counts.call_cost("attention", [q, q, q], {})[0] \
        == 4 * 4 * 16 * 64 * 65 // 2


@pytest.mark.parametrize("name,ref,params,matmul", [
    ("rwkv6-3b", rwkv6, 3.073e9, 2.905e9)])
def test_parameter_counts(name, ref, params, matmul):
    spec = ref.param_tree(_model(name))
    assert weights.count(spec) == pytest.approx(params, rel=5e-4)
    assert weights.matmul_params(spec) == pytest.approx(matmul, rel=5e-4)


@pytest.mark.parametrize("name,ref,tflop", [("rwkv6-3b", rwkv6, 23.9)])
def test_forward_flops_of_a_4096_token_sequence(name, ref, tflop):
    m = _model(name)
    spec = ref.param_tree(m)
    f = counts.model_flops(weights.matmul_params(spec), ref.seq_ops(m, 4096),
                           4096)
    assert f / 1e12 == pytest.approx(tflop, abs=0.05)


def test_quantile_is_an_exact_order_statistic():
    xs = list(range(1, 201))                   # 1..200
    assert counts.quantile(xs, 0.95) == 190
    assert counts.quantile(reversed(xs), 0.5) == 100
    assert counts.quantile([7.0], 0.95) == 7.0
    assert counts.quantile([3, 1, 2], 1.0) == 3
    assert counts.quantile([5, 1, 4, 2, 3], 0.95) == 5


def test_peaks_need_a_known_card():
    with pytest.raises(KeyError):
        counts.peaks("cpu")


@pytest.mark.parametrize("name,ref", [("rwkv6-3b", rwkv6)])
def test_reference_tree_is_the_programs(name, ref):
    from repro_torch.models import abstract, family_module
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(**_model(name))
    tree = abstract(family_module(cfg).init, cfg, device="cpu")

    def walk(t, p=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, p + (k,))
        else:
            yield p, (tuple(t.shape), str(t.dtype).removeprefix("torch."))
    spec = [(p, (leaf.shape, leaf.dtype))
            for p, leaf in weights.leaves(ref.param_tree(_model(name)))]
    assert spec == list(walk(tree))


def test_weights_repeat_from_the_seed():
    import torch

    spec = rwkv6.param_tree({**_model("rwkv6-3b"), "n_layers": 2,
                             "d_model": 32, "d_ff": 64, "vocab": 64,
                             "rwkv_head_dim": 16})
    a = weights.make(spec, 2**40 + 3, "cpu")
    b = weights.make(spec, 2**40 + 3, "cpu")
    c = weights.make(spec, 2**40 + 4, "cpu")
    for (_, x), (_, y), (_, z) in zip(weights.leaves(a), weights.leaves(b),
                                      weights.leaves(c)):
        assert torch.equal(x, y)
    assert not torch.equal(a["layers"]["wr"], c["layers"]["wr"])
    assert torch.all(a["layers"]["ln1"] == 1)
    assert torch.all(a["layers"]["w0"] == -1)
    assert a["layers"]["wr"].dtype == torch.bfloat16
    std = a["layers"]["wr"].float().std()
    assert float(std) == pytest.approx(32 ** -0.5, rel=0.1)
