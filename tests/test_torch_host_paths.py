"""The software DSE's host paths that were rewritten to cut the lock-step
engine's host time, against the code they replaced: on seeded streams
they give the same bits and leave every ``np.random.Generator`` in the
same state.  The oracles are the reference's own functions where it has
them, else the replaced code, kept here.

* The replay: ``DQNBank.train_round``'s inserts and minibatch draws and
  ``DQN.record``/``train_step``, against the reference's ``Replay`` driven
  by the per-transition loop and ``_pack`` that they replaced, through
  buffers that fill and wrap.
* ``SoftwareSpace.random_schedule`` against the reference's, over many
  draws on every software space of ``bench_sw_dse`` and on the other
  intrinsics' spaces.
* ``cost_model._reports`` against the reference's per-row ``_report_at``,
  field by field and type by type, illegal and overflowing rows among
  them.
* ``sw_dse._reward``'s clip against ``np.clip``, signed zeros included.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:                  # the reference's benchmarks/
    sys.path.insert(0, str(ROOT))

import repro.core.cost_model as R_cost                      # noqa: E402
import repro.core.hw_space as R_hws                         # noqa: E402
import repro.core.intrinsics as R_intr                      # noqa: E402
import repro.core.matching as R_match                       # noqa: E402
import repro.core.sw_space as R_sws                         # noqa: E402
import repro.core.workloads as R_W                          # noqa: E402
import repro_torch.core.cost_model as C                     # noqa: E402
import repro_torch.core.hw_space as T_hws                   # noqa: E402
import repro_torch.core.intrinsics as T_intr                # noqa: E402
import repro_torch.core.matching as T_match                 # noqa: E402
import repro_torch.core.sw_space as T_sws                   # noqa: E402
import repro_torch.core.workloads as T_W                    # noqa: E402
from benchmarks import bench_sw_dse as R_bench              # noqa: E402
from repro.core.qlearning import Replay as RefReplay        # noqa: E402
from repro_torch.bench import bench_sw_dse as T_bench       # noqa: E402
from repro_torch.core.qlearning import DQN, DQNBank         # noqa: E402

F, A = 6, 5


# -- the replaced code --------------------------------------------------------

def old_pack(batches, m, batch, n_feat):
    out = np.zeros((len(batches), m, batch, 2 * n_feat + 4), np.float32)
    for si, drawn in enumerate(batches):
        for step, (s, a, r, s2, d) in enumerate(drawn):
            rows = out[si, step]
            rows[:, :n_feat], rows[:, n_feat:2 * n_feat] = s, s2
            rows[:, 2 * n_feat], rows[:, 2 * n_feat + 1] = a, r
            rows[:, 2 * n_feat + 2] = d
            rows[:, 2 * n_feat + 3] = 1.0
    return out


class OldBank:
    """The bank's host half as it was: per-transition inserts and draws,
    then ``_pack``."""

    def __init__(self, seeds, buffer, batch):
        self.replays = [RefReplay(buffer) for _ in seeds]
        self.rngs = [np.random.default_rng(s) for s in seeds]
        self.eps = np.full(len(seeds), 1.0)
        self.batch = batch

    def train_round(self, s, a, r, s2, done=None, counts=None):
        N, k = a.shape
        if done is None:
            done = np.zeros((N, k), np.float32)
        batches = [[] for _ in range(N)]
        for si in range(N):
            rep, rng = self.replays[si], self.rngs[si]
            for j in range(k if counts is None else counts[si]):
                rep.add(np.asarray(s[si, j], np.float32), a[si, j], r[si, j],
                        np.asarray(s2[si, j], np.float32), done[si, j])
                if rep.n >= self.batch:
                    batches[si].append(rep.sample(rng, self.batch))
                    self.eps[si] = max(0.05, self.eps[si] * 0.97)
        if all(len(b) == 0 for b in batches):
            return None
        return old_pack(batches, k, self.batch, s.shape[-1])


# -- the replay ---------------------------------------------------------------

def _captured(state) -> list:
    """Replace ``state.train`` by a recorder of the packed rounds."""
    seen = []

    def train(packed):
        seen.append(packed.copy())
        return torch.zeros(packed.shape[:2])
    state.train = train
    return seen


def _same_replay(new, old):
    assert (new.n, new.ptr) == (old.n, old.ptr)
    if old.s is None:
        assert new.rows is None
        return
    rows = new.rows
    np.testing.assert_array_equal(rows[:, :F], old.s)
    np.testing.assert_array_equal(rows[:, F:2 * F], old.s2)
    np.testing.assert_array_equal(rows[:, 2 * F], old.a.astype(np.float32))
    np.testing.assert_array_equal(rows[:, 2 * F + 1], old.r)
    np.testing.assert_array_equal(rows[:, 2 * F + 2], old.done)


@pytest.mark.parametrize("buffer,batch,k,ragged", [
    (4096, 32, 6, True),      # bench_sw_dse's sizes
    (40, 32, 7, False),       # fills and wraps inside a round
    (33, 8, 6, True),         # wraps, ragged rounds, small minibatches
    (12, 12, 5, True),        # minibatch = buffer: draws only once full
    (7, 4, 9, False),         # a round longer than the buffer
])
def test_bank_round_packs_the_per_transition_draws(buffer, batch, k, ragged):
    seeds = [3, 10, 17]
    bank = DQNBank(F, A, seeds, buffer=buffer, batch=batch, device="cpu")
    seen = _captured(bank.state)
    old = OldBank(seeds, buffer, batch)
    rng = np.random.default_rng(buffer)
    for rnd in range(14):
        s = rng.random((3, k, F)).astype(np.float32)
        s2 = rng.random((3, k, F))              # float64: cast on insert
        a = rng.integers(0, A, (3, k))
        r = rng.uniform(-1, 1, (3, k))
        done = (rng.random((3, k)) < 0.2).astype(np.float32) \
            if rnd % 2 else None
        counts = ([k, rnd % (k + 1), max(0, k - 2)] if ragged else None)
        n_seen = len(seen)
        bank.train_round(s, a, r, s2, done, counts=counts)
        want = old.train_round(s, a, r, s2, done, counts=counts)
        if want is None:
            assert len(seen) == n_seen
        else:
            assert len(seen) == n_seen + 1
            np.testing.assert_array_equal(seen[-1], want)
        np.testing.assert_array_equal(bank.eps, old.eps)
        for si in range(3):
            assert (bank.rngs[si].bit_generator.state
                    == old.rngs[si].bit_generator.state)
            _same_replay(bank.replays[si], old.replays[si])
    assert seen                                  # the replays warmed


@pytest.mark.parametrize("buffer", [4096, 40])
def test_dqn_step_packs_the_old_draw(buffer):
    dqn = DQN(F, A, seed=5, buffer=buffer, device="cpu")
    seen = _captured(dqn.state)
    rep, rng = RefReplay(buffer), np.random.default_rng(5)
    data = np.random.default_rng(1)
    for i in range(120):
        s, s2 = data.random(F), data.random(F).astype(np.float32)
        a, r, done = int(data.integers(A)), float(data.uniform(-1, 1)), i % 9 == 0
        dqn.record(s, a, r, s2, done)
        rep.add(np.asarray(s, np.float32), a, r, np.asarray(s2, np.float32),
                done)
        n_seen = len(seen)
        got = dqn.train_step()
        if rep.n < 32:
            assert got is None and len(seen) == n_seen
            continue
        want = old_pack([[rep.sample(rng, 32)]], 1, 32, F)
        np.testing.assert_array_equal(seen[-1], want)
        assert dqn.rng.bit_generator.state == rng.bit_generator.state
    _same_replay(dqn.replay, rep)


# -- random_schedule ----------------------------------------------------------

def _spaces(bench, W, hws, intr, match, sws):
    """bench_sw_dse's 16 software spaces, then five of the other
    intrinsics', built from one package's modules."""
    out = [sws.SoftwareSpace(sp.workload, sp.choices, sp.hw)
           for sp in bench._specs()]
    rng = np.random.default_rng(0)
    for wl, name in [(W.conv2d(64, 32, 28, 28), "CONV2D"),
                     (W.gemm(512, 256, 128), "GEMV"),
                     (W.gemm(512, 256, 128), "DOT"),
                     (W.ttm(128, 64, 64, 64), "GEMM"),
                     (W.gemv(300, 70), "GEMV")]:
        hw = hws.HWSpace(name).sample(rng, 1)[0]
        out.append(sws.SoftwareSpace(
            wl, match.match(intr.ALL_INTRINSICS[name], wl), hw))
    return out


def test_random_schedule_draws_as_the_reference():
    pairs = list(zip(_spaces(T_bench, T_W, T_hws, T_intr, T_match, T_sws),
                     _spaces(R_bench, R_W, R_hws, R_intr, R_match, R_sws)))
    assert len(pairs) == 21
    for i, (space, ref) in enumerate(pairs):
        new, old = np.random.default_rng(i), np.random.default_rng(i)
        for _ in range(1500):
            got, want = space.random_schedule(new), ref.random_schedule(old)
            assert repr(got) == repr(want)
            assert all(type(t) is int for _, t in got.tiles)
            assert type(got.fuse_outer) is int
        assert new.bit_generator.state == old.bit_generator.state


# -- the cost model's reports -------------------------------------------------

def test_reports_equal_the_references_per_row_reports():
    rng = np.random.default_rng(2)
    wl = T_W.gemm(512, 256, 128)
    choices = T_match.match(T_intr.ALL_INTRINSICS["GEMM"], wl)
    # GEMV hardware under GEMM choices: illegal rows (intrinsic mismatch)
    hws = T_hws.HWSpace("GEMM").sample(rng, 6) + T_hws.HWSpace("GEMV").sample(
        rng, 2)
    space = T_sws.SoftwareSpace(wl, choices, hws[0])
    scheds = [space.random_schedule(rng) for _ in range(400)]
    rows = [hws[int(rng.integers(len(hws)))] for _ in scheds]
    prep = C._get_prep(wl)
    for target in ("spatial", "tpu"):
        out = C._batch_group(prep, C.TARGETS[target], rows, scheds)
        got = C._reports(prep, out)
        want = [R_cost._report_at(prep, out, i) for i in range(len(scheds))]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is C.ILLEGAL) == (w is R_cost.ILLEGAL)
            for f in R_cost.CostReport.__dataclass_fields__:
                a, b = getattr(g, f), getattr(w, f)
                assert type(a) is type(b), f
                assert a == b or (a != a and b != b), f
        kinds = {(w is R_cost.ILLEGAL, bool(w.why_illegal)) for w in want}
        assert kinds == {(True, False), (False, True), (False, False)}


def test_reward_clips_as_numpy_did():
    from repro_torch.core.sw_dse import _reward

    rng = np.random.default_rng(3)
    prev = np.concatenate([rng.uniform(1e-9, 1e-3, 4000), [1.0, 2.0, 5e-7]])
    new = np.concatenate([prev[:4000] * rng.uniform(-1, 3.5, 4000),
                          [1.0, 2.0, 5e-7]])           # equal: +0.0
    pairs = list(zip(prev.tolist(), new.tolist()))
    pairs += [(1.0, math.inf), (math.inf, 1.0), (0.0, 1.0), (-1.0, 2.0),
              (2.0, -1e9), (3.0, 6.0), (3.0, 9.0)]
    for p, q in pairs:
        if math.isfinite(q) and math.isfinite(p) and p > 0:
            want = float(np.clip((p - q) / p, -1.0, 1.0))
        else:
            want = -1.0 if not math.isfinite(q) else 0.0
        got = _reward(p, q)
        assert type(got) is float and got == want
        assert math.copysign(1.0, got) == math.copysign(1.0, want)
