"""The port's DQN (``repro_torch.core.qlearning``) against the reference's
JAX DQN, and the port's software DSE against the reference's.

``jax.random`` initialisation cannot be reproduced in torch, so the parity
tests carry the reference's initial weights across: ``_init_bank`` of the
port is monkeypatched to return the reference's ``_bank_init`` parameters
through ``params_from_numpy``.  From the same weights:

* Q-values agree at rtol 1e-6 (one forward; only f32 summation order
  differs between XLA's and torch's CPU products);
* a seeded multi-round ``train_round`` trajectory picks the same actions and
  ends at weights that agree at rtol 1e-5 (hand-written Adam in f32 rounds
  differently step after step).

Inside the port a bank slot is bit-identical to a standalone ``DQN`` (the
reference's own invariant, ``tests/test_sw_engine.py``), and the software
DSE engines agree bit for bit; with the DQN off, ``run_searches`` is
bit-identical to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.qlearning as RQ
import repro_torch.core.qlearning as TQ
from repro.core import sw_dse as R_sw
from repro.core import workloads as R_W
from repro.core.hw_primitives import HWBuilder as R_HWB
from repro.core.intrinsics import ALL_INTRINSICS as R_INTR
from repro.core.matching import match as R_match
from repro_torch.core import sw_dse as T_sw
from repro_torch.core import workloads as T_W
from repro_torch.core.hw_primitives import HWBuilder as T_HWB
from repro_torch.core.intrinsics import ALL_INTRINSICS as T_INTR
from repro_torch.core.matching import match as T_match

SEEDS = [7, 11, 13]
N_FEAT, N_ACT, K = 6, 5, 4


def reference_init(seeds, sizes, device):
    """The reference's stacked initial weights, as the port's tensors."""
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    tree = jax.tree_util.tree_map(np.asarray, RQ._bank_init(keys, sizes))
    return TQ.params_from_numpy(tree, device)


@pytest.fixture
def jax_init(monkeypatch):
    monkeypatch.setattr(TQ, "_init_bank", reference_init)


def _assert_params_close(ref_params, port_params, rtol, atol):
    for lr, lt in zip(ref_params, port_params):
        for k in ("w", "b"):
            np.testing.assert_allclose(lt[k].detach().numpy(),
                                       np.asarray(lr[k]), rtol=rtol,
                                       atol=atol)


def test_q_values_match_from_carried_weights(jax_init):
    ref = RQ.DQN(N_FEAT, N_ACT, seed=7)
    port = TQ.DQN(N_FEAT, N_ACT, seed=7, device="cpu")
    _assert_params_close(ref.params, port.params, 0, 0)   # carried exactly
    feats = np.random.default_rng(0).random((16, N_FEAT)).astype(np.float32)
    np.testing.assert_allclose(port.q_values_batch(feats),
                               ref.q_values_batch(feats), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(port.q_values(feats[3]), ref.q_values(feats[3]),
                               rtol=1e-6, atol=1e-7)


def _drive(bank, rounds=12, seed=0):
    """Seeded rounds of select + train (48 transitions per slot: crosses the
    32-sample minibatch threshold, so the networks train)."""
    rng = np.random.default_rng(seed)
    acts = []
    for _ in range(rounds):
        feats = rng.random((len(SEEDS), K, N_FEAT)).astype(np.float32)
        a = bank.select_round(feats)
        acts.append(a)
        s2 = rng.random((len(SEEDS), K, N_FEAT)).astype(np.float32)
        rewards = rng.uniform(-1, 1, (len(SEEDS), K))
        bank.train_round(feats, a, rewards, s2)
    return np.stack(acts)


def test_train_round_trajectory_matches_reference(jax_init):
    ref = RQ.DQNBank(N_FEAT, N_ACT, SEEDS)
    port = TQ.DQNBank(N_FEAT, N_ACT, SEEDS, device="cpu")
    acts_r, acts_t = _drive(ref), _drive(port)
    np.testing.assert_array_equal(acts_r, acts_t)
    np.testing.assert_array_equal(np.asarray(ref.t), port.t)
    np.testing.assert_array_equal(ref.eps, port.eps)
    assert port.t.min() > 0                       # the networks did train
    _assert_params_close(ref.params, port.params, 1e-5, 1e-6)
    feats = np.random.default_rng(1).random((len(SEEDS), K, N_FEAT))
    np.testing.assert_allclose(
        np.stack([s.q_values(f) for s, f in zip(port.slots, feats)]),
        ref.q_values_round(feats), rtol=1e-5, atol=1e-6)


def test_bank_slots_bit_identical_to_standalone_dqns():
    """The reference's invariant, inside the port: same init, same
    epsilon-greedy stream, same weights after training."""
    bank = TQ.DQNBank(N_FEAT, N_ACT, SEEDS, device="cpu")
    dqns = [TQ.DQN(N_FEAT, N_ACT, seed=s, device="cpu") for s in SEEDS]
    rng = np.random.default_rng(0)
    for _ in range(12):
        feats = rng.random((len(SEEDS), K, N_FEAT)).astype(np.float32)
        counts = [K, 2, 0]                        # ragged frontiers
        acts_b = bank.select_round(feats, counts=counts)
        for si, (d, m) in enumerate(zip(dqns, counts)):
            if m:
                np.testing.assert_array_equal(
                    acts_b[si, :m], d.select_batch(feats[si, :m]))
        s2 = rng.random((len(SEEDS), K, N_FEAT)).astype(np.float32)
        rewards = rng.uniform(-1, 1, (len(SEEDS), K))
        for si, (d, m) in enumerate(zip(dqns, counts)):
            for j in range(m):
                d.record(feats[si, j], int(acts_b[si, j]),
                         float(rewards[si, j]), s2[si, j])
                d.train_step()
        bank.train_round(feats, acts_b, rewards, s2, counts=counts)
    assert bank.t[0] > 0
    for si, d in enumerate(dqns):
        assert bank.eps[si] == d.eps and bank.t[si] == d.t
        for li, layer in enumerate(d.params):
            for k in ("w", "b"):
                assert torch.equal(bank.params[li][k][si], layer[k])


def test_port_init_is_seeded_he_normal():
    a = TQ._init_bank([3], (64, 64, 5), "cpu")
    b = TQ._init_bank([3, 4], (64, 64, 5), "cpu")
    assert torch.equal(a[0]["w"][0], b[0]["w"][0])   # per-seed generator
    assert not torch.equal(b[0]["w"][0], b[0]["w"][1])
    assert abs(float(b[0]["w"].std()) - (2 / 64) ** 0.5) < 0.02
    assert not b[1]["b"].any()


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TQ.DQN(N_FEAT, N_ACT)                     # the default device


def _mixed_specs(W, HWB, INTR, match, SearchSpec, seed):
    """gemm + conv2d on a GEMM array, mttkrp on a GEMV engine (the mix of
    tests/test_sw_engine.py), built from either package."""
    wl_g = W.gemm(256, 256, 128, name="g")
    wl_c = W.conv2d(32, 16, 14, 14, name="c")
    wl_m = W.mttkrp(64, 32, 64, 32, name="m")
    hw_g = (HWB("GEMM").reshapeArray([16, 16], depth=16)
            .addCache(256).partitionBanks(2).build())
    hw_v = (HWB("GEMV").reshapeArray([32], depth=64)
            .addCache(128).partitionBanks(2).build())
    return [SearchSpec(wl_g, match(INTR["GEMM"], wl_g), hw_g, seed),
            SearchSpec(wl_c, match(INTR["GEMM"], wl_c), hw_g, seed + 17),
            SearchSpec(wl_m, match(INTR["GEMV"], wl_m), hw_v, seed + 34)]


def _port_specs(seed):
    return _mixed_specs(T_W, T_HWB, T_INTR, T_match, T_sw.SearchSpec, seed)


def _identical(a, b):
    assert [r.schedule.describe() for r in a] == \
        [r.schedule.describe() for r in b]
    assert [r.latency_s for r in a] == [r.latency_s for r in b]
    assert [r.evaluations for r in a] == [r.evaluations for r in b]
    assert [r.history for r in a] == [r.history for r in b]


@pytest.mark.parametrize("engine", ["batched", "reference"])
def test_run_searches_without_qlearning_bit_identical_to_reference(engine):
    ref = R_sw.run_searches(
        _mixed_specs(R_W, R_HWB, R_INTR, R_match, R_sw.SearchSpec, 1),
        engine=engine, use_qlearning=False, **R_sw.BUDGETS["small"])
    port = T_sw.run_searches(_port_specs(1), engine=engine,
                             use_qlearning=False, **T_sw.BUDGETS["small"])
    _identical(ref, port)


@pytest.mark.parametrize("budget", ["small", "full"])
def test_port_engines_agree_with_qlearning(budget):
    """The lock-step engine reproduces the per-search reference engine bit
    for bit inside the port (the full tier trains the DQNs)."""
    kw = dict(use_qlearning=True, device="cpu", **T_sw.BUDGETS[budget])
    _identical(T_sw.run_searches(_port_specs(3), engine="reference", **kw),
               T_sw.run_searches(_port_specs(3), engine="batched", **kw))
