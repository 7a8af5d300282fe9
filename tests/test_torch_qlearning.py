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

Inside the port a bank slot is bit-identical to a standalone ``DQN`` and to
a 1-seed bank whatever the bank's size (the reference's own invariant,
``tests/test_sw_engine.py``): one program, of which the standalone ``DQN``
is the N=1 instance.  ``select_round`` makes one batched forward and
``train_round`` one call of the stacked train steps per warm round.  The
software DSE engines agree bit for bit; with the DQN off, ``run_searches``
is bit-identical to the reference's.
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    torch's default of a thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    n = bank.n_searches
    acts = []
    for _ in range(rounds):
        feats = rng.random((n, K, N_FEAT)).astype(np.float32)
        a = bank.select_round(feats)
        acts.append(a)
        s2 = rng.random((n, K, N_FEAT)).astype(np.float32)
        rewards = rng.uniform(-1, 1, (n, K))
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
    np.testing.assert_allclose(port.q_values_round(feats),
                               ref.q_values_round(feats), rtol=1e-5,
                               atol=1e-6)


RAGGED = (K, K, K - 1, K, 2, 0, K, 1)     # frontier sizes, rotated per slot


def _ragged(n: int, rnd: int) -> list[int]:
    return [RAGGED[(si + rnd) % len(RAGGED)] for si in range(n)]


@pytest.mark.parametrize("n", [1, 4, 16])
def test_bank_slots_bit_identical_to_standalone_dqns(n):
    """The reference's invariant, inside the port: slot i of an n-seed
    bank, the 1-seed bank of seed i and a standalone ``DQN`` of seed i take
    the same actions and end at the same weights, bit for bit, through
    ragged rounds."""
    seeds = [3 + 7 * i for i in range(n)]
    bank = TQ.DQNBank(N_FEAT, N_ACT, seeds, device="cpu")
    ones = [TQ.DQNBank(N_FEAT, N_ACT, [s], device="cpu") for s in seeds]
    dqns = [TQ.DQN(N_FEAT, N_ACT, seed=s, device="cpu") for s in seeds]
    rng = np.random.default_rng(0)
    for rnd in range(16):
        feats = rng.random((n, K, N_FEAT)).astype(np.float32)
        counts = _ragged(n, rnd)
        acts_b = bank.select_round(feats, counts=counts)
        s2 = rng.random((n, K, N_FEAT)).astype(np.float32)
        rewards = rng.uniform(-1, 1, (n, K))
        for si, (one, d, m) in enumerate(zip(ones, dqns, counts)):
            acts_1 = one.select_round(feats[si:si + 1], counts=[m])
            np.testing.assert_array_equal(acts_1, acts_b[si:si + 1])
            if m:
                np.testing.assert_array_equal(
                    acts_b[si, :m], d.select_batch(feats[si, :m]))
            for j in range(m):
                d.record(feats[si, j], int(acts_b[si, j]),
                         float(rewards[si, j]), s2[si, j])
                d.train_step()
            one.train_round(feats[si:si + 1], acts_b[si:si + 1],
                            rewards[si:si + 1], s2[si:si + 1], counts=[m])
        bank.train_round(feats, acts_b, rewards, s2, counts=counts)
    assert bank.t.min() > 0                       # every slot trained
    for si, (one, d) in enumerate(zip(ones, dqns)):
        assert bank.eps[si] == d.eps == one.eps[0]
        assert bank.t[si] == d.t == one.t[0]
        for li, layer in enumerate(d.params):
            for k in ("w", "b"):
                assert torch.equal(bank.params[li][k][si], layer[k])
                assert torch.equal(one.params[li][k][0], layer[k])


def test_bank_replay_wraps_like_a_standalone_dqn():
    """A replay of 40 rows fills and wraps within a round: the bank's
    inserts and draws read what the standalone ``DQN``'s per-transition
    loop reads (a draw before a later insert of the round overwrites a
    row sees its earlier value), so a slot ends on its ``DQN``'s bits."""
    seeds = [2, 9]
    bank = TQ.DQNBank(N_FEAT, N_ACT, seeds, buffer=40, device="cpu")
    dqns = [TQ.DQN(N_FEAT, N_ACT, seed=s, buffer=40, device="cpu")
            for s in seeds]
    rng = np.random.default_rng(4)
    k = 7                                     # 40 is no multiple of 7
    for _ in range(14):
        feats = rng.random((2, k, N_FEAT)).astype(np.float32)
        acts = bank.select_round(feats)
        s2 = rng.random((2, k, N_FEAT)).astype(np.float32)
        rewards = rng.uniform(-1, 1, (2, k))
        for si, d in enumerate(dqns):
            np.testing.assert_array_equal(acts[si], d.select_batch(feats[si]))
            for j in range(k):
                d.record(feats[si, j], int(acts[si, j]),
                         float(rewards[si, j]), s2[si, j])
                d.train_step()
        bank.train_round(feats, acts, rewards, s2)
    for si, d in enumerate(dqns):
        assert bank.replays[si].n == d.replay.n == 40
        assert bank.replays[si].ptr == d.replay.ptr
        np.testing.assert_array_equal(bank.replays[si].s, d.replay.s)
        assert bank.t[si] == d.t and bank.eps[si] == d.eps
        for li, layer in enumerate(d.params):
            for key in ("w", "b"):
                assert torch.equal(bank.params[li][key][si], layer[key])


def test_one_forward_per_round_one_train_call_per_warm_round(monkeypatch):
    """``select_round`` scores every frontier in one ``_bank_forward``;
    ``train_round`` makes one ``_bank_train_steps`` call for a warm round
    and none for a cold one."""
    calls = {"forward": 0, "train": 0}
    forward, train = TQ._bank_forward, TQ._bank_train_steps

    def count_forward(*args):
        calls["forward"] += 1
        return forward(*args)

    def count_train(*args):
        calls["train"] += 1
        return train(*args)

    bank = TQ.DQNBank(N_FEAT, N_ACT, SEEDS, device="cpu")
    rng = np.random.default_rng(0)
    warm_rounds = 0
    for rnd in range(12):
        feats = rng.random((len(SEEDS), K, N_FEAT)).astype(np.float32)
        counts = [K, 2, 0]
        monkeypatch.setattr(TQ, "_bank_forward", count_forward)
        calls["forward"] = 0
        acts = bank.select_round(feats, counts=counts)
        assert calls["forward"] == 1
        monkeypatch.setattr(TQ, "_bank_forward", forward)
        monkeypatch.setattr(TQ, "_bank_train_steps", count_train)
        calls["train"] = 0
        t0 = bank.t.copy()
        warm = any(rep.n + m >= bank.batch
                   for rep, m in zip(bank.replays, counts))
        bank.train_round(feats, acts, rng.uniform(-1, 1, (len(SEEDS), K)),
                         rng.random((len(SEEDS), K, N_FEAT)), counts=counts)
        monkeypatch.setattr(TQ, "_bank_train_steps", train)
        assert calls["train"] == int(warm)
        assert (bank.t != t0).any() == warm
        warm_rounds += warm
    assert 0 < warm_rounds < 12                   # both kinds of round ran


def _trained_state(seeds, rounds=10):
    """A bank driven through ``rounds`` warm rounds: non-zero moments and
    update counts."""
    bank = TQ.DQNBank(N_FEAT, N_ACT, seeds, device="cpu")
    _drive(bank, rounds=rounds)
    return bank.state


def _packed(n, m, rng, do_train):
    """Random minibatches in ``_pack``'s layout, ``do_train`` (n, m)."""
    bat = 32
    F = N_FEAT
    P = np.zeros((n, m, bat, 2 * F + 4), np.float32)
    P[..., :2 * F] = rng.random((n, m, bat, 2 * F))
    P[..., 2 * F] = rng.integers(0, N_ACT, (n, m, bat))
    P[..., 2 * F + 1] = rng.uniform(-1, 1, (n, m, bat))
    P[..., 2 * F + 2] = rng.random((n, m, bat)) < 0.2
    P[..., 2 * F + 3] = np.asarray(do_train, np.float32)[:, :, None]
    return P


def _leaves(state) -> dict:
    return {"params": state.params, "target": state.target, "m": state.m,
            "v": state.v}


def _copy(state) -> dict:
    out = {name: [x.clone() for layer in tree for x in layer.values()]
           for name, tree in _leaves(state).items()}
    return out | {"t": [state.t.clone()]}


def test_step_without_do_train_changes_nothing():
    """A slot whose steps all have ``do_train`` false keeps its params,
    target, ``m``, ``v`` and ``t`` bitwise; the slots that train move."""
    state = _trained_state(SEEDS)
    before = _copy(state)
    dt = np.array([[True, False], [False, False], [False, True]])
    TQ._bank_train_steps(*state.carry(),
                         *TQ._unpack(torch.from_numpy(
                             _packed(3, 2, np.random.default_rng(5), dt)),
                             N_FEAT), state.gamma)
    after = _copy(state)
    for name in before:
        for b, a in zip(before[name], after[name]):
            assert torch.equal(b[1], a[1]), name  # every step masked
            if name in ("params", "m", "v"):
                assert not torch.equal(b[0], a[0]), name
                assert not torch.equal(b[2], a[2]), name
    assert (after["t"][0] - before["t"][0]).tolist() == [1, 0, 1]


def test_bias_corrections_do_not_depend_on_n():
    """A slot's Adam bias corrections are the same bits whether it is
    computed alone or among thousands of slots (PyTorch's CPU ``pow``
    rounds its vectorised body and its scalar tail differently)."""
    tf = torch.arange(1, 4001, dtype=torch.float32)
    for base in (TQ.BETA1, TQ.BETA2):
        together = TQ._pow(base, tf)
        alone = torch.cat([TQ._pow(base, tf[i:i + 1]) for i in range(4000)])
        assert torch.equal(together, alone)
        np.testing.assert_allclose(together.numpy(),
                                   np.float32(base) ** tf.numpy(), rtol=1e-6,
                                   atol=1e-30)      # subnormal tail


def test_target_syncs_per_slot():
    """Each slot syncs its target network when its own count reaches a
    multiple of TARGET_SYNC, whatever the other slots' counts are."""
    state = _trained_state([1, 2, 3, 4])
    state.t.copy_(torch.tensor([23, 24, 0, 49], dtype=torch.int32))
    target0 = [{k: x.clone() for k, x in l.items()} for l in state.target]
    TQ._bank_train_steps(*state.carry(),
                         *TQ._unpack(torch.from_numpy(_packed(
                             4, 1, np.random.default_rng(6),
                             np.ones((4, 1), bool))), N_FEAT), state.gamma)
    assert state.t.tolist() == [24, 25, 1, 50]
    for lp, lt, l0 in zip(state.params, state.target, target0):
        for k in ("w", "b"):
            for si, synced in enumerate([False, True, False, True]):
                assert torch.equal(lt[k][si],
                                   lp[k][si] if synced else l0[k][si])
                assert synced or not torch.equal(lt[k][si], lp[k][si])


def test_bank_train_steps_match_reference(jax_init):
    """The stacked train steps against the reference's on carried weights:
    the losses (N, m) and every leaf after three ragged rounds at rtol 1e-5
    / atol 1e-6, the update counts equal."""
    ref = RQ.DQNBank(N_FEAT, N_ACT, SEEDS)
    port = TQ.DQNBank(N_FEAT, N_ACT, SEEDS, device="cpu")
    rng = np.random.default_rng(9)
    F = N_FEAT
    for _ in range(3):
        dt = rng.random((len(SEEDS), K)) < 0.7
        P = _packed(len(SEEDS), K, rng, dt)
        losses = TQ._bank_train_steps(*port.state.carry(),
                                      *TQ._unpack(torch.from_numpy(P), F),
                                      port.gamma)
        parts = (P[..., :F], P[..., 2 * F].astype(np.int32),
                 P[..., 2 * F + 1], P[..., F:2 * F], P[..., 2 * F + 2], dt)
        (ref.params, ref.target_params, ref.m, ref.v, ref.t), want = \
            RQ._bank_train_steps(ref.params, ref.target_params, ref.m,
                                 ref.v, ref.t,
                                 *(jnp.asarray(x) for x in parts),
                                 ref.gamma)
        assert losses.shape == (len(SEEDS), K)
        np.testing.assert_allclose(losses.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(port.t, np.asarray(ref.t))
    for r_tree, p_tree in ((ref.params, port.state.params),
                           (ref.target_params, port.state.target),
                           (ref.m, port.state.m), (ref.v, port.state.v)):
        _assert_params_close(r_tree, p_tree, 1e-5, 1e-6)
    assert port.t.min() > 0


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
