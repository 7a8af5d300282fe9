"""DQN revision policy for software DSE (paper §VI-B, Fig. 5(e)).

"We use the DQN algorithm to train a 4-layer fully-connected neural network,
which predicts Q-values.  The DQN is reused for all design points in a
software space."  Written in PyTorch: a 4-layer MLP (He-normal init from a
``torch.Generator`` per seed), a numpy replay buffer, epsilon-greedy action
selection, TD(0) targets with a slow target network, hand-written Adam.
The networks live on the caller's ``device``.

Two drivers, one per-slot code path:

  * :class:`DQN`     — one agent, one software space.  Used by the scalar
    ``engine="reference"`` DSE path.
  * :class:`DQNBank` — N independent agents advanced in lock-step by the
    batched DSE engine (:meth:`DQNBank.select_round`,
    :meth:`DQNBank.train_round`).

Both hold their agents as :class:`_Slot` objects and run every forward and
every train step through the same functions on the same shapes, so a bank
slot is bit-identical to a standalone ``DQN`` by construction (a batched
product over N slots is not guaranteed the bits of N=1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LR, BETA1, BETA2, ADAM_EPS = 1e-3, 0.9, 0.999, 1e-8
TARGET_SYNC = 25   # updates between target-network syncs


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; asking for CUDA where there is no
    card raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for but no CUDA device "
                           "is available; pass device='cpu' to run on the "
                           "CPU")
    return dev


def _init_bank(seeds, sizes, device) -> list[dict[str, torch.Tensor]]:
    """Stacked per-seed MLP init: He-normal weights (std sqrt(2/fan_in)) from
    one ``torch.Generator`` per seed, zero biases; every leaf has a leading
    slot axis of len(seeds)."""
    per_seed = []
    for seed in seeds:
        g = torch.Generator().manual_seed(int(seed))
        per_seed.append([
            {"w": torch.randn(a, b, generator=g) * np.sqrt(2.0 / a),
             "b": torch.zeros(b)}
            for a, b in zip(sizes[:-1], sizes[1:])])
    return [{k: torch.stack([p[li][k] for p in per_seed]).to(device)
             for k in ("w", "b")} for li in range(len(sizes) - 1)]


def params_from_numpy(params, device="cpu") -> list[dict[str, torch.Tensor]]:
    """The reference's parameter tree (a list of ``{"w", "b"}`` arrays,
    stacked along a leading slot axis for a bank) as the port's float32
    tensors on ``device``, same structure and shapes."""
    return [{k: torch.tensor(np.asarray(layer[k]), dtype=torch.float32,
                             device=device)
             for k in ("w", "b")} for layer in params]


def _forward(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for layer in params[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    last = params[-1]
    return h @ last["w"] + last["b"]


def _clone(params):
    return [{k: v.clone() for k, v in layer.items()} for layer in params]


class _Slot:
    """One agent's network state: online and target parameters, Adam
    moments and update count."""

    def __init__(self, params):
        self.params = params
        self.target = _clone(params)
        self.m = [{k: torch.zeros_like(v) for k, v in l.items()}
                  for l in params]
        self.v = [{k: torch.zeros_like(v) for k, v in l.items()}
                  for l in params]
        self.t = 0

    def q_values(self, feats: np.ndarray) -> np.ndarray:
        """Q-values for a state batch (B, F) -> (B, A)."""
        dev = self.params[0]["w"].device
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
            return _forward(self.params, x).cpu().numpy()

    def train_step(self, s, a, r, s2, done, gamma: float) -> torch.Tensor:
        """One TD(0) update from a pre-drawn minibatch: loss and gradients
        from one pass, Adam, target sync every TARGET_SYNC updates.
        Returns the pre-update loss as a 0-d tensor on the slot's device
        (reading it is the caller's choice: on a card it waits for the
        device)."""
        dev = self.params[0]["w"].device
        s, r, s2, done = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                          for x in (s, r, s2, done))
        a = torch.as_tensor(a, dtype=torch.int64, device=dev)
        leaves = [v.requires_grad_() for l in self.params for v in l.values()]
        q_sa = _forward(self.params, s).gather(1, a[:, None])[:, 0]
        with torch.no_grad():
            q_next = _forward(self.target, s2).max(dim=1).values
            target = r + gamma * q_next * (1.0 - done)
        loss = ((q_sa - target) ** 2).mean()
        grads = torch.autograd.grad(loss, leaves)
        self.t += 1
        # bias corrections in float32, as the reference computes them
        tf = torch.tensor(float(self.t), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(BETA1, dtype=torch.float32) ** tf)
        bc2 = float(1 - torch.tensor(BETA2, dtype=torch.float32) ** tf)
        with torch.no_grad():
            gi = iter(grads)
            for lp, lm, lv in zip(self.params, self.m, self.v):
                for k in lp:
                    g = next(gi)
                    lm[k] = BETA1 * lm[k] + (1 - BETA1) * g
                    lv[k] = BETA2 * lv[k] + (1 - BETA2) * g * g
                    mh, vh = lm[k] / bc1, lv[k] / bc2
                    lp[k] = lp[k].detach() - LR * mh / (torch.sqrt(vh)
                                                        + ADAM_EPS)
            if self.t % TARGET_SYNC == 0:
                self.target = _clone(self.params)
        return loss.detach()


@dataclass
class Replay:
    capacity: int
    s: np.ndarray = None
    a: np.ndarray = None
    r: np.ndarray = None
    s2: np.ndarray = None
    done: np.ndarray = None
    n: int = 0
    ptr: int = 0

    def add(self, s, a, r, s2, done):
        if self.s is None:
            d = len(s)
            self.s = np.zeros((self.capacity, d), np.float32)
            self.s2 = np.zeros((self.capacity, d), np.float32)
            self.a = np.zeros(self.capacity, np.int32)
            self.r = np.zeros(self.capacity, np.float32)
            self.done = np.zeros(self.capacity, np.float32)
        i = self.ptr
        self.s[i], self.a[i], self.r[i], self.s2[i], self.done[i] = \
            s, a, r, s2, float(done)
        self.ptr = (i + 1) % self.capacity
        self.n = min(self.n + 1, self.capacity)

    def sample(self, rng: np.random.Generator, batch: int):
        idx = rng.integers(0, self.n, size=batch)
        return (self.s[idx], self.a[idx], self.r[idx], self.s2[idx],
                self.done[idx])


def _unstack(stacked, i: int):
    return [{k: v[i].clone() for k, v in layer.items()} for layer in stacked]


class DQN:
    """4-layer MLP Q-network with target network and replay."""

    def __init__(self, n_features: int, n_actions: int, hidden: int = 64,
                 gamma: float = 0.9, seed: int = 0, buffer: int = 4096,
                 device="cuda"):
        sizes = (n_features, hidden, hidden, hidden, n_actions)
        # a 1-slot bank's init: the same weights DQNBank gives this seed
        self.slot = _Slot(_unstack(
            _init_bank([seed], sizes, resolve_device(device)), 0))
        self.gamma = gamma
        self.n_actions = n_actions
        self.replay = Replay(buffer)
        self.rng = np.random.default_rng(seed)
        self.eps = 1.0
        self.eps_min = 0.05
        self.eps_decay = 0.97

    @property
    def params(self):
        return self.slot.params

    @property
    def t(self) -> int:
        return self.slot.t

    def q_values(self, feat: np.ndarray) -> np.ndarray:
        return self.slot.q_values(np.asarray(feat)[None, :])[0]

    def q_values_batch(self, feats: np.ndarray) -> np.ndarray:
        """Q-values for a whole state batch, one network forward: (B, A)."""
        return self.slot.q_values(feats)

    def select(self, feat: np.ndarray) -> int:
        """Epsilon-greedy revision choice (the paper applies the highest-Q
        revision to the candidate)."""
        if self.rng.random() < self.eps:
            return int(self.rng.integers(self.n_actions))
        return int(np.argmax(self.q_values(feat)))

    def select_batch(self, feats: np.ndarray) -> np.ndarray:
        """Epsilon-greedy actions for the entire candidate frontier in one
        call: a single forward pass scores every state, then per-state
        exploration noise is applied (int array of shape (B,))."""
        feats = np.asarray(feats, np.float32)
        greedy = np.argmax(self.q_values_batch(feats), axis=1)
        explore = self.rng.random(len(feats)) < self.eps
        random_a = self.rng.integers(self.n_actions, size=len(feats))
        return np.where(explore, random_a, greedy).astype(int)

    def record(self, s, a, r, s2, done=False):
        self.replay.add(np.asarray(s, np.float32), a, r,
                        np.asarray(s2, np.float32), done)

    def train_step(self, batch: int = 32):
        """One TD(0) update; returns the minibatch loss (pre-update), or
        None while the replay holds fewer than ``batch`` transitions."""
        if self.replay.n < batch:
            return None
        loss = self.slot.train_step(*self.replay.sample(self.rng, batch),
                                    self.gamma)
        self.eps = max(self.eps_min, self.eps * self.eps_decay)
        return float(loss)


class DQNBank:
    """N independent per-search DQNs advanced in lock-step.

    Each slot replicates a standalone ``DQN(n_features, n_actions, seed=s)``
    bit-for-bit: same init, same numpy action/sample RNG stream, same
    epsilon schedule, same Adam/target cadence, and the same per-slot
    forward and train step on the same shapes.
    """

    def __init__(self, n_features: int, n_actions: int, seeds: list[int],
                 hidden: int = 64, gamma: float = 0.9, buffer: int = 4096,
                 batch: int = 32, device="cuda"):
        sizes = (n_features, hidden, hidden, hidden, n_actions)
        stacked = _init_bank(seeds, sizes, resolve_device(device))
        N = len(seeds)
        self.slots = [_Slot(_unstack(stacked, i)) for i in range(N)]
        self.n_searches = N
        self.n_actions = n_actions
        self.gamma = gamma
        self.batch = batch
        self.replays = [Replay(buffer) for _ in seeds]
        self.rngs = [np.random.default_rng(s) for s in seeds]
        self.eps = np.full(N, 1.0)
        self.eps_min = 0.05
        self.eps_decay = 0.97

    @property
    def params(self):
        """Every slot's parameters stacked along a leading slot axis (the
        layout of the reference's bank)."""
        return [{k: torch.stack([s.params[li][k] for s in self.slots])
                 for k in ("w", "b")}
                for li in range(len(self.slots[0].params))]

    @property
    def t(self) -> np.ndarray:
        return np.array([s.t for s in self.slots], np.int32)

    def select_round(self, feats: np.ndarray,
                     counts: list[int] | None = None) -> np.ndarray:
        """Epsilon-greedy actions for all N frontiers (int (N, k)); per-search
        exploration noise drawn from that search's own RNG in the same order
        a standalone ``DQN.select_batch`` would.

        ``counts`` marks how many leading rows of each search's frontier are
        real (ragged feasible-only frontiers arrive zero-padded to k): only
        those are scored and consume RNG draws, exactly as the reference
        twin's ``select_batch`` on m states; the padded tail comes back
        zeroed."""
        feats = np.asarray(feats, np.float32)
        N, k = feats.shape[:2]
        acts = np.zeros((N, k), dtype=int)
        for s in range(N):
            m = k if counts is None else counts[s]
            if not m:
                continue
            greedy = np.argmax(self.slots[s].q_values(feats[s, :m]), axis=1)
            explore = self.rngs[s].random(m) < self.eps[s]
            random_a = self.rngs[s].integers(self.n_actions, size=m)
            acts[s, :m] = np.where(explore, random_a, greedy)
        return acts

    def train_round(self, s: np.ndarray, a: np.ndarray, r: np.ndarray,
                    s2: np.ndarray, done: np.ndarray | None = None,
                    counts: list[int] | None = None) -> None:
        """Record + learn a whole round of transitions: (N, k, F) states,
        (N, k) actions/rewards.  Per search, each real transition is
        recorded and, once the replay is warm, followed by one train step
        on a freshly drawn minibatch — the reference per-transition loop.
        ``counts`` bounds how many leading transitions per search are real."""
        N, k = a.shape
        if done is None:
            done = np.zeros((N, k), np.float32)
        for si in range(N):
            rep, rng, slot = self.replays[si], self.rngs[si], self.slots[si]
            for j in range(k if counts is None else counts[si]):
                rep.add(np.asarray(s[si, j], np.float32), a[si, j], r[si, j],
                        np.asarray(s2[si, j], np.float32), done[si, j])
                if rep.n >= self.batch:
                    slot.train_step(*rep.sample(rng, self.batch), self.gamma)
                    self.eps[si] = max(self.eps_min,
                                       self.eps[si] * self.eps_decay)
