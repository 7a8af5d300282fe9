"""DQN revision policy for software DSE (paper §VI-B, Fig. 5(e)).

"We use the DQN algorithm to train a 4-layer fully-connected neural network,
which predicts Q-values.  The DQN is reused for all design points in a
software space."  Written in PyTorch: a 4-layer MLP (He-normal init from a
``torch.Generator`` per seed), a numpy replay buffer, epsilon-greedy action
selection, TD(0) targets with a slow target network, hand-written Adam.
The networks live on the caller's ``device``.

Two drivers share one program (DESIGN.md §10):

  * :class:`DQNBank` — N independent agents advanced in lock-step by the
    batched DSE engine: parameters are stacked along a leading search axis,
    action selection is one batched forward over every search's frontier
    (:func:`_bank_forward`), and a round's train steps, padded to k steps,
    run as one call of :func:`_bank_train_steps` over all N searches.  On a
    card the forward and that call are each one CUDA graph replay, captured
    once per configuration and shape on one static state that a bank (or a
    standalone DQN) holds until another takes it over; on the CPU they run
    eagerly.
  * :class:`DQN`     — one agent, one software space, used by the scalar
    ``engine="reference"`` DSE path: the N=1 instance of the bank's forward
    and the N=1, m=1 instance of its train steps.

Each slot replicates the exact update cadence and RNG stream of a standalone
:class:`DQN`, and every product and row sum of the program goes through
:func:`repro_torch.kernels.bank_mm` (the hand-written kernel on the card,
full float32 FMA; ``torch.bmm`` on the CPU), whose result for one slot does
not depend on how many slots share the call (on the card, PyTorch's batched
products and sums give no such promise).  So a bank slot is bit-identical
to a standalone ``DQN``: the tests hold this on the CPU, ``chip_smoke.py``
on the card.
"""
from __future__ import annotations

import math
import weakref
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels.bank_mm import bank_mm

LR, BETA1, BETA2, ADAM_EPS = 1e-3, 0.9, 0.999, 1e-8
TARGET_SYNC = 25   # updates between target-network syncs
POW_ROW = 64       # see _pow


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


def _bank_forward(params, x: torch.Tensor) -> torch.Tensor:
    """Every slot's MLP on its own rows: x (N, k, F) -> (N, k, A), one
    ``bank_mm`` a layer."""
    h = x
    for layer in params[:-1]:
        h = bank_mm(h, layer["w"], layer["b"], relu=True)
    last = params[-1]
    return bank_mm(h, last["w"], last["b"])


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """sum_i x[n, i, j] -> (N, P), as ``bank_mm`` of a row of ones (a
    broadcast: no copy), so it too keeps a slot's bits whatever N."""
    ones = x.new_ones(()).expand(x.shape[0], 1, x.shape[1])
    return bank_mm(ones, x)[:, 0]


def _pow(base: float, tf: torch.Tensor) -> torch.Tensor:
    """``base ** tf`` in float32 for tf (N,).  Each slot's power is read
    from a row of POW_ROW copies: PyTorch's CPU ``pow`` rounds its
    vectorised body and its scalar tail differently, and a row that long
    puts every element in the body whatever N is, so a slot's bias
    correction does not depend on N."""
    return torch.pow(base, tf[:, None].expand(-1, POW_ROW).contiguous())[:, 0]


def _bank_step(gamma, carry, inp) -> torch.Tensor:
    """One TD(0) train step of every slot at once, in place on ``carry``
    (params, target, m, v, t); returns the pre-update losses (N,).

    The loss and its gradients come from one forward and a hand-written
    backward of the 4-layer MLP (products for the weights' and inputs'
    gradients, a row sum for the biases', the ReLU masks), every product
    and sum a ``bank_mm``, then Adam with float32 bias corrections from the
    stepped ``t``, then the slow target sync every TARGET_SYNC updates.
    ``do_train`` (N,) masks the whole update (padding of ragged rounds).
    Device tensors only: no value is read back, so the step can be
    captured in a CUDA graph."""
    params, target, m, v, t = carry
    s, a, r, s2, done, do_train = inp

    hs = [s]
    for layer in params[:-1]:
        hs.append(bank_mm(hs[-1], layer["w"], layer["b"], relu=True))
    q = bank_mm(hs[-1], params[-1]["w"], params[-1]["b"])
    q_sa = q.gather(2, a[..., None])[..., 0]
    q_next = _bank_forward(target, s2).amax(dim=2)
    diff = q_sa - (r + gamma * q_next * (1.0 - done))
    batch = s.shape[1]
    loss = _row_sum((diff * diff)[..., None])[:, 0] / batch

    # d loss / d q: 2 (q_sa - target) / batch at the taken action
    g = torch.zeros_like(q).scatter_(2, a[..., None],
                                     (2.0 / batch * diff)[..., None])
    grads = [None] * len(params)
    for li in reversed(range(len(params))):
        grads[li] = {"w": bank_mm(hs[li].transpose(1, 2), g),
                     "b": _row_sum(g)}
        if li:          # through the ReLU: h > 0 exactly where z > 0
            g = bank_mm(g, params[li]["w"].transpose(1, 2))
            g = torch.where(hs[li] > 0, g, 0.0)

    t2 = t + do_train.to(torch.int32)
    tf = t2.to(torch.float32)
    bc1, bc2 = 1 - _pow(BETA1, tf), 1 - _pow(BETA2, tf)
    sync = do_train & (t2 % TARGET_SYNC == 0)
    for lp, lg, lm, lv, lt in zip(params, grads, m, v, target):
        for k in ("w", "b"):
            view = (-1,) + (1,) * (lp[k].dim() - 1)
            gk = lg[k]
            m2 = BETA1 * lm[k] + (1 - BETA1) * gk
            v2 = BETA2 * lv[k] + (1 - BETA2) * gk * gk
            mh, vh = m2 / bc1.view(view), v2 / bc2.view(view)
            p2 = lp[k] - LR * mh / (torch.sqrt(vh) + ADAM_EPS)
            keep = do_train.view(view)
            lp[k].copy_(torch.where(keep, p2, lp[k]))
            lm[k].copy_(torch.where(keep, m2, lm[k]))
            lv[k].copy_(torch.where(keep, v2, lv[k]))
            lt[k].copy_(torch.where(sync.view(view), lp[k], lt[k]))
    t.copy_(t2)
    return loss


def _bank_train_steps(params, target, m, v, t, S, A, R, S2, D, DT,
                      gamma) -> torch.Tensor:
    """A whole round's training work: each slot's (up to) m sequential
    train steps, all N slots at once, in place on (params, target, m, v,
    t).  S, S2 (N, m, batch, F); A (N, m, batch) int64; R, D (N, m,
    batch); DT (N, m) bool.  Returns the per-step losses (N, m)."""
    carry = (params, target, m, v, t)
    with torch.no_grad():
        losses = [_bank_step(gamma, carry, (S[:, i], A[:, i], R[:, i],
                                            S2[:, i], D[:, i], DT[:, i]))
                  for i in range(S.shape[1])]
    return torch.stack(losses, dim=1)


def _unpack(P: torch.Tensor, n_feat: int) -> tuple:
    """A round's minibatches on the device, (N, m, batch, 2F + 4) float32
    rows in ``Replay``'s layout (s, s2, a, r, done, do_train; steps past a
    search's draws all zero), as _bank_train_steps' S, A, R, S2, D, DT."""
    F = n_feat
    return (P[..., :F], P[..., 2 * F].long(), P[..., 2 * F + 1],
            P[..., F:2 * F], P[..., 2 * F + 2], P[:, :, 0, 2 * F + 3] > 0)


class _State:
    """N agents' network state as stacked float32 leaves with a leading
    slot axis (the reference's bank layout): online and target parameters,
    Adam's ``m`` and ``v`` (all views of one buffer ``flat``, so the whole
    state copies in one call) and the update counts ``t`` (N,) int32, on
    one device and updated in place.  ``shapes`` holds each layer's (w, b)
    shapes; a new state is all zeros.

    Where ``graph`` (the card's default) the forward and the train steps
    replay CUDA graphs of this configuration's :class:`_Capture`; while
    this state holds the capture, its leaves are the capture's buffers, so
    a replay reads and writes them in place.  Read the leaves through the
    attributes at the time of use: they move when the capture changes
    hands."""

    def __init__(self, shapes, gamma: float, device):
        self.shapes = tuple((tuple(w), tuple(b)) for w, b in shapes)
        self.device = torch.device(device)
        sizes = [math.prod(x) for layer in self.shapes for x in layer]
        flat = torch.zeros(4, sum(sizes), device=self.device)
        t = torch.zeros(self.shapes[0][0][0], dtype=torch.int32,
                        device=self.device)
        self._own = (flat, t, tuple(self._views(flat[i]) for i in range(4)))
        self._bind(*self._own)
        self.gamma = gamma
        self.n_feat = self.shapes[0][0][1]
        self.graph = self.device.type == "cuda"

    def _views(self, row: torch.Tensor) -> list[dict[str, torch.Tensor]]:
        out, off = [], 0
        for layer in self.shapes:
            views = {}
            for key, shape in zip(("w", "b"), layer):
                views[key] = row[off:off + math.prod(shape)].view(shape)
                off += math.prod(shape)
            out.append(views)
        return out

    def _bind(self, flat: torch.Tensor, t: torch.Tensor, trees) -> None:
        self.flat, self.t = flat, t
        self.params, self.target, self.m, self.v = trees

    @classmethod
    def of(cls, params, gamma: float) -> "_State":
        """A fresh state holding ``params`` (online and target)."""
        state = cls([(layer["w"].shape, layer["b"].shape)
                     for layer in params], gamma, params[0]["w"].device)
        for tree in (state.params, state.target):
            for dst, src in zip(tree, params):
                for key in ("w", "b"):
                    dst[key].copy_(src[key])
        return state

    def carry(self) -> tuple:
        return self.params, self.target, self.m, self.v, self.t

    def _hold(self) -> "_Capture":
        """This configuration's capture, holding this state.  The contents
        move only when the capture changes hands: the state that held it
        gets its own buffers back with what the capture holds, then this
        state's contents go in and its leaves become the capture's."""
        key = (self.device, self.shapes, self.gamma)
        cap = _CAPTURES.get(key)
        if cap is None:
            cap = _CAPTURES[key] = _Capture(_State(*key[1:], self.device))
        prev = cap.holder()
        if prev is self:
            return cap
        if prev is not None:
            flat, t, _ = prev._own
            flat.copy_(cap.state.flat)
            t.copy_(cap.state.t)
            prev._bind(*prev._own)
        cap.state.flat.copy_(self.flat)
        cap.state.t.copy_(self.t)
        self._bind(*cap.state._own)
        cap.holder = weakref.ref(self)
        return cap

    def forward(self, feats: np.ndarray) -> np.ndarray:
        """Q-values (N, k, A) for states (N, k, F): one upload, one
        forward (a graph replay where ``graph``), one read-back."""
        return self.forward_async(feats)()

    def forward_async(self, feats: np.ndarray) -> Callable[[], np.ndarray]:
        """``forward`` in two halves: this call queues it; the function it
        returns waits for the Q-values and returns them.  Where ``graph``,
        the upload and the read-back go through pinned buffers without a
        sync, so the host runs on while the card works through what was
        queued before.  Call that function before any other forward of
        this configuration and shape: those share its buffers, and it
        raises if one ran in between."""
        x = np.ascontiguousarray(feats, np.float32)
        if not self.graph:
            with torch.no_grad():
                q = _bank_forward(self.params, torch.from_numpy(x).to(
                    self.device)).cpu().numpy()
            return lambda: q
        g = self._hold().replay("forward", x)
        g.host_out.copy_(g.out, non_blocking=True)
        g.done.record()
        call = g.calls

        def wait() -> np.ndarray:
            if g.calls != call:
                raise RuntimeError("another forward of this configuration "
                                   "and shape replaced these Q-values")
            g.done.synchronize()
            return g.host_out.numpy().copy()
        return wait

    def train(self, packed: np.ndarray) -> torch.Tensor:
        """A round's minibatches (``_unpack``'s layout) through
        _bank_train_steps: one graph replay where ``graph``, else eagerly.
        Returns the losses (N, m) on the device, unread."""
        if not self.graph:
            return _bank_train_steps(
                *self.carry(), *_unpack(torch.from_numpy(packed).to(
                    self.device), self.n_feat), self.gamma)
        g = self._hold().replay("train", packed)
        g.done.record()
        return g.out.clone()


class _Capture:
    """One configuration's CUDA graphs: the forward by input shape and a
    round's train steps by round shape, all captured on one static state
    (``state``), and a weak reference to the ``_State`` whose contents
    that static state holds (the reference's one jit compile per engine
    configuration).  A process's banks and standalone DQNs of one
    configuration take turns on it: not for use from several threads at
    once."""

    def __init__(self, state: _State):
        self.state = state
        self.graphs: dict[tuple, _Graph] = {}
        self.holder = lambda: None

    def replay(self, kind: str, x: np.ndarray) -> "_Graph":
        """Upload ``x`` through the pinned buffer into the static input of
        the ``kind`` graph of its shape (captured at first use) and replay
        it; returns the graph, its output not yet read."""
        g = self.graphs.get((kind, x.shape))
        if g is None:
            g = self.graphs[(kind, x.shape)] = self._record(kind, x.shape)
        g.done.synchronize()            # the last call's copies have landed
        g.host_in.numpy()[...] = x
        g.inp.copy_(g.host_in, non_blocking=True)   # the call's one upload
        g.graph.replay()
        g.calls += 1
        kernels.bank_mm.launches += g.launches
        return g

    def _program(self, kind: str, state: _State, inp: torch.Tensor):
        with torch.no_grad():
            if kind == "forward":
                return _bank_forward(state.params, inp)
            return _bank_train_steps(*state.carry(),
                                     *_unpack(inp, state.n_feat), state.gamma)

    def _record(self, kind: str, shape: tuple) -> "_Graph":
        """A CUDA graph of the ``kind`` program on the static state and a
        static input of ``shape``, after one eager run on a scratch state
        on a side stream that loads every kernel first (the static state
        may hold a live state's contents: a warm-up there would train it).
        A capture launches nothing: the ``bank_mm`` calls it records are
        taken off the kernel's count and added back at each replay."""
        st = self.state
        inp = torch.zeros(shape, dtype=torch.float32, device=st.device)
        with torch.cuda.device(st.device):
            main, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._program(kind, _State(st.shapes, st.gamma, st.device),
                              torch.zeros_like(inp))
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = kernels.bank_mm.launches
            with torch.cuda.graph(graph):
                out = self._program(kind, st, inp)
            held = kernels.bank_mm.launches - before
            kernels.bank_mm.launches = before
        pinned = lambda t: torch.empty(  # noqa: E731
            t.shape, dtype=t.dtype, pin_memory=True)
        return _Graph(inp, graph, out, held, pinned(inp),
                      pinned(out) if kind == "forward" else None,
                      torch.cuda.Event())


@dataclass
class _Graph:
    """One captured program: the static input it reads, its static output
    (Q-values (N, k, A) or losses (N, m)), the ``bank_mm`` launches a
    replay makes, the pinned host buffers its input (and the forward's
    output) pass through, an event recorded after a call's copies, and
    the number of replays so far."""

    inp: torch.Tensor
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor
    launches: int
    host_in: torch.Tensor
    host_out: torch.Tensor | None
    done: torch.cuda.Event
    calls: int = 0


# every configuration's capture by (device, leaf shapes, gamma)
_CAPTURES: dict[tuple, _Capture] = {}


@dataclass
class Replay:
    """A ring of transitions, each one float32 row in ``_unpack``'s layout
    (s, s2, a, r, done, 1), so a minibatch is one gather."""

    capacity: int
    rows: np.ndarray = None
    n: int = 0
    ptr: int = 0

    def add(self, s, a, r, s2, done):
        F = len(s)
        if self.rows is None:
            self.rows = np.zeros((self.capacity, 2 * F + 4), np.float32)
        row = self.rows[self.ptr]
        row[:F], row[F:2 * F] = s, s2
        row[2 * F], row[2 * F + 1], row[2 * F + 2] = a, r, float(done)
        row[2 * F + 3] = 1.0
        self.ptr = (self.ptr + 1) % self.capacity
        self.n = min(self.n + 1, self.capacity)

    def draw(self, rng: np.random.Generator, batch: int,
             out: np.ndarray) -> None:
        """``batch`` rows drawn uniformly from those it holds into ``out``
        (batch, 2F + 4): one ``rng.integers`` call, one gather."""
        idx = rng.integers(0, self.n, size=batch)
        np.take(self.rows, idx, axis=0, out=out)

    @property
    def s(self) -> np.ndarray:
        """The states column of every row."""
        return self.rows[:, :(self.rows.shape[1] - 4) // 2]


class DQN:
    """4-layer MLP Q-network with target network and replay: the 1-slot
    bank."""

    def __init__(self, n_features: int, n_actions: int, hidden: int = 64,
                 gamma: float = 0.9, seed: int = 0, buffer: int = 4096,
                 device="cuda"):
        sizes = (n_features, hidden, hidden, hidden, n_actions)
        # a 1-slot bank's init: the same weights DQNBank gives this seed
        self.state = _State.of(_init_bank([seed], sizes,
                                          resolve_device(device)), gamma)
        self.gamma = gamma
        self.n_actions = n_actions
        self.replay = Replay(buffer)
        self.rng = np.random.default_rng(seed)
        self.eps = 1.0
        self.eps_min = 0.05
        self.eps_decay = 0.97

    @property
    def params(self):
        """The parameters without the slot axis (views of the 1-slot
        state)."""
        return [{k: x[0] for k, x in l.items()} for l in self.state.params]

    @property
    def t(self) -> int:
        return int(self.state.t[0])

    def q_values(self, feat: np.ndarray) -> np.ndarray:
        return self.q_values_batch(np.asarray(feat)[None, :])[0]

    def q_values_batch(self, feats: np.ndarray) -> np.ndarray:
        """Q-values for a whole state batch, one network forward: (B, A).
        The 1-slot bank's forward, so both engines see the same
        Q-values."""
        return self.state.forward(np.asarray(feats, np.float32)[None])[0]

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
        None while the replay holds fewer than ``batch`` transitions.  The
        N=1, m=1 instance of the round ``DQNBank`` runs, so reference and
        lock-step weight trajectories are bit-identical."""
        if self.replay.n < batch:
            return None
        packed = np.empty((1, 1, batch, self.replay.rows.shape[1]),
                          np.float32)
        self.replay.draw(self.rng, batch, packed[0, 0])
        loss = self.state.train(packed)
        self.eps = max(self.eps_min, self.eps * self.eps_decay)
        return float(loss[0, 0])


class DQNBank:
    """N independent per-search DQNs advanced in lock-step.

    Each slot replicates a standalone ``DQN(n_features, n_actions, seed=s)``
    bit-for-bit: same init, same numpy action/sample RNG stream, same
    epsilon schedule, same Adam/target cadence.  What changes is the
    execution shape: parameters are stacked along a leading search axis so
    one batched forward scores every search's frontier
    (:meth:`select_round`) and one call of the stacked train steps applies
    every search's round of replay inserts + train steps
    (:meth:`train_round`).
    """

    def __init__(self, n_features: int, n_actions: int, seeds: list[int],
                 hidden: int = 64, gamma: float = 0.9, buffer: int = 4096,
                 batch: int = 32, device="cuda"):
        sizes = (n_features, hidden, hidden, hidden, n_actions)
        self.state = _State.of(_init_bank(seeds, sizes,
                                          resolve_device(device)), gamma)
        N = len(seeds)
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
        return self.state.params

    @property
    def t(self) -> np.ndarray:
        return self.state.t.cpu().numpy()

    def q_values_round(self, feats: np.ndarray) -> np.ndarray:
        """Q-values for every search's frontier, one batched forward:
        feats (N, k, F) -> (N, k, A)."""
        return self.state.forward(feats)

    def select_round(self, feats: np.ndarray,
                     counts: list[int] | None = None) -> np.ndarray:
        """Epsilon-greedy actions for all N frontiers in one network pass;
        per-search exploration noise drawn from that search's own RNG in the
        same order a standalone ``DQN.select_batch`` would (int (N, k)).

        ``counts`` marks how many leading rows of each search's frontier are
        real (ragged feasible-only frontiers arrive zero-padded to k): only
        those consume RNG draws, exactly as the reference twin's
        ``select_batch`` on m states, and the padded tail comes back
        zeroed."""
        return self.select_round_async(feats, counts)()

    def select_round_async(self, feats: np.ndarray,
                           counts: list[int] | None = None
                           ) -> Callable[[], np.ndarray]:
        """``select_round`` in two halves: this call queues the forward
        and makes every search's exploration draws; the function it
        returns reads the Q-values back and returns the actions.  Draws
        that follow the selection in each search's RNG stream can be made
        in between, while the card computes."""
        pending = self.state.forward_async(feats)
        N, k = feats.shape[:2]
        noise = []
        for s in range(N):
            m = k if counts is None else counts[s]
            noise.append((self.rngs[s].random(m) < self.eps[s],
                          self.rngs[s].integers(self.n_actions, size=m))
                         if m else None)

        def actions() -> np.ndarray:
            greedy = np.argmax(pending(), axis=2)
            acts = np.zeros((N, k), dtype=int)
            for s, drawn in enumerate(noise):
                if drawn is not None:
                    explore, random_a = drawn
                    m = len(explore)
                    acts[s, :m] = np.where(explore, random_a, greedy[s, :m])
            return acts
        return actions

    def train_round(self, s: np.ndarray, a: np.ndarray, r: np.ndarray,
                    s2: np.ndarray, done: np.ndarray | None = None,
                    counts: list[int] | None = None) -> None:
        """Record + learn a whole round of transitions: (N, k, F) states,
        (N, k) actions/rewards.  Replay inserts and minibatch draws run
        host-side per search (identical ``Replay`` semantics and RNG stream
        to the reference per-transition loop); every search's sequential
        train steps then run as ONE call of the stacked train steps (one
        CUDA graph replay on a card).  Rounds where no replay is warm
        enough launch nothing at all.  ``counts`` bounds how many leading
        transitions per search are real (ragged feasible-only frontiers
        zero-pad to k); only those are recorded."""
        N, k = a.shape
        if done is None:
            done = np.zeros((N, k), np.float32)
        # the round's minibatches, steps padded to k (the per-round
        # maximum) so one graph serves the warm-up round and steady state
        # alike: one capture per round shape instead of one per replay fill
        # level; steps past a search's draws stay zero (do_train false)
        packed = np.zeros((N, k, self.batch, 2 * s.shape[-1] + 4),
                          np.float32)
        warm = False
        for si in range(N):
            rep, rng = self.replays[si], self.rngs[si]
            step = 0
            for j in range(k if counts is None else counts[si]):
                rep.add(s[si, j], a[si, j], r[si, j], s2[si, j], done[si, j])
                if rep.n >= self.batch:
                    rep.draw(rng, self.batch, packed[si, step])
                    step += 1
                    self.eps[si] = max(self.eps_min,
                                       self.eps[si] * self.eps_decay)
            warm |= step > 0
        if warm:
            self.state.train(packed)
