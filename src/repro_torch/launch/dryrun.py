"""Multi-pod dry run: the port of ``repro/launch/dryrun.py`` (DESIGN.md
§6/§7).

For every (architecture x input-shape) cell, run the port's own step
(``make_train_step``, ``make_prefill_step`` or ``make_decode_step``) as
one rank of the single-pod 16x16 mesh or the 2x16x16 multi-pod mesh,
proving the distribution config is coherent: specs turn into this rank's
shards, the collectives run, and the per-device memory fits.  Records per
cell: this rank's argument bytes and peak temporaries, its matmul FLOPs,
and its collectives' bytes and groups (``launch.op_analysis``).

Unlike the port's other entry points, this one does not run on the card:
it allocates nothing of the model.  A ``fake`` process group of 256 or
512 ranks stands for the mesh (the counterpart of the reference's 512
fake CPU devices; its collectives return at once) and every param,
optimizer leaf, cache and activation is a fake tensor, built by the
real initializers under ``FakeTensorMode`` (``models.abstract``).  Token
ids are the one exception: they are real zeros of their exact shape on
the host, because the steps' index arithmetic reads them (the
embedding's backward sorts them); their bytes count as the argument
bytes they are.  The group is started for a cell and destroyed after it
(``fake_world``), so nothing outlives the call; nothing happens at import.

Modes (train cells; the others run the same way in every mode):
  fsdp   -- the reference's default and the port's trainer: params and
            AdamW moments laid out by the family's specs (sharded over
            'data' and 'model'); each layer's weights all-gathered over
            'data' where it runs, their grads reduce-scattered
            (``distributed.local.Fsdp``);
  zero1  -- params under ``zero1_specs`` (TP only), AdamW moments sharded
            over 'data' too;
  puredp -- no TP: the mesh's ranks as one 'data' axis, params and moments
            FSDP over every rank (the reference's ``_puredp_specs``), the
            batch over every rank.
The records count each collective (``local.STATS``): under FSDP a layer's
all-gathers (forward, and again where the backward reads a weight) and
its grads' reduce-scatters (all-reduces: gloo has no reduce-scatter).

``memory.temp_bytes`` is the peak of live bytes held by the tensors the
step's ops returned (a dispatch mode counts fake storages as they are
made and freed; the arguments excluded), so outputs count while they live.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
      [--multi-pod | --both-meshes]
  python -m repro_torch.launch.dryrun --all   # every runnable cell, both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCH_IDS, cell_skip_reason, get_config,
                                 runnable_cells)
from repro_torch.distributed import context
from repro_torch.distributed.context import DEFAULT_TRAIN_SPEC
from repro_torch.distributed.sharding import P, spec_map, tp_size
from repro_torch.launch import op_analysis
from repro_torch.models import abstract, family_module
from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell
from repro_torch.models.tree import arrays

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "torch_dryrun"

MODES = ("fsdp", "zero1", "puredp")


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` process group of ``world`` ranks (this process is rank
    0) for the body; destroyed on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is running: the dry run starts "
                           "its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(multi_pod: bool, mode: str = "fsdp"):
    """(the production mesh on the fake group, the mesh the cell runs on):
    the same, or for ``puredp`` its ranks as one ('data', 'model') mesh
    with a model axis of 1."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    if mode != "puredp":
        return mesh, mesh
    n = dist.get_world_size()
    return mesh, DeviceMesh("cpu", torch.arange(n).reshape(n, 1),
                            mesh_dim_names=("data", "model"))


def _puredp_specs(tree):
    """Map TP specs to pure-FSDP: 'model' joins the FSDP ('data') axis on
    the weight dim; nothing is tensor-parallel."""
    def entry(e):
        if e == "model":
            return None
        if e == "data":
            return ("data", "model")
        if isinstance(e, tuple):
            out = [a for a in e if a != "model"]
            if "data" in out:
                out.append("model")
            return tuple(out) if len(out) > 1 else (out[0] if out else None)
        return e

    return spec_map(lambda s: P(*(entry(e) for e in s)), tree)


def batch_ways(batch: int, mesh) -> int:
    """Ranks the batch is split over: the (pod, data) axes whose product
    divides it (the reference's ``_batch_axes_for``)."""
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names)
    prod = 1
    for a in ("pod", "data"):
        if a in names and batch % (prod * mesh.size(names.index(a))) == 0:
            prod *= mesh.size(names.index(a))
    return prod


def inputs(cfg: ModelConfig, shape: ShapeCell, rows: int) -> dict:
    """This rank's rows of every model input: token ids (and labels) as
    real zeros on the host, float inputs as fake tensors."""
    s = shape.seq_len
    mdt = getattr(torch, cfg.dtype)
    ids = lambda n: torch.zeros((rows, n), dtype=torch.int64)
    if cfg.embed_inputs:   # hubert: precomputed frame embeddings (stub)
        d = {"frames": abstract(torch.zeros, (rows, s, cfg.d_model),
                                dtype=mdt)}
    elif cfg.vis_tokens:   # internvl2: patch-embedding prefix (stub)
        d = {"tokens": ids(s - cfg.vis_tokens),
             "patches": abstract(torch.zeros, (rows, cfg.vis_tokens,
                                               cfg.d_model), dtype=mdt)}
    else:
        d = {"tokens": ids(s)}
    if shape.kind == "train":
        d["labels"] = ids(s - cfg.vis_tokens if cfg.vis_tokens else s)
    return d


def build_cell(cfg: ModelConfig, shape: ShapeCell, mesh, *,
               mode: str = "fsdp"):
    """(step, args) on this rank of ``mesh`` (None: one device): fake
    params (the compute view: a train cell's in ``mode``'s layout),
    optimizer state and cache, and this rank's rows of the inputs.
    Serving steps run the plain versions (``impl="torch"``; the
    reference's dry run lowers ``impl="xla"``), the train step the
    trainer's own (``kernels.plain``)."""
    from repro_torch.launch.steps import (make_cache, make_decode_step,
                                          make_prefill_step, make_train_step,
                                          shard_params)
    from repro_torch.optim import AdamW

    mod = family_module(cfg)
    tp = 1 if mesh is None else tp_size(mesh)
    params = abstract(mod.init, cfg, tp=tp, device="cpu")
    train = shape.kind == "train"
    fsdp = train and mode != "zero1"
    pspecs = mod.specs(cfg)
    if train and mode == "puredp":
        pspecs = _puredp_specs(pspecs)
    if mesh is not None:
        params = abstract(shard_params, cfg, params, mesh, specs=pspecs,
                          fsdp=fsdp)
    rows = shape.global_batch // batch_ways(shape.global_batch, mesh)
    batch = inputs(cfg, shape, rows)

    if train:
        opt = AdamW()
        if mesh is not None:
            opt.shard(mesh, pspecs, mod.compute_segments(cfg, tp), fsdp=fsdp)
        opt_state = abstract(opt.init, params)
        return make_train_step(cfg, opt, mesh=mesh), (params, opt_state,
                                                      batch)
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, impl="torch", mesh=mesh),
                (params, batch))
    # decode: one new token against a seq_len-deep cache, each slot at its
    # last row
    cache = abstract(make_cache, cfg, mesh,
                     lambda dev: mod.init_cache(cfg, rows, shape.seq_len, tp,
                                                device=dev),
                     mod.cache_specs(cfg), "cpu")
    toks = torch.zeros((rows, 1), dtype=torch.int64)
    pos = np.full(rows, shape.seq_len - 1, np.int64)
    return (make_decode_step(cfg, impl="torch", mesh=mesh),
            (params, cache, toks, pos))


def _nbytes(x) -> int:
    if isinstance(x, np.ndarray):
        return int(x.nbytes)
    return x.numel() * x.element_size()


class LiveBytes(TorchDispatchMode):
    """Peak of the live bytes held by the tensors the ops return (each
    storage counted once, from its first tensor to its last one's death),
    storages of ``exclude``'s tensors left out."""

    def __init__(self, exclude=()):
        super().__init__()
        self.skip = {t.untyped_storage()._cdata for t in arrays(exclude)
                     if isinstance(t, torch.Tensor)}
        self.live: dict[int, list] = {}
        self.now = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in arrays(out):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.skip:
            return
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [st.nbytes(), 0]
            self.now += entry[0]
            self.peak = max(self.peak, self.now)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.now -= entry[0]
            del self.live[key]


def run_cell(cfg: ModelConfig, shape: ShapeCell, mesh, *,
             mode: str = "fsdp") -> dict:
    """Build and run one cell on ``mesh`` (None: one device, no group);
    returns the record's measured part."""
    t0 = time.perf_counter()
    fn, args = build_cell(cfg, shape, mesh, mode=mode)
    t_build = time.perf_counter() - t0
    spec = DEFAULT_TRAIN_SPEC if mesh is not None else None
    live = LiveBytes(exclude=args)
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    t0 = time.perf_counter()
    with context.activation_spec(spec, mesh), grad, live:
        out, rep = op_analysis.analyze(fn, *args)
    t_trace = time.perf_counter() - t0
    arg_ids = {t.untyped_storage()._cdata for t in arrays(args)
               if isinstance(t, torch.Tensor)}
    outs = [t for t in arrays(out) if isinstance(t, torch.Tensor)]
    alias = sum(_nbytes(t) for t in outs
                if t.untyped_storage()._cdata in arg_ids)
    return {
        "lower_s": round(t_build, 2), "trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": sum(_nbytes(x) for x in arrays(args)),
            "output_bytes": sum(_nbytes(t) for t in outs) - alias,
            "temp_bytes": live.peak,
            "alias_bytes": alias,
        },
        "ops": {
            "dot_flops": rep.dot_flops,
            "collective_bytes": rep.collective_bytes,
            "collective_counts": rep.n_collectives,
            "group_sizes": rep.group_sizes,
            "group_nodes": {k: len({r // _gpus_per_node() for r in ranks})
                            for k, ranks in rep.group_ranks.items()},
            "wire_bytes": rep.wire_bytes(),
            "n_ops": rep.n_ops,
        },
    }


def _gpus_per_node() -> int:
    from repro_torch.launch.roofline import GPUS_PER_NODE
    return GPUS_PER_NODE


def lower_cell(arch: str, shape: str | ShapeCell, *, multi_pod: bool = False,
               single: bool = False, layers: int | None = None,
               variant: str = "", mode: str = "fsdp") -> dict:
    """One cell's record: ``shape`` a ``SHAPES`` name or a
    :class:`ShapeCell`; on the production mesh (a fake group of 256, or
    512 with ``multi_pod``, for the call), or with ``single`` on one
    device with no mesh."""
    if mode not in MODES:
        raise ValueError(f"--mode {mode}: one of {MODES}")
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    world = contextlib.nullcontext() if single else \
        fake_world(512 if multi_pod else 256)
    with world:
        where, mesh = ("single", None) if single else \
            make_mesh(multi_pod, mode)
        got = run_cell(cfg, cell, mesh, mode=mode)
        if mesh is not None:
            from repro_torch.launch.mesh import describe
            where = describe(where)
        n_dev = 1 if mesh is None else mesh.size()
        rows = cell.global_batch // batch_ways(cell.global_batch, mesh)
    return {
        "arch": arch, "shape": cell.name, "mesh": where,
        "n_devices": n_dev, "kind": cell.kind, "mode": mode,
        "n_layers": cfg.n_layers, "variant": variant or "baseline",
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "rows_per_device": rows, **got,
    }


def save_record(record: dict) -> Path:
    ART_DIR.mkdir(parents=True, exist_ok=True)
    tag = (f"{record['arch']}_{record['shape']}_{record['mesh']}"
           + ("" if record["kind"] != "train" or record["mode"] == "fsdp"
              else f"_{record['mode']}")
           + ("" if record["variant"] == "baseline"
              else f"_{record['variant']}"))
    path = ART_DIR / f"{tag}.json"
    path.write_text(json.dumps(record, indent=1))
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every runnable cell on both meshes")
    ap.add_argument("--layers", type=int, default=None,
                    help="override n_layers (roofline extrapolation probes)")
    ap.add_argument("--variant", default="", help="tag for perf experiments")
    ap.add_argument("--mode", default="fsdp", choices=MODES,
                    help="train-cell weight sharding strategy")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, m) for a, s in runnable_cells()
                 for m in (False, True)]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        reason = cell_skip_reason(args.arch, args.shape)
        if reason:
            print(f"SKIP {args.arch} x {args.shape}: {reason}")
            return
        meshes = (False, True) if args.both_meshes else (args.multi_pod,)
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, shape, multi in cells:
        tag = f"{arch} x {shape} x {'2x16x16' if multi else '16x16'}"
        try:
            rec = lower_cell(arch, shape, multi_pod=multi,
                             layers=args.layers, variant=args.variant,
                             mode=args.mode)
            path = save_record(rec)
            m = rec["memory"]
            print(f"OK   {tag}: trace {rec['trace_s']}s  "
                  f"arg {m['argument_bytes']/2**30:.2f}GiB  "
                  f"temp {m['temp_bytes']/2**30:.2f}GiB  "
                  f"dotF {rec['ops']['dot_flops']:.3e}  "
                  f"wire {rec['ops']['wire_bytes']:.3e}B -> {path.name}",
                  flush=True)
        except Exception as e:  # a failure here is a bug in our system
            failures += 1
            print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc(limit=3)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
