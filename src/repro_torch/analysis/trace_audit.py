"""Hot-path auditor: the port's counterpart of
``repro/analysis/jaxpr_audit.py`` (DESIGN.md §16.3).

The reference traces a jitted step to a jaxpr and reads it.  The port runs
eager PyTorch, so it watches the program run and traces it with
``make_fx`` and ``torch.compile``, looking for the failure modes that cost
serving throughput without ever raising an exception.  The reference's
rules map one for one (:data:`REFERENCE_RULES`):

  * ``trace/host-sync`` (``jaxpr/host-callback``): the program reads a
    device tensor's value on the host -- a copy to the host (``.cpu()``,
    ``.item()``, ``int()``, ``.tolist()``, ``.numpy()``), an op whose
    output shape depends on the data (``nonzero``, ``masked_select``, a
    boolean-mask index, ``unique*``, ``bincount``, a ``repeat_interleave``
    with no output size) -- or copies host data to the device with a
    blocking copy (``torch.as_tensor(..., device=)``, ``.to(device)``
    without ``non_blocking``, a host index tensor on a device tensor).  On
    the card each one waits for the work queued there.  A
    ``TorchFunctionMode`` follows where every tensor lives: the program's
    tensor arguments and what is computed from them are device tensors,
    and so are tensors made with the program's device named (``device=``);
    everything else is host data.  Index arithmetic on host tensors is the
    engine's design (``models/layers.py::_positions_host``) and is not
    flagged.  Each finding names the source line, as
    :func:`reported_syncs` names the line of a sync the card reports;
  * ``trace/state-dependent-trace`` (``jaxpr/state-dependent-trace``):
    ``make_fx`` traces the program at two same-shaped engine states and the
    graph code differs: host state is captured instead of flowing as an
    argument.  Host data passed *as* an argument (the engine's numpy
    positions and row maps) enters the graph as constants with the same
    code at every tick, so it is not flagged here;
  * ``trace/recompile`` (``jaxpr/recompile``): the program under
    ``torch.compile(backend="eager")`` over three same-shaped ticks: dynamo
    may not compile a frame again after the first.  Graph breaks are
    reported as ``trace/graph-break`` (info; eager code runs them whole);
  * ``trace/python-scalar-arg`` (``jaxpr/weak-type-arg``): a Python
    ``int``/``float``/``bool`` among the arguments: ``torch.compile``
    guards on its value and a CUDA graph cannot take it as an input;
  * ``trace/scalar-capture`` and ``trace/large-const-capture``: a 0-dim
    or a > 1 MiB tensor that an op of the program reads and that is
    neither an argument nor made by the program (a closure's tensor, or
    host data turned into a tensor without an op: what ``make_fx`` would
    bake into its graph as a constant);
  * ``trace/out-of-place-update`` (``jaxpr/missed-donation``): an output of
    64 KiB or more whose shape and dtype match an input the program did not
    update in place (two live copies where one would do);
  * ``trace/no-introspection`` (``jaxpr/no-cache-introspection``): dynamo
    is unavailable, so the recompile check is skipped.

The kernels' wrappers call ``csrc`` through ``ctypes``
(``kernels/cuda_lib.py``): no function mode, ``make_fx`` or dynamo sees
inside a kernel, only the tensors its wrapper makes.  So the CPU audit
runs the plain versions (``impl="torch"``), and on the card
:func:`reported_syncs` checks ``trace/host-sync`` by the syncs the card
itself reports (``torch.cuda.set_sync_debug_mode``).

``audit_hot_paths`` bundles the shipped train step, dense decode,
prefill, slot write and paged decode for one model config (a reduced one:
each program runs), as the reference's does.  It runs them on the card
unless the caller asks for the CPU, where it adds the syncs the card
reports to the watch's findings.
"""
from __future__ import annotations

import dataclasses
import os
import re
import sys
import warnings

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.tree import arrays

from .findings import Finding, rule

R_HOST_SYNC = rule(
    "trace/host-sync",
    "a hot path reads a device tensor's value on the host (a copy to the "
    "host, a scalar read, a data-dependent output shape) or copies host "
    "data to the device with a blocking copy: every invocation waits for "
    "the card")
R_STATE_TRACE = rule(
    "trace/state-dependent-trace",
    "program traced (make_fx) at two same-shaped engine states produced "
    "different graph code: host state (e.g. a python scalar) is captured by "
    "closure instead of flowing as an argument")
R_RECOMPILE = rule(
    "trace/recompile",
    "torch.compile compiled a frame again on a same-shaped tick: the "
    "program silently recompiles across ticks")
R_GRAPH_BREAK = rule(
    "trace/graph-break",
    "torch.compile splits the program into several graphs (eager code "
    "runs it whole; a captured replay would not)")
R_SCALAR_ARG = rule(
    "trace/python-scalar-arg",
    "python int/float/bool argument: torch.compile guards on its value and "
    "a CUDA graph cannot take it as an input")
R_SCALAR_CONST = rule(
    "trace/scalar-capture",
    "0-dim tensor captured from the enclosing scope: baked into the traced "
    "graph")
R_BIG_CONST = rule(
    "trace/large-const-capture",
    "large tensor captured by closure: baked into every traced graph "
    "instead of passed as an argument")
R_OUT_OF_PLACE = rule(
    "trace/out-of-place-update",
    "an output matches a large input (shape+dtype) that the program did not "
    "update in place: it holds two live copies where one would do")
R_NO_INTROSPECTION = rule(
    "trace/no-introspection",
    "torch._dynamo is unavailable; recompile check skipped")
R_NO_GRAPH = rule(
    "trace/no-graph",
    "make_fx cannot trace the program: the retrace check is skipped")

#: the reference's rule -> the port's
REFERENCE_RULES = {
    "jaxpr/host-callback": R_HOST_SYNC,
    "jaxpr/state-dependent-trace": R_STATE_TRACE,
    "jaxpr/recompile": R_RECOMPILE,
    "jaxpr/weak-type-arg": R_SCALAR_ARG,
    "jaxpr/scalar-capture": R_SCALAR_CONST,
    "jaxpr/large-const-capture": R_BIG_CONST,
    "jaxpr/missed-donation": R_OUT_OF_PLACE,
    "jaxpr/no-cache-introspection": R_NO_INTROSPECTION,
}

_BIG_CONST_BYTES = 1 << 20      # 1 MiB: above this, closure capture is
_DONATION_BYTES = 1 << 16       # worth flagging; below, it's a lookup table

# methods that read a device tensor's values on the host without an aten
# op the dispatch mode would see on the CPU (``.item()``, ``int()`` and
# the like dispatch ``_local_scalar_dense``; ``.cpu()`` is a move)
_HOST_READS = frozenset({"tolist", "numpy", "__array__"})
# aten ops whose output shape (or value on the host) is read from a device
# tensor's values
_DATA_DEPENDENT = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "_unique2", "unique",
    "unique_consecutive", "unique_dim", "bincount", "equal", "is_nonzero",
})
_FACTORIES = frozenset({
    "tensor", "as_tensor", "asarray", "arange", "zeros", "ones", "full",
    "empty", "randn", "rand", "randint", "eye", "linspace", "logspace",
    "empty_strided", "scalar_tensor",
})
# factories that copy host data (a blocking upload onto a card)
_FROM_DATA = frozenset({"tensor", "as_tensor", "asarray"})

_TORCH_DIR = os.path.dirname(torch.__file__)
_WARNINGS_FILE = warnings.__file__


def _site() -> str:
    """``file:line`` of the innermost frame outside torch, the warnings
    machinery and this module: the program's line that called the op
    (the path from ``repro_torch/`` on, else the file's name)."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if not (name.startswith(_TORCH_DIR) or name == __file__
                or name == _WARNINGS_FILE or name.startswith("<")):
            at = name.rfind("repro_torch" + os.sep)
            short = name[at:] if at >= 0 else os.path.basename(name)
            return f"{short}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _tensors(tree):
    """The tensor leaves of a tree of dicts, sequences and dataclasses."""
    return (t for t in arrays(tree) if isinstance(t, torch.Tensor))


def _scalars(tree):
    """The python int/float/bool leaves of a tree (not numpy scalars)."""
    if isinstance(tree, (bool, int, float)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _scalars(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _scalars(v)


class _Residence(TorchFunctionMode):
    """Follows which tensors live on the program's device while it runs
    (module docstring) and records each host sync as ``(site, what)``."""

    def __init__(self, args, device):
        super().__init__()
        self.device = torch.device(device)
        self.dev: dict[int, torch.Tensor] = {}   # id -> tensor (held)
        self.syncs: list[tuple[str, str]] = []
        for t in _tensors(args):
            self.dev[id(t)] = t

    def _on_device(self, t) -> bool:
        return id(t) in self.dev

    def _is_program_device(self, d) -> bool:
        if d is None:
            return False
        if isinstance(d, torch.Tensor):
            return self._on_device(d)
        d = torch.device(d)
        return d.type == self.device.type and (
            d.index is None or self.device.index is None
            or d.index == self.device.index)

    def _sync(self, what: str) -> None:
        self.syncs.append((_site(), what))

    def _target_device(self, name, args, kwargs):
        """The device (or tensor whose residence) a ``to``/``cuda``/``cpu``
        call moves to; None for a cast that keeps the device."""
        if name in ("cpu", "cuda"):
            return name
        if "device" in kwargs:
            return kwargs["device"]
        for a in args[1:]:
            if isinstance(a, (str, torch.device, torch.Tensor)) or (
                    isinstance(a, int) and not isinstance(a, bool)):
                return a
        return None

    def _moves_to_device(self, target) -> bool:
        """Whether ``target`` names the program's device: a literal
        ``"cpu"`` (or ``.cpu()``) is the host even where the program runs
        on the CPU; a ``torch.device`` names it as it compares."""
        if isinstance(target, torch.Tensor):
            return self._on_device(target)
        if isinstance(target, str) and torch.device(target).type == "cpu":
            return False
        return self._is_program_device(target)

    def _mark(self, out) -> None:
        for t in _tensors(out):
            self.dev[id(t)] = t

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        ins = list(_tensors((args, kwargs)))
        on_dev = any(self._on_device(t) for t in ins)

        if name in ("to", "cuda", "cpu"):
            return self._move(func, name, args, kwargs)
        if on_dev and name in _HOST_READS:
            self._sync(f"{name}() of a device tensor")
            return func(*args, **kwargs)
        if name in ("__getitem__", "__setitem__", "index_put_", "index_put",
                    "copy_") and args and self._on_device(args[0]):
            self._indexing(name, args, kwargs)
        out = func(*args, **kwargs)
        if on_dev:
            self._mark(out)
        elif name in _FACTORIES and \
                self._is_program_device(kwargs.get("device")):
            if name in _FROM_DATA and not (
                    args and isinstance(args[0], torch.Tensor)
                    and self._on_device(args[0])):
                self._sync(f"{name}(..., device=) copies host data to the "
                           f"device (a blocking copy)")
                if out is (args[0] if args else None):
                    out = out.clone()
            self._mark(out)
        return out

    def _move(self, func, name, args, kwargs):
        src = args[0]
        target = self._target_device(name, args, kwargs)
        out = func(*args, **kwargs)
        if target is None:                  # a dtype cast: same residence
            if self._on_device(src):
                self._mark(out)
            return out
        to_dev = self._moves_to_device(target)
        if self._on_device(src) and not to_dev:
            self._sync(f"{name}() copies a device tensor to the host")
            return out.clone() if out is src else out
        if not self._on_device(src) and to_dev:
            if not kwargs.get("non_blocking", False):
                self._sync(f"{name}() copies host data to the device "
                           f"without non_blocking (a blocking copy)")
            out = out.clone() if out is src else out
            self._mark(out)
            return out
        if self._on_device(src):
            self._mark(out)
        return out

    def _indexing(self, name, args, kwargs) -> None:
        idx = args[1] if len(args) > 1 else kwargs.get("indices")
        if name == "copy_":
            src = args[1] if len(args) > 1 else kwargs.get("src")
            if isinstance(src, torch.Tensor) and src.dim() > 0 and \
                    not self._on_device(src) and \
                    not kwargs.get("non_blocking", False):
                self._sync("copy_ of host data into a device tensor (a "
                           "blocking copy)")
            return
        flat = idx if isinstance(idx, (tuple, list)) else (idx,)
        for i in flat:
            if isinstance(i, torch.Tensor) and not self._on_device(i) \
                    and i.dim() > 0:
                self._sync(f"{name} with a host index tensor (a blocking "
                           f"copy to the device)")
        if name == "__setitem__" and len(args) > 2:
            v = args[2]
            if isinstance(v, torch.Tensor) and v.dim() > 0 and \
                    not self._on_device(v):
                self._sync("__setitem__ of host data into a device tensor "
                           "(a blocking copy)")


class _DeviceData(TorchDispatchMode):
    """The aten-level half of the residence watch: it follows device data
    through every op (autograd's backward included, which the function
    mode does not see) and records the ops whose output shape or host
    value is read from device data.  It also knows every tensor the
    program was given or made; a tensor an op reads that is neither was
    captured from the enclosing scope (``captures``: tensor, site)."""

    def __init__(self, res: _Residence, args):
        super().__init__()
        self.res = res
        self.known: dict[int, torch.Tensor] = {id(t): t
                                               for t in _tensors(args)}
        self.captures: list[tuple[torch.Tensor, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        ins = list(_tensors((args, kwargs)))
        for t in ins:
            if id(t) not in self.known:
                self.known[id(t)] = t
                self.captures.append((t, _site()))
        on_dev = any(self.res._on_device(t) for t in ins)
        if on_dev:
            what = self._reads_device_data(func, name, args, kwargs)
            if what:
                self.res._sync(what)
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self.known[id(t)] = t
        if on_dev:
            self.res._mark(out)
        return out

    def _reads_device_data(self, func, name, args, kwargs) -> str | None:
        res = self.res
        if name in _DATA_DEPENDENT:
            return f"{name}: output read from device data"
        if name == "repeat_interleave" and func._overloadname == "Tensor" \
                and kwargs.get("output_size") is None \
                and res._on_device(args[0]):
            return ("repeat_interleave with no output_size: output shape "
                    "read from device data")
        if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            for i in args[1] if len(args) > 1 else ():
                if isinstance(i, torch.Tensor) and res._on_device(i) and \
                        i.dtype in (torch.bool, torch.uint8):
                    return (f"{name} with a boolean device mask: output "
                            f"shape read from device data")
        return None


def _program_device(args):
    first = next(_tensors(args), None)
    return first.device if first is not None else torch.device("cpu")


def watch(fn, *args):
    """Run ``fn(*args)`` once under the residence mode; returns (its
    output, [(site, what)] of every host sync it made, [(tensor, site)] of
    every tensor it captured from its enclosing scope)."""
    mode = _Residence(args, _program_device(args))
    data = _DeviceData(mode, args)
    with mode, data:
        out = fn(*args)
    return out, mode.syncs, data.captures


def _sync_findings(syncs, site: str) -> list[Finding]:
    """One finding a source line: what it does first, and how often."""
    seen: dict[str, list] = {}
    for src, what in syncs:
        seen.setdefault(src, [what, 0])[1] += 1
    return [Finding("error", R_HOST_SYNC, site,
                    f"{what} at {src}" + (f" ({n}x)" if n > 1 else ""))
            for src, (what, n) in seen.items()]


_SRC_RE = re.compile(r" at (\S+:\d+)")


def sync_sources(findings: list[Finding]) -> set[str]:
    """The source lines (``file:line``) of the ``trace/host-sync``
    findings."""
    return {m.group(1) for f in findings if f.rule == R_HOST_SYNC
            for m in [_SRC_RE.search(f.detail)] if m}


def reported_syncs(fn, *args) -> tuple[object, list[str]]:
    """Run ``fn(*args)`` on the card under
    ``torch.cuda.set_sync_debug_mode("warn")``; returns (its output, the
    ``file:line`` of every synchronising call the card reported), the
    lines named as :func:`_site` names them."""
    got: list[str] = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            got.append(_site())

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")   # (it warns that it is on)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()      # itself a sync: outside the watch
    return out, got


def _flat(tree):
    """(the tensor leaves of ``tree``, a function rebuilding ``tree`` from
    such leaves): dicts, lists, tuples, named tuples and dataclasses."""
    leaves = list(_tensors(tree))

    def rebuild(new):
        it = iter(new)

        def go(x):
            if isinstance(x, torch.Tensor):
                return next(it)
            if isinstance(x, dict):
                return {k: go(v) for k, v in x.items()}
            if isinstance(x, tuple) and hasattr(x, "_fields"):
                return type(x)(*(go(v) for v in x))
            if isinstance(x, (list, tuple)):
                return type(x)(go(v) for v in x)
            if dataclasses.is_dataclass(x) and not isinstance(x, type):
                return type(x)(**{f.name: go(getattr(x, f.name))
                                  for f in dataclasses.fields(x)})
            return x
        return go(tree)
    return leaves, rebuild


def _graph(fn, args, site: str):
    """``make_fx``'s graph of ``fn(*args)``, every tensor of the argument
    trees a placeholder and of the result an output (a value read on the
    host is traced as the constant it was), or a ``trace/no-graph``
    finding."""
    from torch.fx.experimental.proxy_tensor import make_fx
    leaves, rebuild = _flat(tuple(args))

    def flat_fn(*ts):
        return list(_tensors(fn(*rebuild(ts))))
    try:
        return make_fx(flat_fn, _error_on_data_dependent_ops=False)(*leaves)
    except Exception as e:   # the audit reports, never raises
        return Finding("info", R_NO_GRAPH, site,
                       f"{type(e).__name__}: {str(e).splitlines()[0][:160]}")


def _versions(args) -> dict[int, int]:
    return {id(t): t._version for t in _tensors(args)}


def audit_program(fn, *example_args, site: str = "program"
                  ) -> list[Finding]:
    """Run ``fn`` once on the example inputs under the residence mode and
    audit what it did (module docstring): host syncs, captures, python
    scalar arguments, out-of-place updates."""
    out: list[Finding] = []
    before = _versions(example_args)
    result, syncs, captures = watch(fn, *example_args)
    out += _sync_findings(syncs, site)
    out += _out_of_place(example_args, before, result, site)

    for n in _scalars(example_args):
        out.append(Finding("warning", R_SCALAR_ARG, site,
                           f"python {type(n).__name__} argument {n!r}: pass "
                           f"a tensor (or host array) instead"))
    for const, src in captures:
        nb = const.numel() * const.element_size()
        if const.dim() == 0:
            out.append(Finding("error", R_SCALAR_CONST, site,
                               f"0-dim {const.dtype} tensor captured by "
                               f"closure, read at {src}"))
        elif nb > _BIG_CONST_BYTES:
            out.append(Finding("warning", R_BIG_CONST, site,
                               f"{const.dtype}{list(const.shape)} tensor "
                               f"({nb} bytes) captured by closure, read at "
                               f"{src}"))
    return out


def _out_of_place(args, before, result, site: str) -> list[Finding]:
    ins = {id(t): t for t in _tensors(args)}
    outs = list(_tensors(result))
    out_ids = {id(t) for t in outs}
    avail: dict[tuple, int] = {}
    for i, t in ins.items():
        nb = t.numel() * t.element_size()
        if nb < _DONATION_BYTES or t._version != before[i] or i in out_ids:
            continue
        key = (tuple(t.shape), t.dtype)
        avail[key] = avail.get(key, 0) + 1
    missed = missed_bytes = 0
    for t in outs:
        if id(t) in ins:
            continue
        key = (tuple(t.shape), t.dtype)
        if avail.get(key, 0) > 0:
            avail[key] -= 1
            missed += 1
            missed_bytes += t.numel() * t.element_size()
    if not missed:
        return []
    return [Finding("warning", R_OUT_OF_PLACE, site,
                    f"{missed} output tensor(s) ({missed_bytes} bytes) "
                    f"match inputs the program left as they were; updating "
                    f"those in place would reuse them")]


def audit_retrace(fn, args_a, args_b, site: str = "program"
                  ) -> list[Finding]:
    """Differential capture check: trace ``fn`` with ``make_fx`` at two
    consecutive engine states (same tree/shapes/dtypes, different values).
    Identical graph code proves every tick-varying value flows through the
    arguments."""
    ga, gb = _graph(fn, args_a, site), _graph(fn, args_b, site)
    for g in (ga, gb):
        if isinstance(g, Finding):
            return [g]
    ga, gb = ga.code, gb.code
    if ga == gb:
        return []
    delta = next((f"line {i}: {la.strip()!r} != {lb.strip()!r}"
                  for i, (la, lb) in enumerate(zip(ga.splitlines(),
                                                   gb.splitlines()))
                  if la != lb), "program lengths differ")
    return [Finding("error", R_STATE_TRACE, site,
                    f"graph code differs across ticks ({delta})")]


def _dynamo():
    """``torch._dynamo`` where it runs here, else None."""
    try:
        import torch._dynamo as dynamo
    except Exception:
        return None
    return dynamo if dynamo.is_dynamo_supported() else None


def audit_recompile(fn, ticks, site: str = "program") -> list[Finding]:
    """Dynamic recompile check: drive ``torch.compile(fn,
    backend="eager")`` over each tick's args (same shapes/dtypes
    throughout) and require dynamo's compiled-frame count to stop growing
    after the first."""
    dynamo = _dynamo()
    if dynamo is None:
        return [Finding("info", R_NO_INTROSPECTION, site,
                        "torch._dynamo is unavailable")]
    from torch._dynamo.utils import counters

    dynamo.reset()
    counters.clear()
    compiled = torch.compile(fn, backend="eager")
    sizes = []
    for args in ticks:
        compiled(*args)
        sizes.append(counters["frames"]["total"])
    breaks = dict(counters["graph_break"])
    dynamo.reset()
    out = []
    grew = [i for i in range(1, len(sizes)) if sizes[i] > sizes[i - 1]]
    if grew:
        out.append(Finding("error", R_RECOMPILE, site,
                           f"compiled frames {sizes} across same-shaped "
                           f"ticks: recompiled on tick(s) {grew}"))
    if breaks:
        first = sorted(breaks)[0]
        out.append(Finding("info", R_GRAPH_BREAK, site,
                           f"{sum(breaks.values())} graph break(s), e.g. "
                           f"{first.splitlines()[0][:120]!r}"))
    return out


# ---------------------------------------------------------------------------
# Shipped hot paths: the program set the repo serves/trains with
# ---------------------------------------------------------------------------


def card_findings(fn, *args, findings: list[Finding],
                  site: str = "program") -> list[Finding]:
    """Run ``fn(*args)`` on the card under :func:`reported_syncs`; a
    ``trace/host-sync`` finding for each line the card reports a sync at
    that ``findings`` (the watch's, for the same program) do not name."""
    _, got = reported_syncs(fn, *args)
    known = sync_sources(findings)
    return _sync_findings([(src, "a synchronizing call reported by the card")
                           for src in got if src not in known], site)


def audit_hot_paths(cfg, *, device="cuda", slots: int = 2,
                    max_seq: int = 16, page_size: int = 4,
                    prompt_len: int = 4, batch: int = 2) -> list[Finding]:
    """Audit the shipped train step and the serve decode / prefill /
    slot-write / paged-decode programs for ``cfg`` (use a reduced config:
    each program runs).  Encoder-only families audit the train step only.

    On the card (the default) the serving programs run the kernels
    (``impl="cuda"``) and every program also runs under
    :func:`card_findings`, so a sync the card reports and the watch
    missed is a finding too; ``device="cpu"`` runs the plain versions
    (``impl="torch"``) and the watch alone."""
    from repro_torch.launch.serve import _write_slot
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import family_module
    from repro_torch.optim import AdamW

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: audit on the card, or pass "
                           "device='cpu'")
    impl = "cuda" if on_card else "torch"

    def run(fn, *args, site):
        got = audit_program(fn, *args, site=site)
        if on_card:
            got += card_findings(fn, *args, findings=got, site=site)
        return got

    out: list[Finding] = []
    mod = family_module(cfg)
    params = mod.init(cfg, seed=0, tp=1, device=dev)

    # -- train step (as launch/train.py runs it) -----------------------------
    opt = AdamW()
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    seq = 8
    mdt = getattr(torch, cfg.dtype)
    lbl = torch.zeros((batch, seq), dtype=torch.int64, device=dev)
    if cfg.embed_inputs:          # hubert: precomputed frame embeddings
        b = {"frames": torch.zeros((batch, seq, cfg.d_model), dtype=mdt,
                                   device=dev), "labels": lbl}
    elif cfg.vis_tokens:          # internvl2: patch-embedding prefix
        b = {"tokens": torch.zeros((batch, seq), dtype=torch.int64,
                                   device=dev),
             "patches": torch.zeros((batch, cfg.vis_tokens, cfg.d_model),
                                    dtype=mdt, device=dev),
             "labels": lbl}
    else:
        b = {"tokens": torch.zeros((batch, seq), dtype=torch.int64,
                                   device=dev), "labels": lbl}
    out += run(step, params, opt_state, b, site=f"{cfg.name}/train_step")
    if cfg.embed_inputs:
        return out
    params = mod.init(cfg, seed=0, tp=1, device=dev)

    # -- serving programs (the builders the engines call) --------------------
    decode_step = make_decode_step(cfg, impl=impl)
    cache = mod.init_cache(cfg, slots, max_seq, 1, device=dev)
    toks = np.zeros((slots, 1), np.int64)

    def decode(params, cache, tokens, pos):
        return decode_step(params, cache, tokens, pos)

    def dense_tick(t):
        return (params, cache, torch.as_tensor(toks + t, device=dev),
                np.full(slots, 1 + t, np.int64))

    with torch.no_grad():
        out += run(decode, *dense_tick(0), site=f"{cfg.name}/serve_decode")
        out += audit_retrace(decode, dense_tick(0), dense_tick(1),
                             site=f"{cfg.name}/serve_decode")
        out += audit_recompile(decode, [dense_tick(t) for t in range(3)],
                               site=f"{cfg.name}/serve_decode")

        prefill = make_prefill_step(cfg, impl=impl, cache_len=max_seq)
        ptoks = torch.zeros((1, prompt_len), dtype=torch.int64, device=dev)
        out += run(prefill, params, ptoks, site=f"{cfg.name}/serve_prefill")
        out += audit_retrace(prefill, (params, ptoks), (params, ptoks + 1),
                             site=f"{cfg.name}/serve_prefill")

        axes = mod.cache_slot_axes(cfg)
        _, slot_cache = prefill(params, ptoks)

        def write_slot(cache, slot_cache, slot):
            _write_slot(cache, slot_cache, slot, axes)
            return cache

        out += run(write_slot, cache, slot_cache, 0,
                   site=f"{cfg.name}/serve_write_slot")

        # -- paged decode (page-table KV) ------------------------------------
        n_pages = -(-max_seq // page_size) * slots
        pcache = mod.init_paged_cache(cfg, slots, n_pages * page_size,
                                      max_seq, 1, device=dev)
        row_map = np.full((slots, max_seq), -1, np.int32)
        row_map[:, :page_size] = np.arange(
            slots * page_size, dtype=np.int32).reshape(slots, page_size)

        def paged(params, cache, tokens, pos, row_map):
            return decode_step(params, cache, tokens, pos, row_map)

        def paged_tick(t):
            return (params, pcache, torch.as_tensor(toks + t, device=dev),
                    np.full(slots, 1 + t, np.int64), row_map)

        out += run(paged, *paged_tick(0), site=f"{cfg.name}/paged_decode")
        out += audit_retrace(paged, paged_tick(0), paged_tick(1),
                             site=f"{cfg.name}/paged_decode")
        out += audit_recompile(paged, [paged_tick(t) for t in range(3)],
                               site=f"{cfg.name}/paged_decode")
    return out
