"""Activation-sharding context (sequence parallelism, DESIGN.md §6), and
the mesh the model code computes on.

Port of ``repro/distributed/context.py``.  The residual stream between
blocks is what the backward pass saves; left alone it is replicated over
the 'model' axis.  Constraining it to ``P((pod, data), 'model', None)``,
sequence-sharded over TP, is what GSPMD compiles to all-gather /
reduce-scatter pairs.  The port computes on each rank's local shard with
explicit collectives (``distributed.local``), so an installed spec that
names 'model' on the sequence dim turns each row-parallel all-reduce into
a reduce-scatter over the sequence and all-gathers the next
column-parallel input: the same values, less of the residual per rank.

Model code asks :func:`sequence_parallel`; launchers opt in through
``set_activation_spec`` or the scoped :func:`activation_spec`.  Specs are
stored raw and pruned lazily at apply time against the axes the active
mesh has (recorded at install when a ``mesh`` is given, else the ambient
mesh of :func:`use_mesh`), so a spec naming 'pod' never breaks a podless
mesh.

The ambient mesh (:func:`use_mesh`) is what the reference's ``with
mesh:`` is: the step builders install it around each call, and the layers
read their 'model' group from it.
"""
from __future__ import annotations

import contextlib

import torch

from .sharding import P, _filter_axes, axis_names


class _ActivationState:
    """The installed constraint: the raw (unpruned) spec plus the axis
    names of the mesh it was installed with (None = discover lazily), and
    the ambient mesh."""

    __slots__ = ("spec", "axes", "mesh")

    def __init__(self) -> None:
        self.spec: P | None = None
        self.axes: tuple[str, ...] | None = None
        self.mesh = None


_STATE = _ActivationState()


def reset() -> None:
    """Clear the installed spec, axes and ambient mesh (test isolation)."""
    _STATE.spec = None
    _STATE.axes = None
    _STATE.mesh = None


def set_activation_spec(spec: P | None, mesh=None) -> None:
    """Install the residual-stream constraint.  The spec is stored raw;
    pruning to the mesh's axes happens at apply time (``mesh`` here only
    records which axes exist)."""
    _STATE.spec = spec
    _STATE.axes = axis_names(mesh) if (mesh is not None
                                       and spec is not None) else None


@contextlib.contextmanager
def activation_spec(spec: P | None, mesh=None):
    """Scoped :func:`set_activation_spec`: installs ``spec`` for the body
    and restores whatever was installed before on exit."""
    prev = (_STATE.spec, _STATE.axes)
    set_activation_spec(spec, mesh)
    try:
        yield
    finally:
        _STATE.spec, _STATE.axes = prev


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh for the body (None leaves none)."""
    prev = _STATE.mesh
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def current_mesh():
    return _STATE.mesh


def _ambient_axes() -> tuple[str, ...] | None:
    """Axis names of the mesh active right now: the recorded install-time
    axes, else the ambient mesh's."""
    if _STATE.axes is not None:
        return _STATE.axes
    if _STATE.mesh is not None:
        return axis_names(_STATE.mesh)
    return None


def _pruned(spec: P, axes: tuple[str, ...]) -> P:
    return P(*(_filter_axes(e, axes) for e in spec))


def get_activation_spec() -> P | None:
    """The spec as it would apply right now (pruned to the known axes)."""
    if _STATE.spec is None:
        return None
    axes = _ambient_axes()
    return _pruned(_STATE.spec, axes) if axes is not None else _STATE.spec


def constrain(x: torch.Tensor, spec: P) -> torch.Tensor:
    """The reference's constraint for internal activations (MoE dispatch
    buffers).  The port lays such buffers out by its explicit collectives
    (``distributed.local``), so this returns ``x``; it validates that the
    spec prunes against the known axes."""
    axes = _ambient_axes()
    if axes is not None:
        _pruned(spec, axes)
    return x


def constrain_activations(x: torch.Tensor) -> torch.Tensor:
    """The reference's residual-stream constraint.  Values never change
    under a sharding, so this returns ``x``; where the spec applies
    (:func:`sequence_parallel`), the layers lay the stream out themselves.
    No-op when unset or when the sequence dim cannot shard (decode, S=1);
    a spec installed without a mesh prunes here, against the ambient
    mesh."""
    if _STATE.spec is None or x.ndim != 3 or x.shape[1] == 1:
        return x
    get_activation_spec()
    return x


def sequence_parallel(seq_len: int) -> bool:
    """Whether the residual stream of a (B, ``seq_len``, D) activation is
    sequence-sharded over 'model' right now: a spec naming 'model' on dim
    1 applies on the ambient mesh, whose 'model' axis is > 1 and divides
    ``seq_len``."""
    spec = get_activation_spec()
    mesh = _STATE.mesh
    if spec is None or mesh is None or len(spec) < 2 or seq_len < 2:
        return False
    entry = spec[1]
    names = (entry,) if isinstance(entry, str) else (entry or ())
    if "model" not in names or "model" not in axis_names(mesh):
        return False
    t = mesh.size(axis_names(mesh).index("model"))
    return t > 1 and seq_len % t == 0


DEFAULT_TRAIN_SPEC = P(("pod", "data"), "model", None)
