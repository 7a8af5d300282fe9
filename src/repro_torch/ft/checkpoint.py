"""Checkpointing for restart (DESIGN.md §14), in PyTorch.

Port of ``repro/ft/checkpoint.py``:

  * atomic: array checkpoints go to ``<dir>/tmp-<step>`` then os.rename to
    ``step-<n>``, so a killed writer never corrupts the latest checkpoint;
    manifests and payloads go through ``core/artifacts.py``'s atomic
    writer (tmp file + rename, fault-injectable);
  * corrupt-safe: a corrupt or partial checkpoint is *skipped with a
    warning*, never fatal: ``restore``/``restore_payload`` fall back to
    the newest older checkpoint that loads cleanly, and a failed ``save``
    warns and keeps the previous checkpoint intact;
  * device-agnostic: leaves are stored as host numpy (one .npy per leaf
    path, the reference's ``SEP``-joined keys), and ``restore`` places
    them on the device and dtype of the caller's ``like`` tree;
  * async: ``save(..., blocking=False)`` copies to the host, then writes
    in a background thread so the step loop keeps running;
  * retention: keeps the last ``keep`` checkpoints;
  * payloads: ``save_payload``/``restore_payload`` checkpoint one pickled
    Python object per step (``state-<n>.pkl``): the co-design driver's
    resume state rides this path.

numpy has no bfloat16 (and the port does without ``ml_dtypes``), so a
bfloat16 leaf is stored as its raw 2-byte words (int16) with
``"dtype": "bfloat16"`` in the manifest, and restored by viewing those
words as bfloat16 again: the same bits.

Trees are nested dicts, tuples and lists of tensors, and ``OptState``
(its fields step, m, v at indices 0, 1, 2, as the reference's pytree
registration flattens it).

On a mesh the files stay mesh-agnostic, as in the reference: ``save``
gathers each DTensor leaf whole (every rank takes part) and rank 0 writes;
``restore(step, like, mesh=, specs=)`` lays each leaf out by its spec on
the *current* mesh, as DTensors -- the elastic re-mesh: a checkpoint saved
from one mesh restores onto another.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import threading
import warnings
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

SEP = "__"


def _items(node) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node of a tree, None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(str(i), getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    return None


def _flatten(tree: Any, prefix: tuple[str, ...] = ()) -> dict[str, Any]:
    """{SEP-joined path: leaf} over ``tree``."""
    items = _items(tree)
    if items is None:
        return {SEP.join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (k,)))
    return out


def _rebuild(like: Any, leaf_of, prefix: tuple[str, ...] = ()) -> Any:
    """``like``'s structure with each leaf replaced by ``leaf_of(path,
    like_leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaf_of, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaf_of, prefix + (str(i),))
                          for i, v in enumerate(like))
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(*(
            _rebuild(getattr(like, f.name), leaf_of, prefix + (str(i),))
            for i, f in enumerate(dataclasses.fields(like))))
    return leaf_of(SEP.join(prefix), like)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or a
    process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(a host copy of ``leaf`` as numpy, its dtype name); a DTensor is
    gathered whole first (a collective: every rank calls this)."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        from repro_torch.distributed.local import full_tensor
        leaf = full_tensor(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)   # never alias the live leaf
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.array(leaf)
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Checkpoint ``tree`` as ``step``.  The leaves are copied to the
        host before this returns, so the caller may update them in place
        while a non-blocking write runs.  In a process group every rank
        calls this (DTensor leaves are gathered) and rank 0 writes."""
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if not _writer():
            return
        if blocking:
            self._write(step, host)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict[str, tuple[np.ndarray, str]]
               ) -> None:
        from repro_torch.core.artifacts import atomic_write_json

        tmp = self.dir / f"tmp-{step}"
        try:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {}
            for key, (arr, dtype) in host.items():
                fname = f"{abs(hash(key)) % 10**12}_{len(manifest)}.npy"
                np.save(tmp / fname, arr)
                manifest[key] = {"file": fname, "shape": list(arr.shape),
                                 "dtype": dtype}
            atomic_write_json(tmp / "manifest.json",
                              {"step": step, "leaves": manifest})
            final = self.dir / f"step-{step:012d}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
        except OSError as e:
            # a flaky disk must not take down the run: the previous
            # checkpoint is still intact (nothing was renamed over it)
            warnings.warn(f"checkpoint step {step} -> {self.dir}: write "
                          f"failed ({e}); keeping previous checkpoint",
                          stacklevel=2)
            shutil.rmtree(tmp, ignore_errors=True)
            return
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step-{s:012d}", ignore_errors=True)
        psteps = sorted(self.payload_steps())
        for s in psteps[: -self.keep]:
            (self.dir / f"state-{s:012d}.pkl").unlink(missing_ok=True)

    # -- payload checkpoints (one pickled object per step) ---------------------
    def save_payload(self, step: int, obj: Any) -> Path | None:
        """Atomically persist one pickled object as this step's payload
        checkpoint; warns and returns ``None`` (previous payloads intact)
        when the write fails."""
        from repro_torch.core.artifacts import atomic_write_bytes

        path = self.dir / f"state-{step:012d}.pkl"
        try:
            atomic_write_bytes(path, pickle.dumps(obj))
        except (OSError, pickle.PicklingError) as e:
            warnings.warn(f"payload checkpoint step {step} -> {path}: write "
                          f"failed ({e}); keeping previous checkpoints",
                          stacklevel=2)
            return None
        self._gc()
        return path

    def payload_steps(self) -> list[int]:
        return sorted(int(p.stem.split("-")[1])
                      for p in self.dir.glob("state-*.pkl"))

    def restore_payload(self, step: int | None = None) -> Any | None:
        """Unpickle the payload at ``step`` (default: newest).  A corrupt,
        partial, or unreadable payload is skipped with a warning and the
        next older one is tried; ``None`` when nothing loads cleanly.
        Only payloads this program wrote are read (unpickling runs code)."""
        from repro_torch.core.artifacts import read_bytes_safe

        steps = self.payload_steps()
        if step is not None:
            steps = [s for s in steps if s <= step]
        for s in reversed(steps):
            path = self.dir / f"state-{s:012d}.pkl"
            raw = read_bytes_safe(path, "payload checkpoint")
            if raw is None:
                continue
            try:
                return pickle.loads(raw)
            except Exception as e:  # corrupt pickle: skip, try older
                warnings.warn(f"payload checkpoint {path}: corrupt ({e}); "
                              f"skipping", stacklevel=2)
        return None

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("-")[1])
                      for p in self.dir.glob("step-*"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def arity(self, step: int) -> int:
        """How many top-level entries the tree saved at ``step`` has (0
        where its manifest does not load)."""
        from repro_torch.core.artifacts import read_json_object

        doc = read_json_object(self.dir / f"step-{step:012d}"
                               / "manifest.json", "checkpoint manifest")
        if not doc:
            return 0
        return len({k.split(SEP, 1)[0] for k in doc["leaves"]})

    def restore(self, step: int, like: Any, mesh=None, specs: Any = None
                ) -> Any:
        """Restore into the structure of ``like``: each leaf on its
        ``like`` leaf's device and dtype; with ``mesh`` and ``specs`` (a
        spec tree shaped like ``like``), each leaf a DTensor laid out by
        its spec on the *current* mesh -- the elastic re-mesh path.

        A corrupt or partial checkpoint at ``step`` (a missing leaf, a torn
        ``.npy``, a bad manifest, a shape other than ``like``'s) is skipped
        with a warning and the newest older step is tried; ``None`` when no
        checkpoint restores cleanly (callers start fresh)."""
        if (mesh is None) != (specs is None):
            raise ValueError("restore onto a mesh takes both mesh= and "
                             "specs=")
        for s in reversed([x for x in self.all_steps() if x <= step]):
            try:
                tree = self._restore_step(s, like)
            except Exception as e:   # missing leaves, torn npy, bad manifest
                warnings.warn(f"checkpoint step {s} in {self.dir}: corrupt "
                              f"or partial ({e}); skipping", stacklevel=2)
                continue
            if mesh is None:
                return tree
            from repro_torch.distributed.local import distribute
            return distribute(tree, specs, mesh)
        return None

    def _restore_step(self, step: int, like: Any) -> Any:
        from repro_torch.core.artifacts import read_json_object

        d = self.dir / f"step-{step:012d}"
        doc = read_json_object(d / "manifest.json", "checkpoint manifest")
        if not doc:
            raise ValueError("missing or corrupt manifest")
        manifest = doc["leaves"]

        def leaf_of(key: str, want):
            entry = manifest[key]
            arr = np.load(d / entry["file"])
            t = torch.from_numpy(arr)
            if entry["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            if isinstance(want, torch.Tensor):
                if tuple(t.shape) != tuple(want.shape):
                    raise ValueError(f"{key}: shape {tuple(t.shape)}, "
                                     f"expected {tuple(want.shape)}")
                return t.to(device=want.device, dtype=want.dtype)
            return t
        return _rebuild(like, leaf_of)
