"""Device meshes over the ranks of a process group.

Port of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes.  Building
one needs a process group: :func:`init_distributed` joins the one that
``torchrun`` describes (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT``) or the one an ``init_method`` names (``tcp://`` or
``file://``, as :func:`run_ranks` gives its processes), and without either
starts a group of one rank.

Backends: NCCL where every rank has a card of its own; gloo on the CPU,
and where ranks share a card (NCCL refuses two ranks on one device).

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --smoke \\
      --device cpu --mesh data=1,model=2
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

INIT_ENV = "REPRO_TORCH_INIT_METHOD"


def backend_for(device) -> str:
    """NCCL when every rank of the group has a card of its own, else
    gloo."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device="cpu", init_method: str | None = None) -> None:
    """Join (or start) the process group, once per process; on the card,
    each rank takes card ``LOCAL_RANK % device_count``."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a process group on the "
                               "card")
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend_for(device)
    init_method = init_method or os.environ.get(INIT_ENV)
    if init_method is None and "WORLD_SIZE" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method,
                  rank=int(os.environ["RANK"]),
                  world_size=int(os.environ["WORLD_SIZE"]))
    dist.init_process_group(backend, **kw)


def _device_type(device) -> str:
    return torch.device(device).type


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh: (data 16, model 16), or (pod 2, data 16,
    model 16) with ``multi_pod``.  Refuses any world of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_distributed(device)
    want = 1
    for s in shape:
        want *= s
    n = dist.get_world_size()
    if n != want:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {want} ranks, the process group has {n}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(device),
                      torch.arange(want).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(*, tp: int = 1, device="cpu"):
    """The ranks of the running process group (one without a launched
    group) as a ('data', 'model') mesh.  ``tp`` sets the model-axis size
    (tensor parallelism); it must divide the rank count, the rest becomes
    the data axis."""
    init_distributed(device)
    n = dist.get_world_size()
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} must be >= 1 and divide the host device "
                         f"count ({n})")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(device),
                      torch.arange(n).reshape(n // tp, tp),
                      mesh_dim_names=("data", "model"))


def describe(mesh) -> str:
    return "x".join(f"{k}={mesh.size(i)}"
                    for i, k in enumerate(mesh.mesh_dim_names))


def run_ranks(args: list[str], world: int, store_dir, *, timeout: float,
              env: dict | None = None, cwd=None) -> list[subprocess.CompletedProcess]:
    """Run ``python <args>`` as ``world`` ranks of one process group, its
    rendezvous a ``FileStore`` under ``store_dir`` (no port to collide
    under parallel tests).  Waits for all, at most ``timeout`` seconds
    together (a rank still running then is killed, its return code -9);
    every process is gone on the way out.  Returns each rank's completed
    process (its output read from ``store_dir/rank<r>.{out,err}``), in
    rank order."""
    import time

    base = Path(store_dir).resolve()      # file:// takes an absolute path
    base.mkdir(parents=True, exist_ok=True)
    store = base / "rendezvous"
    if store.exists():
        store.unlink()
    procs, logs = [], []
    try:
        for r in range(world):
            e = dict(os.environ, **(env or {}))
            # every rank is on this host: gloo talks over the loopback
            e.setdefault("GLOO_SOCKET_IFNAME", "lo")
            e.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                     **{INIT_ENV: f"file://{store}"})
            # files, not pipes: a rank blocked on a full pipe would hang
            # the collective its peers wait in
            so = open(base / f"rank{r}.out", "w+")
            se = open(base / f"rank{r}.err", "w+")
            logs.append((so, se))
            procs.append(subprocess.Popen([sys.executable, *args], env=e,
                                          cwd=cwd, text=True, stdout=so,
                                          stderr=se))
        deadline = time.monotonic() + timeout
        out = []
        for p, (so, se) in zip(procs, logs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            rc = p.returncode if p.returncode is not None else -9
            so.seek(0)
            se.seek(0)
            out.append(subprocess.CompletedProcess(p.args, rc, so.read(),
                                                   se.read()))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for so, se in logs:
            so.close()
            se.close()


def rank_json(proc: subprocess.CompletedProcess) -> dict:
    """The JSON object a rank printed on its last line."""
    return json.loads(proc.stdout.strip().splitlines()[-1])
