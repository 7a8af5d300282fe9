"""Roofline analysis on the H100: the port of ``repro/launch/roofline.py``
(DESIGN.md §7).  Reads the port's dry-run records
(``artifacts/torch_dryrun/``) and derives three terms per (arch x shape x
mesh) on NVIDIA H100 SXM5 80 GB cards:

  compute term    = matmul FLOPs/dev ÷ PEAK_FLOPS      (989 TFLOP/s bf16)
  memory term     = HBM bytes/dev    ÷ HBM_BW          (3.35 TB/s)
  collective term = Σ over collectives of its wire bytes/dev ÷ the rate
                    of the slowest fabric its group spans: NVLink
                    (NVLINK_BW each way) inside an 8-GPU node, NDR
                    InfiniBand (IB_BW) between nodes

FLOPs and wire bytes come from the dry run (``launch.op_analysis``: the
FLOP counter and the port's collectives under the reference's ring
model); HBM bytes are the reference's analytic formula (params + optimizer
+ saved activations + KV/state cache traffic per step).  MODEL_FLOPS =
6·N·D (train) / 2·N·D (prefill) / 2·N_active·B (decode, + KV attention
reads).  The production meshes number ranks with 'model' innermost, so a
16-rank 'model' group spans two nodes and every axis of them crosses
InfiniBand: the collective term is the truth for this card, not a TPU
torus's.

Run:  python -m repro_torch.launch.roofline \
          [--emit artifacts/torch_roofline.md] [--all-meshes]

The card's rates live here and nowhere else: ``chip_smoke.py`` bounds its
kernels by :data:`CARDS`.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path

# NVIDIA H100 data sheet (dense, no sparsity), per card: HBM rate, float32
# FLOP/s without tensor cores, bfloat16 tensor-core FLOP/s.  SXM5 80 GB:
# HBM3 3.35 TB/s, 67 TFLOP/s, 989 TFLOP/s; PCIe 80 GB: HBM2e 2.0 TB/s, 51,
# 756.
CARDS = {"sxm": {"hbm": 3.35e12, "f32": 67e12, "bf16": 989e12},
         "pcie": {"hbm": 2.0e12, "f32": 51e12, "bf16": 756e12}}
PEAK_FLOPS = CARDS["sxm"]["bf16"]   # FLOP/s, bf16 tensor cores
HBM_BW = CARDS["sxm"]["hbm"]        # B/s
# NVLink 4 (H100 SXM5 data sheet): 900 GB/s bidirectional, 450 GB/s each
# way, among the 8 GPUs of an HGX H100 node (NVSwitch: all to all)
NVLINK_BW = 450e9
GPUS_PER_NODE = 8
# between nodes: one ConnectX-7 NDR InfiniBand port per GPU, 400 Gb/s =
# 50 GB/s each way (the DGX H100 reference design)
IB_BW = 50e9

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "torch_dryrun"


def card_rates(device_name: str) -> dict[str, float]:
    """:data:`CARDS`' entry for a card by its name (the PCIe part says
    so in its name)."""
    return CARDS["pcie" if "PCIe" in device_name else "sxm"]


def model_flops(cfg, shape) -> float:
    """Global mathematically-useful FLOPs for one step (MODEL_FLOPS)."""
    n_active = cfg.params_active()
    b, s = shape.global_batch, shape.seq_len
    hd = cfg.head_dim
    if shape.kind == "train":
        tokens = b * s
        attn = 12 * cfg.n_layers * b * s * s * cfg.n_heads * hd \
            if cfg.n_heads else 0
        if cfg.family == "zamba2":
            attn = attn // max(1, cfg.attn_every)
        return 6.0 * n_active * tokens + attn
    if shape.kind == "prefill":
        tokens = b * s
        attn = 4 * cfg.n_layers * b * s * s * cfg.n_heads * hd \
            if cfg.n_heads else 0
        if cfg.family == "zamba2":
            attn = attn // max(1, cfg.attn_every)
        return 2.0 * n_active * tokens + attn
    # decode: one token per sequence
    attn_layers = cfg.n_layers if cfg.family not in ("rwkv6", "zamba2") else \
        (cfg.n_layers // max(1, cfg.attn_every) if cfg.family == "zamba2" else 0)
    kv_flops = 4.0 * b * s * attn_layers * cfg.n_kv_heads * hd \
        if cfg.n_kv_heads else 0
    return 2.0 * n_active * b + kv_flops


def hbm_bytes_per_dev(cfg, shape, n_dev: int, record: dict) -> float:
    """Analytic per-device HBM traffic for one step (formula in module doc)."""
    p_bytes = cfg.params_dense() * 2 / n_dev          # bf16, sharded
    arg = record["memory"]["argument_bytes"]          # params(+opt+cache)/dev
    b, s = shape.global_batch, shape.seq_len
    act = b * s * cfg.d_model * 2 / n_dev             # one residual stream
    if shape.kind == "train":
        # fwd read + bwd read + grad write + opt m/v read+write (in arg)
        return 3 * p_bytes + 2 * (arg - p_bytes) + 2 * cfg.n_layers * act
    if shape.kind == "prefill":
        return p_bytes + 2 * cfg.n_layers * act
    # decode: stream all (active) weights once + read the KV/state cache
    active = p_bytes * cfg.params_active() / max(1, cfg.params_dense())
    return active + (arg - p_bytes)


def fabric_bw(nodes: int) -> float:
    """Each-way rate of a group spanning ``nodes`` 8-GPU nodes."""
    return NVLINK_BW if nodes <= 1 else IB_BW


def collective_seconds(ops: dict) -> float:
    """Σ over the record's collectives of its ring-model wire bytes over
    the rate of the slowest fabric its group spans."""
    from repro_torch.launch.op_analysis import OpReport

    rep = OpReport(0.0, ops["collective_bytes"], ops["group_sizes"],
                   ops["collective_counts"])
    return sum(rep.kind_wire_bytes(k) / fabric_bw(ops["group_nodes"][k])
               for k in ops["collective_bytes"])


@dataclass
class Row:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_dev: float
    counted_flops_dev: float
    temp_gib: float
    arg_gib: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops_dev / self.counted_flops_dev \
            if self.counted_flops_dev else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute term / max(all terms): 1.0 = compute-bound at peak."""
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        return self.compute_s / bound if bound else 0.0


def build_row(record: dict) -> Row:
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES

    cfg = get_config(record["arch"])
    shape = SHAPES[record["shape"]]
    n_dev = record["n_devices"]
    flops = record["ops"]["dot_flops"]
    mem_bytes = hbm_bytes_per_dev(cfg, shape, n_dev, record)
    return Row(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        compute_s=flops / PEAK_FLOPS,
        memory_s=mem_bytes / HBM_BW,
        collective_s=collective_seconds(record["ops"]),
        model_flops_dev=model_flops(cfg, shape) / n_dev,
        counted_flops_dev=flops,
        temp_gib=record["memory"]["temp_bytes"] / 2**30,
        arg_gib=record["memory"]["argument_bytes"] / 2**30,
    )


def suggestion(row: Row) -> str:
    if row.dominant == "collective":
        return ("reduce wire bytes: coarser EP/TP collectives, bf16 reduce, "
                "keep the 'model' axis inside one NVLink node, or re-shard "
                "the hot product")
    if row.dominant == "memory":
        if row.shape.startswith("decode") or row.shape.startswith("long"):
            return ("decode is weight/cache streaming-bound: quantize KV, "
                    "raise per-step batch, or multi-token decode")
        return "cut re-fetch: fuse, larger per-step compute, better remat"
    if row.useful_ratio < 0.5:
        return ("compute-bound but <50% useful: shrink remat recompute / "
                "head padding waste")
    return ("compute-bound: push tensor-core utilization (tile shapes, bf16 "
            "paths)")


def load_rows(variant: str = "baseline") -> list[Row]:
    rows = []
    for path in sorted(ART_DIR.glob("*.json")):
        rec = json.loads(path.read_text())
        if rec.get("variant", "baseline") != variant:
            continue
        rows.append(build_row(rec))
    return rows


def markdown(rows: list[Row], single_pod_only: bool = True) -> str:
    from repro_torch.configs import all_cells, cell_skip_reason

    out = ["| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL/counted flops | roofline frac | temp GiB |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    seen = set()
    for r in sorted(rows, key=lambda r: (r.arch, r.shape, r.mesh)):
        if single_pod_only and "pod" in r.mesh:
            continue
        seen.add((r.arch, r.shape))
        out.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3e} | "
            f"{r.memory_s:.3e} | {r.collective_s:.3e} | **{r.dominant}** | "
            f"{r.useful_ratio:.2f} | {r.roofline_fraction:.2f} | "
            f"{r.temp_gib:.1f} |")
    out.append("")
    out.append("Skipped cells (DESIGN.md §5):")
    for a, s in all_cells():
        reason = cell_skip_reason(a, s)
        if reason:
            out.append(f"- {a} × {s}: {reason}")
        elif (a, s) not in seen:
            out.append(f"- {a} × {s}: (no dry-run artifact found)")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--emit", default=str(ART_DIR.parent
                                          / "torch_roofline.md"))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all-meshes", action="store_true")
    args = ap.parse_args(argv)
    rows = load_rows(args.variant)
    md = markdown(rows, single_pod_only=not args.all_meshes)
    Path(args.emit).parent.mkdir(parents=True, exist_ok=True)
    Path(args.emit).write_text(md)
    print(md)
    print()
    for r in sorted(rows, key=lambda r: (r.arch, r.shape)):
        if "pod" not in r.mesh:
            print(f"{r.arch} x {r.shape}: {r.dominant}-bound -> "
                  f"{suggestion(r)}")


if __name__ == "__main__":
    main()
