"""Command-line entry for the static analysis suite: the port of
``repro/analysis/__main__.py`` (DESIGN.md §16.6).

Lints every shipped model config's sharding specs against the production
meshes, statically verifies the golden codesign schedule against its
committed hardware config, and (optionally) audits the serve/train hot
paths (``trace_audit``).  Exits non-zero iff any error-severity finding
survives -- the CI ``analysis-lint`` gate.  Runs on the CPU: nothing here
touches a card, except ``--audit``: it runs the hot paths, on the card
unless ``--device cpu`` asks for the CPU, and refuses where there is no
card.

  # the CI invocation: all configs x {no mesh, data=2 model=4} + golden
  PYTHONPATH=src python -m repro_torch.analysis \
      --json artifacts/torch_analysis_findings.json

  # one config on one mesh, plus a trace audit of its hot paths
  PYTHONPATH=src python -m repro_torch.analysis --arch qwen3-8b \
      --mesh data=2,model=4 --audit qwen3-8b [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

from .findings import RULES, Finding, errors, summarize, to_json

GOLDEN_DEFAULT = Path(__file__).resolve().parents[3] \
    / "tests" / "golden" / "codesign_table1_gemm.json"

_DESCRIBE_RE = re.compile(
    r"\[(?P<intr>\w+)\] tiles\((?P<tiles>[^)]*)\) "
    r"order\((?P<order>[^)]*)\) fuse=(?P<fuse>\d+)")


def parse_mesh(spec: str) -> dict[str, int] | None:
    """'none' -> None; 'data=2,model=4' -> {'data': 2, 'model': 4}."""
    if spec.lower() in ("none", "nomesh", "1"):
        return None
    mesh: dict[str, int] = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        try:
            mesh[name.strip()] = int(size)
        except ValueError:
            raise SystemExit(f"bad --mesh spec {spec!r} "
                             f"(want e.g. data=2,model=4 or none)")
    return mesh


def parse_schedule(described: str, workload):
    """Reconstruct a Schedule from its ``describe()`` string by re-running
    tensorize matching and picking the choice whose mapped loop set equals
    the tile keys (first match — the SoftwareSpace enumeration order)."""
    from repro_torch.core.intrinsics import intrinsic
    from repro_torch.core.matching import match
    from repro_torch.core.sw_primitives import Schedule

    m = _DESCRIBE_RE.match(described.strip())
    if m is None:
        raise ValueError(f"unparseable schedule {described!r}")
    tiles = tuple((k.strip(), int(v)) for k, v in
                  (kv.split("=") for kv in m["tiles"].split(",") if kv))
    order = tuple(x.strip() for x in m["order"].split(">") if x.strip())
    keys = {k for k, _ in tiles}
    for choice in match(intrinsic(m["intr"]), workload):
        if set(choice.mapped_compute_indices) == keys:
            return Schedule(choice, tiles, order, int(m["fuse"]))
    raise ValueError(f"no tensorize choice of {m['intr']} on "
                     f"{workload.name} maps loops {sorted(keys)}")


def golden_findings(path: Path) -> list[Finding]:
    """Statically verify the golden codesign solution: the committed
    hardware config and every per-workload schedule must be legal."""
    from repro_torch.core import workloads as W
    from repro_torch.core.hw_primitives import HWConfig

    from .legality import verify_candidate, verify_hw

    snap = json.loads(path.read_text())
    enc = snap["hw"]
    hw = HWConfig(intrinsic=enc[0], pe_rows=enc[1], pe_cols=enc[2],
                  pe_depth=enc[3], vmem_kib=enc[4], banks=enc[5],
                  local_accum_kib=enc[6], burst_bytes=enc[7],
                  dataflow=enc[8], tp=enc[9])
    out = verify_hw(hw, site=f"golden/{path.name}/hw")
    by_name = {w.name: w for w in W.table1_gemm()}
    for name, entry in snap["workloads"].items():
        site = f"golden/{path.name}/{name}"
        wl = by_name.get(name)
        if wl is None:
            out.append(Finding("error", "legality/choice-workload-mismatch",
                               site, f"golden names unknown workload "
                               f"{name!r}"))
            continue
        sched = parse_schedule(entry["schedule"], wl)
        out.extend(verify_candidate(wl, sched, hw, site=site))
    return out


def _fmt(got: list[Finding]) -> str:
    if not got:
        return "clean"
    s = summarize(got)
    return ", ".join(f"{n} {k}" for k, n in s.items() if n)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static legality / sharding / hot-path lint "
                    "(exit 1 on error-severity findings)")
    ap.add_argument("--arch", action="append", default=[],
                    help="model config to lint (repeatable; default: all)")
    ap.add_argument("--mesh", action="append", default=[],
                    help="mesh as axis=size pairs or 'none' (repeatable; "
                         "default: none + data=2,model=4)")
    ap.add_argument("--golden", type=Path, default=GOLDEN_DEFAULT,
                    help="golden codesign snapshot to verify statically")
    ap.add_argument("--no-golden", action="store_true",
                    help="skip the golden-schedule legality check")
    ap.add_argument("--audit", action="append", default=[],
                    help="also trace-audit this arch's serve/train hot "
                         "paths at reduced scale (repeatable; runs them)")
    ap.add_argument("--device", default="cuda",
                    help="where --audit runs the hot paths (default the "
                         "card, with the kernels; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--json", type=Path,
                    default=Path("artifacts/torch_analysis_findings.json"),
                    help="write the findings JSON artifact here")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.rules:
        # importing the analyzers registers their rules
        from . import kv_sanitizer, legality, sharding_lint, trace_audit  # noqa: F401
        for rid in sorted(RULES):
            print(f"{rid}: {RULES[rid]}")
        return 0

    if args.audit:
        import torch
        if torch.device(args.device).type == "cuda" \
                and not torch.cuda.is_available():
            raise SystemExit("no CUDA device: --audit runs on the card, or "
                             "pass --device cpu")

    from repro_torch.configs import ARCH_IDS, get_config

    from .sharding_lint import lint_config

    arches = args.arch or list(ARCH_IDS)
    meshes = [parse_mesh(s) for s in args.mesh] \
        or [None, {"data": 2, "model": 4}]

    findings: list[Finding] = []
    for arch in arches:
        cfg = get_config(arch)
        for mesh in meshes:
            tag = "no-mesh" if mesh is None else \
                "x".join(f"{k}={v}" for k, v in mesh.items())
            got = lint_config(cfg, mesh)
            findings.extend(got)
            print(f"sharding {arch} [{tag}]: {_fmt(got)}")

    if not args.no_golden and args.golden.exists():
        got = golden_findings(args.golden)
        findings.extend(got)
        print(f"golden {args.golden.name}: {_fmt(got)}")

    if args.audit:
        from repro_torch.models import reduced

        from .trace_audit import audit_hot_paths
        for arch in args.audit:
            got = audit_hot_paths(reduced(get_config(arch)),
                                  device=args.device)
            findings.extend(got)
            print(f"audit {arch}: {_fmt(got)}")

    bad = errors(findings)
    for f in findings:
        print(f"  {f}")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"summary": summarize(findings), "errors": len(bad),
             "findings": to_json(findings)}, indent=2) + "\n")
        print(f"findings -> {args.json}")
    print(f"{len(findings)} finding(s), {len(bad)} error(s)")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
