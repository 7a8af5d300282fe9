"""Telemetry schema validator CLI (what a ``--trace`` serve run exports):

    PYTHONPATH=src python -m repro_torch.obs artifacts/telemetry.json

Exits non-zero (listing the defects) when the artifact drifts from the
schema ``repro_torch.obs.export`` writes.
"""
from __future__ import annotations

import argparse
import json
import sys

from .export import DEFAULT_TELEMETRY_PATH, validate_telemetry_file


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", nargs="?", default=str(DEFAULT_TELEMETRY_PATH),
                    help="telemetry artifact to validate")
    args = ap.parse_args(argv)

    errs = validate_telemetry_file(args.path)
    if errs:
        for e in errs:
            print(f"INVALID {args.path}: {e}", file=sys.stderr)
        raise SystemExit(1)
    doc = json.loads(open(args.path).read())
    tr, met = doc["trace"], doc["metrics"]
    print(f"OK {args.path}: schema v{doc['schema_version']}, "
          f"{len(tr['events'])} events ({tr['dropped']} dropped), "
          f"{len(met['counters'])} counters, {len(met['gauges'])} gauges, "
          f"{len(met['histograms'])} histograms")


if __name__ == "__main__":
    main()
