"""Measured-autotuning subsystem (DESIGN.md §8): close the loop from
analytical DSE to the latencies of the hand-written CUDA kernels.

  measure    lower (HWConfig, Schedule) candidates to concrete kernel
             invocations via ``kernels/ops.py`` and time them
             (warmup/repeat/median, failure capture)
  calibrate  fit per-op log-linear corrections from analytical predictions
             to measured latencies; CalibratedCostModel plugs into the
             ``evaluate_batch``/EvalCache API
  db         persistent tuning database keyed by (op, shape, dtype,
             backend): versioned JSON, merge-on-save, ``best_config``

The flow: ``codesign(measure=True, db_path=...)`` explores analytically,
re-ranks its Pareto frontier by measurement, and persists tuned block
shapes + calibration; ``kernels/ops.py`` dispatch and the launch drivers
consult the database at runtime.  ``python -m repro_torch.tuner --help`` runs the
whole loop from the command line.
"""
from . import calibrate, db, measure
from .calibrate import CalibratedCostModel, Calibration, fit, spearman
from .db import DEFAULT_DB_PATH, TuningDB, TuningRecord
from .measure import (KernelPoint, MeasureOptions, MeasureResult, classify,
                      measure_batch, measure_one, summarize_batch)

__all__ = [
    "calibrate", "db", "measure",
    "CalibratedCostModel", "Calibration", "fit", "spearman",
    "DEFAULT_DB_PATH", "TuningDB", "TuningRecord",
    "KernelPoint", "MeasureOptions", "MeasureResult", "classify",
    "measure_batch", "measure_one", "summarize_batch",
]
