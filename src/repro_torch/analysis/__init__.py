"""Static legality, sharding, and hot-path analysis (DESIGN.md §16).

Four analyzers share one typed :class:`~repro_torch.analysis.findings.Finding`
schema and a common rule catalog (``findings``):

  legality       static (HWConfig, Schedule, TensorizeChoice) verifier
                 mirroring the cost model's feasibility rules -- the tuner's
                 pre-lowering gate (``error_type="Illegal"``)
  trace_audit    run and trace the serve/train hot paths and flag host
                 syncs, closure-captured state, recompile hazards and
                 out-of-place updates (the reference's ``jaxpr_audit``)
  sharding_lint  validate each family's spec trees against real (fake
                 tensor) shapes and a target mesh, and their DTensor
                 placements on a ``DeviceMesh``
  kv_sanitizer   checkable model of the paged-KV page-table/allocator
                 invariants; per-tick engine assertion (``--sanitize``)

``python -m repro_torch.analysis`` lints the shipped configs/meshes plus
the golden codesign schedule and exits non-zero on error-severity findings
(the CI ``analysis-lint`` gate).  ``trace_audit`` and ``sharding_lint``
are imported where they are used; ``findings``/``legality``/
``kv_sanitizer`` stay import-light so the tuner and the engines can use
them unconditionally."""
from . import findings, kv_sanitizer
from .findings import (RULES, SEVERITIES, Finding, errors, max_severity,
                       rule, summarize, to_json, warnings)

__all__ = [
    "findings", "kv_sanitizer", "RULES", "SEVERITIES", "Finding", "errors",
    "max_severity", "rule", "summarize", "to_json", "warnings",
]
