"""Static legality analysis: the typed :class:`Finding` schema with its rule
catalog (``findings``), the (HWConfig, Schedule, TensorizeChoice) verifier
(``legality``) that gates lowering in the tuner's measurement path
(``error_type="Illegal"``), and the paged-KV page-table/allocator
invariants (``kv_sanitizer``) that serve's ``--sanitize`` asserts every
engine tick."""
from . import findings, kv_sanitizer
from .findings import (RULES, SEVERITIES, Finding, errors, max_severity,
                       rule, summarize, to_json, warnings)

__all__ = [
    "findings", "kv_sanitizer", "RULES", "SEVERITIES", "Finding", "errors",
    "max_severity", "rule", "summarize", "to_json", "warnings",
]
