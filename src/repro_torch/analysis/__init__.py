"""Static legality analysis: the typed :class:`Finding` schema with its rule
catalog (``findings``) and the (HWConfig, Schedule, TensorizeChoice)
verifier (``legality``) that gates lowering in the tuner's measurement path
(``error_type="Illegal"``)."""
from . import findings
from .findings import (RULES, SEVERITIES, Finding, errors, max_severity,
                       rule, summarize, to_json, warnings)

__all__ = [
    "findings", "RULES", "SEVERITIES", "Finding", "errors", "max_severity",
    "rule", "summarize", "to_json", "warnings",
]
