"""Optimizer substrate: AdamW with global-norm clipping, schedules, and
error-feedback gradient compression."""

from .adamw import AdamW, OptState, cosine_schedule, global_norm
from .compression import ef_compress, ef_init

__all__ = ["AdamW", "OptState", "cosine_schedule", "ef_compress", "ef_init",
           "global_norm"]
