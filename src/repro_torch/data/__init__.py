"""Data substrate: deterministic synthetic token pipeline with background
prefetch."""

from .pipeline import Prefetcher, SyntheticLM, make_global_batch

__all__ = ["Prefetcher", "SyntheticLM", "make_global_batch"]
