"""Fault tolerance (DESIGN.md §14): atomic checkpointing with
corrupt-safe restore (``CheckpointManager``), the heartbeat and no-progress
watchdogs, and the seeded fault-injection harness (``inject``)."""

from . import inject
from .checkpoint import CheckpointManager
from .watchdog import ProgressWatchdog, Watchdog

__all__ = ["CheckpointManager", "ProgressWatchdog", "Watchdog", "inject"]
