"""Fault tolerance: seeded per-site fault injection (``inject``) and the
serving engines' no-progress watchdog (``watchdog``).

Checkpoint/resume (the reference's ``CheckpointManager``) is not ported
yet; the co-design driver refuses ``checkpoint_dir``/``resume_from``.
"""

from . import inject
from .watchdog import ProgressWatchdog

__all__ = ["ProgressWatchdog", "inject"]
