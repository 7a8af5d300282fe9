"""Fault tolerance: seeded per-site fault injection (``inject``).

Checkpoint/resume (the reference's ``CheckpointManager``) is not ported
yet; the co-design driver refuses ``checkpoint_dir``/``resume_from``.
"""

from . import inject

__all__ = ["inject"]
