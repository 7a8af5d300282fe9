import sys
from pathlib import Path

# tests run with PYTHONPATH=src; this mirrors that when invoked otherwise.
SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# NOTE: no --xla_force_host_platform_device_count here — smoke tests and
# benches must see the real (single) device; only launch/dryrun.py widens it.

import pytest


@pytest.fixture(autouse=True)
def _reset_activation_context():
    # the activation-sharding context is process state; a test that installs
    # a spec must never leak it into the next test
    yield
    from repro.distributed import context
    context.reset()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the repro_torch kernels have "
        "no CPU mode); skips where there is none")
