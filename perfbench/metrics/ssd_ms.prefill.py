"""ssd_ms.prefill: device milliseconds a sequence in the program's
``ops.mamba2`` spans, every call of the mamba2 kernel op: CUDA events at
the kernel's launch (the program starts a span's device time there, after
the op's checks and buffers) and at the op's exit, summed over the traced
stretch and divided by its forwards (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    return spans.read(run, "ops.mamba2")
