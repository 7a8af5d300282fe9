"""mamba_ms.prefill: device milliseconds a sequence in the program's
``zamba2.mamba`` spans, every Mamba layer of a zamba2 forward: its norm,
the mixer (in_proj, conv, the mamba2 kernel op, gated norm, out_proj) and
the residual add; from CUDA events at each span's entry and exit, summed
over the traced stretch and divided by its forwards
(``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    return spans.read(run, "zamba2.mamba")
