"""time_mix_ms.prefill: device milliseconds a sequence in the program's
``rwkv6.time_mix`` spans, the first half of every rwkv6 block: its norm,
the time mix (token shift, projections, decay, the rwkv6 kernel op, group
norm, gate, output projection) and the residual add; from CUDA events at
each span's entry and exit, summed over the traced stretch and divided by
its forwards (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    return spans.read(run, "rwkv6.time_mix")
