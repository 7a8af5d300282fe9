"""channel_mix_ms.prefill: device milliseconds a sequence in the program's
``rwkv6.channel_mix`` spans, the second half of every rwkv6 block: its
norm, the channel mix (token shift, projections, squared ReLU, sigmoid
gate) and the residual add; from CUDA events at each span's entry and
exit, summed over the traced stretch and divided by its forwards
(``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    return spans.read(run, "rwkv6.channel_mix")
