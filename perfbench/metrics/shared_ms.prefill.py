"""shared_ms.prefill: device milliseconds a sequence in the program's
``zamba2.shared`` spans, every call of a shared block in a zamba2 forward:
the concatenation with the embedding, the norms, attention (projections,
RoPE, the attention kernel op, output projection), the MLP with the call's
adapter and the call's linear; from CUDA events at each span's entry and
exit, summed over the traced stretch and divided by its forwards
(``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    return spans.read(run, "zamba2.shared")
