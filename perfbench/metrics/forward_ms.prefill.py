"""forward_ms.prefill: device milliseconds a sequence in the program's
``prefill.forward`` spans, the prefill step's forward, whole: embedding,
every block, the final norm and the head, with the card's idle time
between them; from CUDA events at each span's entry and exit, summed over
the traced stretch and divided by its forwards (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    return spans.read(run, "prefill.forward")
