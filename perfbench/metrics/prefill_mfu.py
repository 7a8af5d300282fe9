"""prefill_mfu: model FLOPs of the window's sequences over the window's
seconds, as a share (%) of the card's peak bf16 rate: 2 FLOPs a matrix
weight and token (a weight that a token meets at several calls counted at
each, the head once, the embedding's gather not at all), plus attention
over causal pairs and the recurrences' operations, all from the
benchmark's own counts (``perfbench/counts.py``)."""


def read(run):
    return run.mfu_pct()
