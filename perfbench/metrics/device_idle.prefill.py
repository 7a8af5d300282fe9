"""Share (%) of the traced stretch in which no operation ran on the card:
1 - busy / stretch, the busy time the union of every kernel, copy and fill
of the profiler's trace."""


def read(run):
    return run.idle_pct()
