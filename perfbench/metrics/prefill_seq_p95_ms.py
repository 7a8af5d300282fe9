"""prefill_seq_p95_ms: the 95th percentile (exact order statistic) of the
latency of every sequence of the window, submission to log-probabilities
in host memory."""
from perfbench.counts import quantile


def read(run):
    if not run.latencies_s:
        return None
    return 1e3 * quantile(run.latencies_s, 0.95)
