"""prefill_tokens_per_s: every token of every sequence scored in the
window, over the window's seconds (its first submission to its last
answer on the host)."""


def read(run):
    return run.tokens / run.window_s if run.window_s else None
