"""host_enqueue_ms.prefill: host milliseconds from calling the prefill
step to its return (before the client waits for the card), the mean over
the window's sequences; read from the untraced window."""


def read(run):
    if not run.enqueue_s:
        return None
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s)
