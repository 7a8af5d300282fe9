"""other_ms.prefill: device milliseconds a sequence in everything the step
launched outside the kernel ops' ranges and outside the matrix products:
norms, convolution, gates, casts, copies."""
from perfbench.trace import GEMM_OPS, OP, STEP


def read(run):
    return run.per_request_ms(
        lambda o: STEP in o.ranges and o.host_op not in GEMM_OPS
        and not any(r.startswith(OP) for r in o.ranges))
