"""gemm_ms.prefill: device milliseconds a sequence in matrix products:
what an aten matrix-product op launched inside the step, outside the
kernel ops' ranges."""
from perfbench.trace import GEMM_OPS, OP, STEP


def read(run):
    return run.per_request_ms(
        lambda o: STEP in o.ranges and o.host_op in GEMM_OPS
        and not any(r.startswith(OP) for r in o.ranges))
