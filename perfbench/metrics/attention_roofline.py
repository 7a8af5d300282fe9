"""attention_roofline: the least time the card could take for every call of
``repro_torch.kernels.ops.attention`` in the traced stretch (the larger of
its operations over the peak bf16 rate and its bytes over the peak memory
rate, from the call's shapes, ``counts.py``), over the device time of
what was launched inside the range around those calls, in %."""
from perfbench.counts import bound_s, call_cost
from perfbench.trace import OP

NAME = "attention"


def read(run):
    calls = run.trace.op_calls.get(NAME) if run.trace is not None else None
    if not calls or not run.peak:
        return None
    spent = run.trace.device_s(lambda o: OP + NAME in o.ranges)
    if spent <= 0:
        return None
    bound = sum(bound_s(*call_cost(NAME, args, kw), run.peak)
                for args, kw in calls)
    return 100.0 * bound / spent
