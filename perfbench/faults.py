"""What is put in the program's place under a cell's timed path, for the
readings that a check's limits are set from (``calibrate.py``) and the
tests that show the check catches it.  No benchmark run uses one.

Each is ``fault(step, cell) -> step``: it takes the program's step
function and the cell (``cell.ref``, ``cell.model``, ``cell.spec``,
``cell.seed``, ``cell.device``) and returns the function the window
drives instead.

* ``CONTROL``: the plain reference in the program's place, computed in
  the precision below the configuration's bf16: every matrix product's
  operands rounded to float8 e4m3.
* ``PREFILL``, the faults a prefill cell can have: the tokens altered on
  their way into the forward; one position's answer altered where it is
  produced.  A step that keeps no state, a batch of one row and one card
  leave no other.
* ``LOCAL``, read for what the check cannot see: the recurrence kernel
  wrong over one of its chunks, in the middle layer or the last.
"""
from __future__ import annotations

# the program's kernel op that runs each family's recurrence
RECURRENCE = {"rwkv6": "rwkv6"}
SPAN = 16                      # the rwkv6 kernel's chunk


def control(step, cell):
    """The reference's logits with float8 matrix products, on weights
    drawn again from the seed; the program's weights are not read."""
    import torch

    from perfbench import weights
    from perfbench.reference import common as C

    wref = weights.make(cell.spec, cell.seed, cell.device)

    def lower(params, batch):
        with torch.no_grad(), C.no_tf32():
            return torch.stack([
                cell.ref.forward(wref, cell.model, row, mm=C.mm_fp8)
                for row in batch["tokens"]])
    return lower


def prefill_token(step, cell):
    """The forward reads every token moved to the next id (an off-by-one
    where the ids are produced); the client scores the ids it sent."""
    def broken(params, batch):
        top = int(batch["tokens"].max()) + 1
        return step(params, {**batch,
                             "tokens": (batch["tokens"] + 1) % top})
    return broken


def prefill_answer(step, cell):
    """One position's logits: a wrong token's raised by 30."""
    def broken(params, batch):
        logits = step(params, batch).clone()
        t = logits.shape[1] // 3
        wrong = (batch["tokens"][:, t + 1] + 1) % logits.shape[-1]
        logits[:, t].scatter_add_(
            -1, wrong[:, None],
            logits.new_full((logits.shape[0], 1), 30.0))
        return logits
    return broken


def prefill_span(step, cell, last=False):
    """The middle layer's (or the last layer's) call of the recurrence op
    returns its output zeroed over ``SPAN`` positions in the middle of
    the sequence, its final state right: a kernel wrong at a few
    positions."""
    from repro_torch.kernels import ops

    name = RECURRENCE[cell.model["family"]]
    n = cell.model["n_layers"]
    target = n - 1 if last else n // 2

    def broken(params, batch):
        real, calls = getattr(ops, name), []

        def wrong(*args, **kwargs):
            y, state = real(*args, **kwargs)
            if len(calls) == target:
                t = y.shape[1] // 2
                y = y.clone()
                y[:, t:t + SPAN] = 0
            calls.append(1)
            return y, state
        setattr(ops, name, wrong)
        try:
            return step(params, batch)
        finally:
            setattr(ops, name, real)
    return broken


def prefill_span_last(step, cell):
    return prefill_span(step, cell, last=True)


CONTROL = control
PREFILL = {"token": prefill_token, "answer": prefill_answer}
LOCAL = {"span": prefill_span, "span_last": prefill_span_last}
