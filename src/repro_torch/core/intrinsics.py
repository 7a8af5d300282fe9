"""Hardware intrinsics (paper §II-B, §IV): DOT / GEMV / GEMM / CONV2D.

Each intrinsic is (a) a TST used by the two-step matcher, (b) a binding to a
Pallas TPU kernel in ``repro.kernels`` that implements it, and (c) the set of
hardware parameters that size it (``repro.core.hw_space``).  The intrinsic's
*logical* shape (which the paper fixes to the PE-array shape, e.g. 16×16) maps
on TPU to the MXU block shape of the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

from .tst import TensorExpr, parse

# Loop extents here are symbolic placeholders (the matcher ignores ranges —
# paper: "the matching does not decide the range of each node").
_E = 16

DOT = parse("C[o] = A[i] * B[i]", {"i": _E, "o": 1}, name="DOT")
GEMV = parse("C[i] = A[i,j] * B[j]", {"i": _E, "j": _E}, name="GEMV")
GEMM = parse("L[i,j] = M[i,k] * N[k,j]", {"i": _E, "j": _E, "k": _E}, name="GEMM")
CONV2D = parse(
    "C[k,x,y] = A[c,x+r,y+s] * B[k,c,r,s]",
    {"k": _E, "x": _E, "y": _E, "c": _E, "r": 3, "s": 3},
    name="CONV2D",
)

# NOTE: DOT's output is a scalar; we model it as a 1-extent index ``o`` so the
# TensorExpr machinery is uniform.  The matcher never maps ``o`` because it
# has no leaf occurrence in the body.

ALL_INTRINSICS: dict[str, TensorExpr] = {
    t.name: t for t in (DOT, GEMV, GEMM, CONV2D)
}


@dataclass(frozen=True)
class IntrinsicBinding:
    """How an intrinsic lowers to a TPU kernel."""

    name: str
    kernel: str                    # module in repro.kernels
    # which hardware parameters size the intrinsic call: intrinsic index ->
    # hardware knob ('pe_rows'/'pe_cols'/'pe_depth').  On TPU these become the
    # MXU block dims of the Pallas kernel.
    shape_knobs: tuple[tuple[str, str], ...]
    # dims the intrinsic fixes outright (CONV2D's 3x3 filter, paper §VII-B —
    # the source of its redundant computation on 5x5/7x7 workloads)
    fixed_dims: tuple[tuple[str, int], ...] = ()

    def intrinsic_shape(self, hw) -> dict[str, int]:
        out = {idx: getattr(hw, knob) for idx, knob in self.shape_knobs}
        out.update(dict(self.fixed_dims))
        return out


BINDINGS: dict[str, IntrinsicBinding] = {
    "DOT": IntrinsicBinding("DOT", "dotprod", (("i", "pe_depth"),)),
    "GEMV": IntrinsicBinding("GEMV", "gemv", (("i", "pe_rows"), ("j", "pe_depth"))),
    "GEMM": IntrinsicBinding(
        "GEMM", "gemm", (("i", "pe_rows"), ("j", "pe_cols"), ("k", "pe_depth"))),
    "CONV2D": IntrinsicBinding(
        "CONV2D", "conv2d",
        (("k", "pe_cols"), ("x", "pe_rows"), ("y", "pe_rows"), ("c", "pe_depth")),
        fixed_dims=(("r", 3), ("s", 3))),
}


def intrinsic(name: str) -> TensorExpr:
    return ALL_INTRINSICS[name.upper()]
