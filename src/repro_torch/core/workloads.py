"""Benchmark tensor computations (paper Table I) and workload sets.

A *workload* is a TensorExpr with concrete extents.  A *workload set* is what
an application provides: many workloads sharing one co-designed accelerator
(paper §III).  The CNN sets mirror the paper's ResNet-50 / MobileNet /
Xception convolution collections (representative layer shapes from the
published architectures).
"""
from __future__ import annotations

from .tst import TensorExpr, parse


def gemm(i: int, j: int, k: int, name: str = "") -> TensorExpr:
    return parse("L[i,j] = M[i,k] * N[k,j]", {"i": i, "j": j, "k": k},
                 name=name or f"GEMM_{i}x{j}x{k}")


def gemv(i: int, j: int, name: str = "") -> TensorExpr:
    return parse("C[i] = A[i,j] * B[j]", {"i": i, "j": j},
                 name=name or f"GEMV_{i}x{j}")


def dot(i: int, name: str = "") -> TensorExpr:
    """Scalar dot product; the 1-extent output index keeps the TensorExpr
    machinery uniform (mirrors the DOT intrinsic's TST)."""
    return parse("C[o] = A[i] * B[i]", {"i": i, "o": 1},
                 name=name or f"DOT_{i}")


def conv2d(k: int, c: int, x: int, y: int, r: int = 3, s: int = 3,
           name: str = "") -> TensorExpr:
    return parse("C[k,x,y] = A[c,x+r,y+s] * B[k,c,r,s]",
                 {"k": k, "c": c, "x": x, "y": y, "r": r, "s": s},
                 name=name or f"CONV_{k}x{c}x{x}x{y}_{r}x{s}")


def ttm(i: int, j: int, k: int, l: int, name: str = "") -> TensorExpr:
    return parse("C[i,j,k] = A[i,j,l] * B[l,k]",
                 {"i": i, "j": j, "k": k, "l": l},
                 name=name or f"TTM_{i}x{j}x{k}x{l}")


def mttkrp(i: int, j: int, k: int, l: int, name: str = "") -> TensorExpr:
    return parse("D[i,j] = A[i,k,l] * B[l,j] * C[k,j]",
                 {"i": i, "j": j, "k": k, "l": l},
                 name=name or f"MTTKRP_{i}x{j}x{k}x{l}")


def mttkrp_stages(i: int, j: int, k: int, l: int, name: str = "") -> list[TensorExpr]:
    """Paper §VII-B: MTTKRP as two stages ``E[i,k,j] = Σ_l A[i,k,l]·B[l,j]``
    and ``D[i,j] = Σ_k E[i,k,j]·C[k,j]``.  Only stage 1 admits GEMM
    sub-workloads; GEMV benefits both stages."""
    base = name or f"MTTKRP_{i}x{j}x{k}x{l}"
    s1 = parse("E[i,k,j] = A[i,k,l] * B[l,j]",
               {"i": i, "j": j, "k": k, "l": l}, name=f"{base}_s1")
    s2 = parse("D[i,j] = E[i,k,j] * C[k,j]",
               {"i": i, "j": j, "k": k}, name=f"{base}_s2")
    return [s1, s2]


# ---------------------------------------------------------------------------
# Table I: ten workloads per computation, spanning the paper's compute range.
# ---------------------------------------------------------------------------

def table1_gemm() -> list[TensorExpr]:
    sizes = [(32, 16, 16), (64, 64, 64), (128, 128, 64), (256, 128, 128),
             (256, 256, 256), (512, 256, 256), (512, 512, 512),
             (1024, 512, 512), (1024, 1024, 512), (1024, 1024, 1024)]
    return [gemm(*s, name=f"gemm_w{n}") for n, s in enumerate(sizes)]


def table1_ttm() -> list[TensorExpr]:
    sizes = [(32, 32, 16, 16), (64, 32, 32, 32), (64, 64, 64, 32),
             (128, 64, 64, 64), (128, 128, 64, 64), (128, 128, 128, 64),
             (256, 128, 128, 64), (256, 256, 128, 64), (256, 256, 256, 64),
             (512, 256, 256, 64)]
    return [ttm(*s, name=f"ttm_w{n}") for n, s in enumerate(sizes)]


def table1_mttkrp() -> list[TensorExpr]:
    sizes = [(64, 32, 32, 32), (64, 64, 64, 32), (128, 64, 64, 64),
             (128, 128, 64, 64), (128, 128, 128, 64), (256, 128, 128, 64),
             (256, 256, 128, 64), (256, 256, 256, 64), (512, 256, 256, 64),
             (512, 512, 256, 64)]
    return [mttkrp(*s, name=f"mttkrp_w{n}") for n, s in enumerate(sizes)]


def table1_conv() -> list[TensorExpr]:
    sizes = [(64, 64, 56, 56, 3, 3), (64, 64, 56, 56, 1, 1),
             (128, 128, 28, 28, 3, 3), (256, 128, 28, 28, 3, 3),
             (256, 256, 14, 14, 3, 3), (512, 256, 14, 14, 3, 3),
             (512, 512, 7, 7, 3, 3), (32, 16, 112, 112, 3, 3),
             (96, 32, 56, 56, 5, 5), (192, 96, 28, 28, 7, 7)]
    return [conv2d(*s, name=f"conv_w{n}") for n, s in enumerate(sizes)]


# ---------------------------------------------------------------------------
# CNN workload sets (paper §VII-D/E): convolution layers of ResNet-50,
# MobileNet-v1 and Xception, by (k=out_ch, c=in_ch, x=y=spatial, r=s=filter).
# Strided layers are folded to their output spatial size.
# ---------------------------------------------------------------------------

_RESNET50 = [
    (64, 3, 112, 7), (64, 64, 56, 1), (64, 64, 56, 3), (256, 64, 56, 1),
    (128, 256, 28, 1), (128, 128, 28, 3), (512, 128, 28, 1),
    (256, 512, 14, 1), (256, 256, 14, 3), (1024, 256, 14, 1),
    (512, 1024, 7, 1), (512, 512, 7, 3), (2048, 512, 7, 1),
]

_MOBILENET = [
    (32, 3, 112, 3), (64, 32, 112, 1), (128, 64, 56, 1), (128, 128, 56, 1),
    (256, 128, 28, 1), (256, 256, 28, 1), (512, 256, 14, 1),
    (512, 512, 14, 1), (1024, 512, 7, 1), (1024, 1024, 7, 1),
]

_XCEPTION = [
    (32, 3, 149, 3), (64, 32, 147, 3), (128, 64, 74, 1), (128, 128, 74, 3),
    (256, 128, 37, 1), (256, 256, 37, 3), (728, 256, 19, 1),
    (728, 728, 19, 3), (1024, 728, 10, 3), (1536, 1024, 10, 3),
    (2048, 1536, 10, 3),
]


def cnn_set(name: str) -> list[TensorExpr]:
    table = {"resnet": _RESNET50, "mobilenet": _MOBILENET,
             "xception": _XCEPTION}[name.lower()]
    return [conv2d(k, c, x, x, r, r, name=f"{name}_l{n}")
            for n, (k, c, x, r) in enumerate(table)]


def xception_ground_truth() -> list[TensorExpr]:
    """The six Xception convolutions (86.7—454.2 MOPs) used as the hardware
    DSE ground-truth workloads (paper §VII-C)."""
    return [conv2d(k, c, x, x, r, r, name=f"xc_gt{n}") for n, (k, c, x, r)
            in enumerate([(128, 64, 74, 1), (128, 128, 74, 3), (256, 128, 37, 1),
                          (256, 256, 37, 3), (728, 256, 19, 1), (728, 728, 19, 3)])]
