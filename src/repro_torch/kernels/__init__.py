"""Hand-written Hopper (sm_90a) CUDA kernels for the paper's four hardware
intrinsics, each with a plain PyTorch version in ``ref.py`` and dispatch in
``ops.py``.

  gemm / gemv / dotprod / conv2d — wrappers over ``csrc/*.cu``, built at
                                   first use by ``cuda_lib``

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from . import ops, ref
from .conv2d import conv2d
from .dotprod import dot
from .gemm import gemm
from .gemv import gemv

KERNELS = (gemm, gemv, dot, conv2d)

__all__ = ["KERNELS", "conv2d", "dot", "gemm", "gemv", "ops", "ref"]
