"""Hand-written Hopper (sm_90a) CUDA kernels: the paper's four hardware
intrinsics and the transformer family's attention, each with a plain
PyTorch version and dispatch in ``ops.py``.

  gemm / gemv / dotprod / conv2d — wrappers over ``csrc/*.cu``, built at
                                   first use by ``cuda_lib``
  flash_attention                — ``csrc/flash_attention.cu``; its plain
                                   version is ``xla_attention.attention``

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from . import ops, ref
from .conv2d import conv2d
from .dotprod import dot
from .flash_attention import flash_attention
from .gemm import gemm
from .gemv import gemv

INTRINSICS = (gemm, gemv, dot, conv2d)
KERNELS = (*INTRINSICS, flash_attention)

__all__ = ["INTRINSICS", "KERNELS", "conv2d", "dot", "flash_attention",
           "gemm", "gemv", "ops", "ref"]
