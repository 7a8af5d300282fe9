"""Hand-written Hopper (sm_90a) CUDA kernels: the paper's four hardware
intrinsics, the transformer family's attention and the recurrent families'
WKV6 and SSD recurrences, each with a plain PyTorch version and dispatch in
``ops.py``.

  gemm / gemv / dotprod / conv2d — wrappers over ``csrc/*.cu``, built at
                                   first use by ``cuda_lib``
  flash_attention                — ``csrc/flash_attention.cu`` (a bf16
                                   tensor-core and a float32 SIMT kernel,
                                   picked by ``flash_attention.py::route``);
                                   its plain version is
                                   ``xla_attention.attention``
  rwkv6 / mamba2                 — ``csrc/rwkv6.cu``, ``csrc/mamba2.cu``;
                                   their plain versions are in
                                   ``xla_linear``
  bank_mm                        — ``csrc/bank_mm.cu``: the DQN bank's
                                   per-slot product (port-only: a slot's
                                   bits must not depend on the bank's size)
  rwkv6_glue                     — ``csrc/rwkv6_glue.cu``: the rwkv6
                                   block's elementwise and row-norm work
                                   between its matrix products, six ops
                                   (port-only: the reference leaves it to
                                   XLA's fusion); their plain versions are
                                   in the same module
  mamba2_glue                    — ``csrc/mamba2_glue.cu``: the Zamba2
                                   Mamba layer's elementwise and row-norm
                                   work around its products and the SSD,
                                   three ops (port-only, as rwkv6_glue);
                                   their plain versions are in the same
                                   module
  plain                          — the plain versions on any device, the
                                   ops of a model run with ``impl=plain``

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from . import ops, plain, ref
from .bank_mm import bank_mm
from .conv2d import conv2d
from .dotprod import dot
from .flash_attention import flash_attention
from .gemm import gemm
from .gemv import gemv
from .mamba2 import mamba2
from .mamba2_glue import GLUE as MAMBA2_GLUE
from .rwkv6 import rwkv6
from .rwkv6_glue import GLUE

INTRINSICS = (gemm, gemv, dot, conv2d)
KERNELS = (*INTRINSICS, flash_attention, rwkv6, mamba2, bank_mm, *GLUE,
           *MAMBA2_GLUE)

__all__ = ["GLUE", "INTRINSICS", "KERNELS", "MAMBA2_GLUE", "bank_mm",
           "conv2d", "dot", "flash_attention", "gemm", "gemv", "mamba2",
           "ops", "plain", "ref", "rwkv6"]
