"""The plain versions of the model-path kernels, on any device: the ops a
model runs when given ``impl=plain`` (``ops`` dispatch takes 'torch' on CPU
tensors only).  On the card they are the yardstick the kernels' path is
compared with, one model forward against the other."""
from .xla_attention import attention
from .xla_linear import mamba2, rwkv6

__all__ = ["attention", "mamba2", "rwkv6"]
