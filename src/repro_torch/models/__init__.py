"""Model zoo of the port: one module per family, with the reference's
functional API (init / forward / decode_step / init_cache ...)."""
from __future__ import annotations

from types import ModuleType

from . import rwkv6, transformer, zamba2
from .config import SHAPES, ModelConfig, ShapeCell, reduced
from .tree import params_from_numpy

__all__ = ["SHAPES", "ModelConfig", "ShapeCell", "abstract", "family_module",
           "params_from_numpy", "reduced", "rwkv6", "transformer", "zamba2"]


def family_module(cfg: ModelConfig) -> ModuleType:
    if cfg.family == "rwkv6":
        return rwkv6
    if cfg.family == "zamba2":
        return zamba2
    return transformer  # dense / moe / vlm-backbone / encoder


def abstract(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run on fake tensors: the tree it returns
    has the real shapes, dtypes and devices, and no storage behind any
    leaf (the counterpart of ``jax.eval_shape``; a 67B config's params
    take no memory).  Call the family builders with ``device="cpu"``:
    their ``torch.Generator`` refuses the ``meta`` device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return fn(*args, **kwargs)
