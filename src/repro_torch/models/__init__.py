"""Model zoo of the port: one module per family, with the reference's
functional API (init / forward / decode_step / init_cache ...)."""
from __future__ import annotations

from types import ModuleType

from . import rwkv6, transformer, zamba2
from .config import SHAPES, ModelConfig, ShapeCell, reduced
from .tree import params_from_numpy

__all__ = ["SHAPES", "ModelConfig", "ShapeCell", "family_module",
           "params_from_numpy", "reduced", "rwkv6", "transformer", "zamba2"]


def family_module(cfg: ModelConfig) -> ModuleType:
    if cfg.family == "rwkv6":
        return rwkv6
    if cfg.family == "zamba2":
        return zamba2
    return transformer  # dense / moe / vlm-backbone / encoder
