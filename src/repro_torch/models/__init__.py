"""Model zoo of the port: one module per family, with the reference's
functional API (init / forward / decode_step / init_cache ...).  Only the
transformer family is ported; the recurrent families (rwkv6, zamba2) come
with their kernels (ROADMAP A.6)."""
from __future__ import annotations

from types import ModuleType

from . import transformer
from .config import SHAPES, ModelConfig, ShapeCell, reduced

__all__ = ["SHAPES", "ModelConfig", "ShapeCell", "family_module", "reduced",
           "transformer"]


def family_module(cfg: ModelConfig) -> ModuleType:
    if cfg.family in ("rwkv6", "zamba2"):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP A.6)")
    return transformer  # dense / moe / vlm-backbone / encoder
