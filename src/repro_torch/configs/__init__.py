"""Architecture registry: one module per assigned architecture
(``--arch <id>`` in the launchers), and the shape-cell registry the dry
run and the roofline walk: which (arch, shape) cells run and why the
others are skipped (DESIGN.md §5: 31 runnable cells and 9 skips)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig

ARCH_IDS = (
    "deepseek-coder-33b", "deepseek-67b", "qwen3-8b", "gemma2-2b",
    "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "internvl2-76b",
    "rwkv6-3b", "zamba2-2.7b", "hubert-xlarge",
)
# every config ``get_config`` knows: the assigned architectures (the shape
# cells, the dry run, the analysis walk them), then the benchmark's
MODEL_IDS = ARCH_IDS + ("zamba2-7b",)


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    if arch not in MODEL_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {MODEL_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch)}")
    return mod.CONFIG


# ---------------------------------------------------------------------------
# Shape-cell applicability (DESIGN.md §5: 31 runnable cells + 9 skips)
# ---------------------------------------------------------------------------

_SKIPS: dict[tuple[str, str], str] = {}
for _a in ("deepseek-coder-33b", "deepseek-67b", "qwen3-8b", "internvl2-76b"):
    _SKIPS[(_a, "long_500k")] = "pure full attention (quadratic context)"
_SKIPS[("gemma2-2b", "long_500k")] = \
    "global layers in the local/global alternation are full attention"
for _a in ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b"):
    _SKIPS[(_a, "long_500k")] = "full-attention MoE"
_SKIPS[("hubert-xlarge", "long_500k")] = "encoder-only: no autoregressive step"
_SKIPS[("hubert-xlarge", "decode_32k")] = "encoder-only: no autoregressive step"


def cell_skip_reason(arch: str, shape: str) -> str | None:
    return _SKIPS.get((arch, shape))


def runnable_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES
            if (a, s) not in _SKIPS]


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
