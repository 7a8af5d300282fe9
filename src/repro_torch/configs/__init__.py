"""Architecture registry: one module per assigned architecture
(``--arch <id>`` in the launchers).  The shape-cell registry of the
reference (skips, runnable cells) comes with the dry-run tooling that
uses it."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "deepseek-coder-33b", "deepseek-67b", "qwen3-8b", "gemma2-2b",
    "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "internvl2-76b",
    "rwkv6-3b", "zamba2-2.7b", "hubert-xlarge",
)


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch)}")
    return mod.CONFIG
