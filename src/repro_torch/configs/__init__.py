"""Assigned-architecture registry.

Every architecture from the assignment pool is a module exporting CONFIG;
``get_config(arch_id)`` resolves by id (dashes or underscores accepted).
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "internvl2-2b",
    "granite-20b",
    "whisper-tiny",
    "kimi-k2-1t-a32b",
    "qwen2.5-32b",
    "qwen3-0.6b",
    "jamba-v0.1-52b",
    "mamba2-780m",
    "deepseek-moe-16b",
    "granite-3-2b",
    "paper-small",        # the paper's own scale (tiny transformer)
)


def _modname(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str):
    arch_id = arch_id.replace("_", "-")
    if arch_id not in ARCH_IDS:
        # tolerate dots encoded as dashes (qwen2.5 -> qwen2-5)
        alt = {a.replace(".", "-"): a for a in ARCH_IDS}
        if arch_id in alt:
            arch_id = alt[arch_id]
        else:
            raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_modname(arch_id)}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS if a != "paper-small"}
