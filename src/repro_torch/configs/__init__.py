"""Assigned-architecture registry: one module per arch, exact public configs
(the port's own copy of ``repro/configs``; the configs are data).

``get_config(name)`` returns the full :class:`ArchConfig`;
``get_config(name).reduced()`` is the CPU smoke-test variant.
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "llama_3_2_vision_90b",
    "starcoder2_7b",
    "stablelm_3b",
    "internlm2_20b",
    "yi_9b",
    "moonshot_v1_16b_a3b",
    "deepseek_v3_671b",
    "jamba_1_5_large_398b",
    "seamless_m4t_large_v2",
    "rwkv6_7b",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def canonical(name: str) -> str:
    name = name.replace(".", "_")
    if name in ARCH_IDS:
        return name
    if name in _ALIASES:
        return _ALIASES[name]
    raise KeyError(f"unknown architecture {name!r}; known: {list(ARCH_IDS)}")


def get_config(name: str):
    mod = importlib.import_module(f".{canonical(name)}", __name__)
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
