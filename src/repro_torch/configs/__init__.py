"""Architecture registry: the 10 assigned configs + the GNN case study.

A copy of ``repro/configs`` (pure data): the same names, the same
configs and smoke configs.

``get_config(arch)`` / ``get_smoke_config(arch)`` / ``ARCHS``.
"""
from importlib import import_module

_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "granite-20b": "granite_20b",
    "qwen2-1.5b": "qwen2_1_5b",
    "smollm-135m": "smollm_135m",
    "deepseek-67b": "deepseek_67b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "dbrx-132b": "dbrx_132b",
    "zamba2-2.7b": "zamba2_2_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return import_module(f".{_MODULES[arch]}", __package__).CONFIG


def get_smoke_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return import_module(f".{_MODULES[arch]}", __package__).smoke_config()
