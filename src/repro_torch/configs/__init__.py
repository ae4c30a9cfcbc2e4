"""Architecture registry of the port: every arch of the JAX package's
registry, one module each."""
from importlib import import_module
from typing import Dict, List

_MODULES = {
    "deepseek-67b": "deepseek_67b",
    "gemma-2b": "gemma_2b",
    "chatglm3-6b": "chatglm3_6b",
    "granite-8b": "granite_8b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "jamba-1.5-large-398b": "jamba_15_large",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCHS: List[str] = list(_MODULES)


def get_config(name: str):
    """Fetch an architecture config by its id (or a unique prefix, e.g.
    'jamba')."""
    if name not in _MODULES:
        matches = [k for k in _MODULES if k.startswith(name)]
        if len(matches) != 1:
            raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
        name = matches[0]
    return import_module(f".{_MODULES[name]}", __package__).CONFIG


def all_configs() -> Dict[str, object]:
    return {k: get_config(k) for k in ARCHS}
