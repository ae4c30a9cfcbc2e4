"""Architecture registry of the port: the archs whose every layer kind
the port can build.  The JAX package's registry lists more; asking the
port for one of those raises ``KeyError`` saying its family is not
ported yet."""
from importlib import import_module
from typing import Dict, List

_MODULES = {
    "deepseek-67b": "deepseek_67b",
    "gemma-2b": "gemma_2b",
    "chatglm3-6b": "chatglm3_6b",
    "granite-8b": "granite_8b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "jamba-1.5-large-398b": "jamba_15_large",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

# archs of the JAX package's registry that the port cannot build yet,
# with the family that holds each back
_NOT_PORTED = {
    "seamless-m4t-medium": "encdec",
    "qwen2-vl-72b": "vlm",
}

ARCHS: List[str] = list(_MODULES)


def get_config(name: str):
    """Fetch an architecture config by its id (or a unique prefix of a
    ported one, e.g. 'granite')."""
    if name not in _MODULES:
        if name in _NOT_PORTED:
            raise KeyError(
                f"arch {name!r}: family {_NOT_PORTED[name]} is not ported "
                f"yet; ported: {ARCHS}")
        matches = [k for k in _MODULES if k.startswith(name)]
        if len(matches) != 1:
            raise KeyError(f"unknown arch {name!r}; ported: {ARCHS}")
        name = matches[0]
    return import_module(f".{_MODULES[name]}", __package__).CONFIG


def all_configs() -> Dict[str, object]:
    return {k: get_config(k) for k in ARCHS}
