"""The LM stack of the port: dense (llama-arch), mixture-of-experts,
Mamba-1 and hybrid models, with the DSE-selectable approximate
projection."""
from .approx_linear import PROJ_CLASSES, ApproxPolicy, linear
from .config import LayerKind, ModelConfig, reduced
from .transformer import Transformer, init_caches

__all__ = [
    "ModelConfig", "LayerKind", "reduced",
    "ApproxPolicy", "linear", "PROJ_CLASSES",
    "Transformer", "init_caches",
]
