from . import cheap, pipelines, synth
from .cheap import circuit_features_cheap, variant_features
from .pipelines import PIPELINES, build_extractor, evaluate_pipeline
from .synth import label_variants, synthesize_batch

__all__ = [
    "cheap", "synth", "pipelines",
    "circuit_features_cheap", "variant_features",
    "label_variants", "synthesize_batch",
    "PIPELINES", "build_extractor", "evaluate_pipeline",
]
