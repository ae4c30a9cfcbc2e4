"""The port's data pipeline: a numpy copy of the JAX package's
counter-addressed synthetic token pipeline."""
from .pipeline import TokenPipeline

__all__ = ["TokenPipeline"]
