"""PyTorch/CUDA port of the Xel-FPGAs reproduction.

A second package beside the JAX reference (``src/repro``): the same
approximate-accelerator labeling and surrogate-guided DSE, and LM
serving (the dense, Mamba, mixture-of-experts and hybrid archs of
``configs``), with the population LUT gather,
the approximate matmuls, the prefill attention and the Mamba scan as
hand-written CUDA kernels for Hopper (``csrc/``, built on first use by
``_build``).  It
imports torch, numpy and scipy only — nothing of JAX and nothing of the
JAX package, whose numpy modules it carries as its own copies under the
same relative paths.

Entry points (``core.dse.run_dse``, ``core.dse.default_labeler``,
``core.features.synth.label_variants``, ``Accelerator.qor_batch`` /
``simulate_batch``, ``launch.serve.serve_batch``,
``models.Transformer``) take ``device``, default ``"cuda"``, and raise
when no GPU is present unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
