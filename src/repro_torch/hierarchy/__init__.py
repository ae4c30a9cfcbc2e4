"""Multi-stage applications (paper §V, the scalability strategy).

Multi-stage applications (pre-filter -> transform pipelines, chained
kernels) make the flat DSE genome the *product* of the stage spaces.

  * ``staged`` — ``StagedPipeline``: N stage accelerators composed into
                 one ``Accelerator`` (chained population sim on the
                 device, chained rank-k deployment, per-stage
                 re-quantization couplings), plus ``StageView``: one
                 stage exposed as a standalone accelerator whose QoR is
                 measured in situ (all other stages exact).

The JAX package's front composition and hierarchical search
(``compose``, ``search``) are not in this port yet.
"""

from .staged import Coupling, StagedPipeline, StageView

__all__ = ["Coupling", "StagedPipeline", "StageView"]
