# The DSE core: acl (circuit library), features (cheap extraction,
# synthesis labels, pipelines), surrogates, nsga2/pareto/dse (the
# search), hw (the H100 and v5e roofline cost models of the labels),
# qor (PSNR).
#
# NOTE: dse/features are imported lazily (import repro_torch.core.dse) to
# avoid a circular import with repro_torch.accel, which depends on
# repro_torch.core.acl.
from . import hw, pareto, qor
from .nsga2 import NSGA2Config, nsga2

__all__ = ["hw", "pareto", "qor", "NSGA2Config", "nsga2"]
