from .base import RANK_CHOICES, Accelerator, Slot
from .gaussian import GaussianFilter
from .hevc_dct import HEVCDct, MCMAccelerator
from .lm import LMAccelerator, proj_classes_for

__all__ = [
    "Accelerator", "Slot", "RANK_CHOICES",
    "GaussianFilter", "HEVCDct", "MCMAccelerator", "SmoothedDct",
    "LMAccelerator", "proj_classes_for",
]


def __getattr__(name):
    # lazy: smoothed_dct subclasses repro_torch.hierarchy.StagedPipeline,
    # which itself imports accel.base — a top-level import here would turn
    # that into a cycle whenever repro_torch.hierarchy is imported first
    if name == "SmoothedDct":
        from .smoothed_dct import SmoothedDct

        return SmoothedDct
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
