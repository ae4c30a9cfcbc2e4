from .base import RANK_CHOICES, Accelerator, Slot
from .gaussian import GaussianFilter

__all__ = ["Accelerator", "Slot", "RANK_CHOICES", "GaussianFilter"]
