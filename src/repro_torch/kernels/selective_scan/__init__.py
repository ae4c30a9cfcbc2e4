"""Mamba-1 selective scan: CUDA kernels for Hopper, forward
(``csrc/selective_scan.cu``) and backward (``csrc/selective_scan_bwd.cu``),
beside their plain PyTorch versions."""

from .ops import (
    BWD_CHANNELS,
    KERNEL_MAX_STATE,
    SCAN_CHUNK,
    SelectiveScan,
    selective_scan,
    selective_scan_bwd_kernel,
    selective_scan_kernel,
)
from .ref import selective_scan_bwd_ref, selective_scan_ref

__all__ = ["selective_scan", "selective_scan_kernel",
           "selective_scan_bwd_kernel", "SelectiveScan", "selective_scan_ref",
           "selective_scan_bwd_ref", "KERNEL_MAX_STATE", "SCAN_CHUNK",
           "BWD_CHANNELS"]
