"""Mamba-1 selective scan: a CUDA kernel for Hopper
(``csrc/selective_scan.cu``) beside its plain PyTorch version."""

from .ops import KERNEL_MAX_STATE, selective_scan, selective_scan_kernel
from .ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_kernel", "selective_scan_ref",
           "KERNEL_MAX_STATE"]
