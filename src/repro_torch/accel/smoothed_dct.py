"""Smoothed DCT: the classic pre-filter + transform image pipeline.

Stage 0 is the paper's motivational 3x3 Gaussian filter (Fig. 1), stage 1
the HEVC 4x4 integer DCT evaluation application (§IV), coupled by the
pipeline's re-quantization: the filtered image is clipped back to the
unsigned 8-bit pixel domain before block extraction (approximate
multipliers can push the weighted sum outside [0, 255]).

The flat joint genome spans 45 slots (9 mul8u + 8 add16 Gaussian, 16
mul8s + 12 add16 DCT); per-stage spaces are the factors of that product.

A population batch runs the whole chain on the device (the coupling's
torch twin is registered below).  Deployment chains the two stages'
rank-k matmuls: the Gaussian's im2col matmul output is renormalized
(>>4), clipped to u8, re-centred and re-blocked into DCT row operands
between them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hierarchy.staged import Coupling, StagedPipeline
from . import fused
from .gaussian import GaussianFilter
from .hevc_dct import HEVCDct

__all__ = ["SmoothedDct"]


def _sim_coupling(y: np.ndarray) -> np.ndarray:
    """Behavioral: filtered image -> u8 pixel domain for block extraction."""
    return np.clip(y, 0, 255)


def _sim_coupling_torch(y: torch.Tensor) -> torch.Tensor:
    """Device twin of ``_sim_coupling`` for the chained population sim."""
    return torch.clamp(y, 0, 255)


fused.register_coupling("u8_clip_reblock", _sim_coupling_torch)


def _deploy_coupling(y: torch.Tensor) -> torch.Tensor:
    """Deployment: Gaussian matmul output (n*windows, 1) -> DCT block rows.

    The Gaussian deploy emits the raw adder-tree accumulation; renormalize
    (>>4 as in the behavioral path), clip to u8, reshape to the filtered
    image, crop to whole 4x4 blocks and emit (n_blocks*4, 4) signed
    residual rows — HEVCDct.build_deploy's activation layout.
    """
    side = 30  # 32x32 input -> 30x30 filtered image
    img = torch.clamp(torch.round(y.reshape(-1, side, side) / 16.0), 0, 255)
    crop = side - side % 4
    x = img[:, :crop, :crop].to(torch.int32) - 128
    n = x.shape[0]
    b = x.reshape(n, crop // 4, 4, crop // 4, 4).permute(0, 1, 3, 2, 4)
    return b.reshape(-1, 4, 4).reshape(-1, 4)


class SmoothedDct(StagedPipeline):
    """Gaussian 3x3 -> HEVC 4x4 DCT staged pipeline."""

    def __init__(self):
        super().__init__(
            "smoothed_dct",
            [GaussianFilter(), HEVCDct()],
            [Coupling(name="u8_clip_reblock",
                      sim=_sim_coupling, deploy=_deploy_coupling)],
        )
