"""Dispatching wrapper of the population LUT gather.

On a CUDA tensor it launches ``csrc/population_lut.cu`` on the current
stream (or raises); on a CPU tensor it runs the plain version.  Nothing
falls back from one to the other."""

from __future__ import annotations

import torch

from ... import _build
from .ref import population_lut_gather_ref

__all__ = ["population_lut_gather"]


def population_lut_gather(
    lut: torch.Tensor,     # (C, S, 256) int32
    genes: torch.Tensor,   # (G, S) int32
    cols: torch.Tensor,    # (M, S) or (G, M, S) int32 table indices
    *,
    per_genome: bool = False,
) -> torch.Tensor:
    """(G, M, S) int32 gathered products."""
    if lut.dim() != 3 or lut.shape[2] != 256:
        raise ValueError(f"lut must be (C, S, 256), got {tuple(lut.shape)}")
    C, S, _ = lut.shape
    if genes.dim() != 2 or genes.shape[1] != S:
        raise ValueError(f"genes must be (G, {S}), got {tuple(genes.shape)}")
    G = genes.shape[0]
    want = 3 if per_genome else 2
    if cols.dim() != want or cols.shape[-1] != S or (
            per_genome and cols.shape[0] != G):
        raise ValueError(
            f"cols must be ({'G, ' if per_genome else ''}M, {S}), got "
            f"{tuple(cols.shape)}")
    M = cols.shape[-2]
    devices = {lut.device, genes.device, cols.device}
    if len(devices) != 1:
        raise ValueError(f"lut, genes and cols on different devices: {devices}")
    if lut.device.type == "cpu":
        return population_lut_gather_ref(lut, genes, cols,
                                         per_genome=per_genome)
    if lut.device.type != "cuda":
        raise ValueError(f"unsupported device {lut.device}")
    for t, nm in ((lut, "lut"), (genes, "genes"), (cols, "cols")):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous int32, got {t.dtype}")
    if M * S >= 2 ** 31:
        raise ValueError(f"M * S = {M * S} exceeds the kernel's int32 plane")
    out = torch.empty((G, M, S), dtype=torch.int32, device=lut.device)
    if out.numel() == 0:
        return out
    _build.call("population_lut", lut.device, lut.data_ptr(),
                genes.data_ptr(), cols.data_ptr(), out.data_ptr(), C, S, G, M,
                int(per_genome))
    return out
