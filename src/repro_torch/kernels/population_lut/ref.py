"""Plain PyTorch version of the population LUT gather.

The CPU path of ``ops.population_lut_gather`` and the version the CUDA
kernel is held against on the card (byte-equal)."""

from __future__ import annotations

import torch

__all__ = ["population_lut_gather_ref"]


def population_lut_gather_ref(
    lut: torch.Tensor,
    genes: torch.Tensor,
    cols: torch.Tensor,
    *,
    per_genome: bool = False,
) -> torch.Tensor:
    """``out[g, m, s] = lut[genes[g, s], s, cols[m, s]]``.

    ``lut``: (C, S, 256); ``genes``: (G, S) circuit indices; ``cols``:
    table indices, (M, S) shared across the population or (G, M, S)
    per-genome.  Returns (G, M, S) in ``lut``'s dtype."""
    S = genes.shape[1]
    sl = torch.arange(S, device=lut.device)
    g = genes.long()[:, None, :]
    c = cols.long() if per_genome else cols.long()[None]
    return lut[g, sl, c]
