"""Quality-of-result metrics.

The paper's QoR is average PSNR of the accelerator's output against the
exact accelerator's output over a set of input samples (images for the
Gaussian filter / HEVC DCT).  The per-genome SSE is taken on the device
(``sse_batch``); the float64 PSNR finish stays on the host so its bits
match the numpy path.  For the LM retarget there are logits-PSNR and
the cross-entropy delta.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["psnr", "psnr_batch", "psnr_from_mse", "psnr_from_sse",
           "sse_batch", "mean_psnr", "ce_delta", "PSNR_CAP"]

# Identical outputs would give +inf PSNR; the paper's plots saturate around
# this value, and a finite cap keeps regression targets well-conditioned.
PSNR_CAP = 100.0


def psnr(ref: np.ndarray, out: np.ndarray, peak: float | None = None) -> float:
    """Peak signal-to-noise ratio in dB; capped at PSNR_CAP for exactness."""
    ref = np.asarray(ref, dtype=np.float64)
    out = np.asarray(out, dtype=np.float64)
    if peak is None:
        peak = float(np.max(np.abs(ref))) or 1.0
    mse = float(np.mean((ref - out) ** 2))
    if mse == 0.0:
        return PSNR_CAP
    return float(min(10.0 * np.log10(peak * peak / mse), PSNR_CAP))


def psnr_from_mse(mse: np.ndarray, peak: float) -> np.ndarray:
    """Final PSNR formula over a per-genome MSE vector (shared by the
    numpy batched path and the device path so both produce the
    same float64 bits from the same MSE)."""
    mse = np.asarray(mse, dtype=np.float64)
    vals = np.full(len(mse), PSNR_CAP, dtype=np.float64)
    nz = mse > 0.0
    vals[nz] = np.minimum(10.0 * np.log10(peak * peak / mse[nz]), PSNR_CAP)
    return vals


def psnr_batch(
    ref: np.ndarray, outs: np.ndarray, peak: float | None = None
) -> np.ndarray:
    """PSNR of a genome-batched output stack against one reference.

    ``outs`` has one leading genome axis over ``ref``'s shape; returns a
    float64 vector of per-genome PSNRs, bit-identical to calling
    ``psnr(ref, outs[g], peak)`` for each g (each genome's MSE reduces
    over the same contiguous block in the same pairwise order)."""
    ref = np.asarray(ref, dtype=np.float64)
    outs = np.asarray(outs, dtype=np.float64)
    if peak is None:
        peak = float(np.max(np.abs(ref))) or 1.0
    d = np.ascontiguousarray(outs - ref[None]) ** 2
    mse = d.reshape(len(outs), -1).mean(axis=1)
    return psnr_from_mse(mse, peak)


def sse_batch(ref: torch.Tensor, outs: torch.Tensor) -> torch.Tensor:
    """Per-genome INTEGER sum of squared errors, on ``outs``' device.

    ``ref``/``outs`` are integer tensors (``outs`` carries the genome
    axis).  The squared error of two bounded integers is an exact int64
    and its int64 sum is exact, so ``sse / count`` on the host
    reproduces ``psnr_batch``'s float64 MSE bit for bit: numpy's pairwise
    float64 sum of exactly-representable integers below 2^53 is
    association-independent, i.e. also the exact integer sum."""
    d = outs.to(torch.int64) - ref.to(torch.int64)[None]
    sq = d * d
    return torch.sum(sq.reshape(sq.shape[0], -1), dim=1, dtype=torch.int64)


def psnr_from_sse(sse: np.ndarray, count: int, peak: float) -> np.ndarray:
    """Host finish of the device-side SSE: same MSE division and the
    shared final formula — bit-identical to ``psnr_batch`` on the same
    outputs (see ``sse_batch``)."""
    mse = np.asarray(sse, dtype=np.float64) / float(count)
    return psnr_from_mse(mse, peak)


def mean_psnr(refs, outs, peak: float | None = None) -> float:
    """Average PSNR over a batch of samples (paper: 'average PSNR ... for a
    set of input signal samples')."""
    vals = [psnr(r, o, peak) for r, o in zip(refs, outs)]
    return float(np.mean(vals))


def ce_delta(logits_ref: np.ndarray, logits_out: np.ndarray, labels: np.ndarray) -> float:
    """Cross-entropy degradation of approximate logits vs exact logits."""

    def ce(logits):
        logits = logits - logits.max(axis=-1, keepdims=True)
        logz = np.log(np.exp(logits).sum(axis=-1))
        n = labels.size
        gold = logits.reshape(n, -1)[np.arange(n), labels.reshape(-1)]
        return float(np.mean(logz.reshape(-1) - gold))

    return ce(np.asarray(logits_out, np.float64)) - ce(np.asarray(logits_ref, np.float64))
