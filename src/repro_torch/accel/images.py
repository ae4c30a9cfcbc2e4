"""Deterministic synthetic 8-bit test images for QoR evaluation.

The paper evaluates PSNR 'for a set of input signal samples'.  Offline we
generate structured images (gradients + sinusoids + blobs + texture noise)
— smooth enough that PSNR is meaningful, textured enough that truncation
errors show.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sample_images"]


def sample_images(n: int, size: int = 64, seed: int = 0) -> np.ndarray:
    """(n, size, size) uint8-valued int64 array."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size
    out = np.empty((n, size, size), dtype=np.int64)
    for i in range(n):
        fx, fy = rng.uniform(1, 6, size=2)
        phase = rng.uniform(0, 2 * np.pi, size=2)
        img = (
            0.35 * (xx * rng.uniform(-1, 1) + yy * rng.uniform(-1, 1) + 1.0)
            + 0.3 * (np.sin(2 * np.pi * fx * xx + phase[0]) * 0.5 + 0.5)
            + 0.2 * (np.sin(2 * np.pi * fy * yy + phase[1]) * 0.5 + 0.5)
        )
        # blobs
        for _ in range(3):
            cx, cy = rng.uniform(0.2, 0.8, size=2)
            r = rng.uniform(0.05, 0.2)
            img += 0.3 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r))
        img += 0.05 * rng.standard_normal((size, size))
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        out[i] = np.clip(np.round(img * 255), 0, 255).astype(np.int64)
    return out
