"""Deterministic synthetic token pipeline, a numpy copy of the JAX
package's ``data/pipeline.py``: the batches are byte-equal for every
``(seed, step, row)``.

Every (seed, step, row) is independently addressable: any host can
recompute any shard of any batch without coordination.  On a restart
from step k the batches are regenerated exactly, so there is no data
state to checkpoint.

Sequences are learnable-but-nontrivial: each row is a noisy modular
arithmetic progression (next = prev + stride mod V, per-row stride), so
small models show decreasing loss within a few hundred steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

__all__ = ["TokenPipeline"]


def _row_rng(seed: int, step: int, row: int) -> np.random.Generator:
    # Philox is counter-based: cheap keyed access, no sequential state
    return np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, step, row]))


@dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    noise: float = 0.05

    def row(self, step: int, r: int) -> np.ndarray:
        rng = _row_rng(self.seed, step, r)
        v = self.vocab_size
        start = int(rng.integers(0, v))
        stride = int(rng.integers(1, min(v, 97)))
        seq = (start + stride * np.arange(self.seq_len + 1)) % v
        flips = rng.random(self.seq_len + 1) < self.noise
        seq = np.where(flips, rng.integers(0, v, self.seq_len + 1), seq)
        return seq.astype(np.int32)

    def batch_at(
        self, step: int, *, rows: Optional[range] = None
    ) -> Dict[str, np.ndarray]:
        """Full global batch (or the given row range for one host's shard)."""
        rows = rows if rows is not None else range(self.batch)
        data = np.stack([self.row(step, r) for r in rows])
        return {"tokens": data[:, :-1], "labels": data[:, 1:]}
