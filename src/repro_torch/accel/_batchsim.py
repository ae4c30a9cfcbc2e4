"""Per-slot lookup stacks for population ("genome-batch") simulation.

Multiplier slots with a constant second operand collapse to a per-slot
256-entry lookup column sliced out of the circuit's exhaustive product
table, so a population evaluates ALL slots of one kind with a single
``(G, m, slots)`` gather into the stacked ``(n_circuits, slots, 256)``
LUT (``kernels.population_lut``).  The LUT is the exhaustive evaluation
of the same behavioural fn, so the gather is bit-exact versus looping
``simulate`` per genome.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.acl.library import Library

__all__ = ["mul_lut"]


def mul_lut(
    library: Library,
    kind: str,
    constants: Sequence[int],
) -> np.ndarray:
    """(n_circuits, n_slots, 256) lookup stack for constant-operand
    multiplier slots: ``lut[c, s, x] == circuits[c].fn(value(x),
    constants[s])`` where ``value(x) = x`` for mul8u and ``x - 128`` for
    mul8s (the product-table index convention)."""
    circuits = library.kind(kind)
    off = 128 if kind == "mul8s" else 0
    cols = [int(c) + off for c in constants]
    return np.stack([c.table[:, cols].T for c in circuits])  # (C, S, 256)
