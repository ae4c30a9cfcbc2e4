"""The circuit-level Pareto pre-filter of the ApproxFPGAs baseline
(Prabakaran et al., DAC'20): the ACs that are Pareto-optimal *in
isolation* (error vs deployment cost).  ``Campaign`` uses it to
warm-start half of the NSGA-II population."""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.acl.library import Circuit, Library
from ..core.pareto import non_dominated_mask

__all__ = ["circuit_level_front"]


def circuit_level_front(library: Library, kind: str) -> List[Circuit]:
    """Per-circuit Pareto front on (error, TPU deployment cost) —
    error = mae, cost = the dtype-aware MXU deployment cost factor
    (DESIGN.md §9a).  The exact circuit is always on the front."""
    circuits = library.kind(kind)
    obj = np.array(
        [[c.stats.mae,
          (c.deploy_cost_factor() if c.kind != "add16"
           else float(16 - c.carry_window))]
         for c in circuits]
    )
    mask = non_dominated_mask(obj)
    front = [c for c, m in zip(circuits, mask) if m]
    if not any(c.is_exact for c in front):
        front.append(circuits[library.exact_index(kind)])
    return front
