"""Re-implementation of the state-of-the-art baseline ApproxFPGAs [15]
(Prabakaran et al., DAC'20), as used for the paper's Figs. 8 and 9.

ApproxFPGAs' strategy (as characterized by the paper §I/§IV):
  1. circuit-level DSE first — identify the ACs that are Pareto-optimal
     *in isolation* on the target platform (error vs hardware cost),
  2. restrict the accelerator search to combinations of those
     pre-filtered ACs,
  3. explore the (much smaller) restricted space.

The paper's criticism — which Figs. 8/9 substantiate — is that per-circuit
pre-filtering 'overlook[s] certain trade-offs that can prove to be
Pareto-optimal for the application'.  We reproduce that behaviour: the
restricted search explores the same budget of variants as autoXFPGAs'
final evaluation but only over the circuit-level Pareto set.
``Campaign`` also uses the pre-filter to warm-start half of the NSGA-II
population.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.acl.library import Circuit, Library, default_library
from ..core.features import synth
from ..core.hw import H100_SXM, Hardware
from ..core.pareto import non_dominated_mask
from ..device import resolve_device
from .base import Accelerator

__all__ = ["circuit_level_front", "restricted_library", "approxfpgas_search"]


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


def restricted_library(library: Optional[Library] = None) -> Library:
    """The ApproxFPGAs-style pre-filtered library."""
    library = library or default_library()
    names: List[str] = []
    for kind in library.by_kind:
        names += [c.name for c in circuit_level_front(library, kind)]
    return library.subset(names)


def approxfpgas_search(
    accel: Accelerator,
    library: Optional[Library] = None,
    *,
    n_budget: int = 200,
    objectives: Tuple[str, ...] = ("qor", "energy"),
    rank_genes: bool = False,
    seed: int = 0,
    qor_inputs: Optional[np.ndarray] = None,
    device=None,
    hw: Hardware = H100_SXM,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Library]:
    """Run the SoA baseline: random exploration of the restricted space
    with full synthesis labels (matching [15]'s final-evaluation budget),
    labeled on ``device`` (default ``"cuda"``) on the cost model ``hw``.

    Returns (genomes, objectives, front_mask, restricted_lib); genomes are
    indices into the *restricted* library."""
    from ..core.dse import _objective_matrix

    dev = resolve_device(device)
    full = library or default_library()
    rlib = restricted_library(full)
    rng = np.random.default_rng(seed)
    gene_sizes = accel.gene_sizes(rlib, rank_genes=rank_genes)
    genomes = rng.integers(0, gene_sizes[None, :], size=(n_budget, len(gene_sizes)))
    labels = synth.label_variants(
        accel, genomes, rlib, rank_genes=rank_genes,
        qor_inputs=qor_inputs, cache={}, device=dev, hw=hw,
    )
    obj = _objective_matrix(labels, objectives)
    return genomes, obj, non_dominated_mask(obj), rlib
