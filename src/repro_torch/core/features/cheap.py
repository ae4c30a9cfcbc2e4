"""The cheap feature extractor — our ABC [23] analogue.

ABC gives the paper synthesis-free structural statistics (AIG size/depth)
in ~30 ms per design.  Our analogue composes, in closed form and fully
vectorized over whole populations:

  * per-circuit error moments (from the exhaustive tables, precomputed),
    conditioned on the slot's constant operand where one exists
    (error-table column stats — much sharper than full-table stats),
  * per-circuit structural cost proxies (pp rows, truncation bits, carry
    window, effective rank),
  * accelerator-level composition: weighted error-moment propagation
    through the slot graph plus the rank-cost model
    cost = sum_groups (1 + rank_g)  (DESIGN.md §2).

Per-variant cost is a few microseconds amortized — reported next to the
paper's 30 ms in the Fig. 5 benchmark.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # avoid circular import
    from ...accel.base import Accelerator
from ...core.acl.library import Circuit, Library

__all__ = [
    "circuit_features_cheap",
    "column_error_stats",
    "variant_features",
    "CHEAP_AC_DIM",
]

CHEAP_AC_DIM = 12  # per-circuit cheap feature dim (see circuit_features_cheap)


@functools.lru_cache(maxsize=4096)
def _column_stats_cached(circuit_name: str, const: int, lib_id: int):
    from ...core.acl.library import default_library

    lib = default_library()
    c = lib[circuit_name]
    col = const + 128 if c.signed else const
    e = c.etab[:, col].astype(np.float64)
    ax = np.arange(-128, 128) if c.signed else np.arange(256)
    exact = ax * const
    denom = np.maximum(np.abs(exact), 1.0)
    return np.array(
        [
            e.mean(),
            np.abs(e).mean(),
            (e**2).mean(),
            np.abs(e).max(),
            (e != 0).mean(),
            (np.abs(e) / denom).mean(),
            (e**2).mean() - e.mean() ** 2,
        ]
    )


def column_error_stats(c: Circuit, const: Optional[int]) -> np.ndarray:
    """Error stats of circuit `c` conditioned on second operand == const
    (falls back to full-table stats for variable-operand slots)."""
    if const is None or c.kind == "add16":
        return c.error_features
    return _column_stats_cached(c.name, int(const), 0)


def circuit_features_cheap(c: Circuit) -> np.ndarray:
    """Per-circuit ABC-analogue feature vector (CHEAP_AC_DIM,):
    [me, mae, log10(1+mse), wce, ep, mre, sqrt(var),
     pp_rows, trunc_bits, carry_window, deploy_rank, deploy_cost]."""
    s = c.stats
    cost = c.deploy_cost_factor() if c.kind != "add16" else 0.0
    return np.array(
        [
            s.me,
            s.mae,
            np.log10(1.0 + s.mse),
            s.wce,
            s.ep,
            s.mre,
            np.sqrt(max(s.var, 0.0)),
            float(c.pp_rows),
            float(c.trunc_bits),
            float(c.carry_window),
            float(c.deploy_rank),
            cost,
        ]
    )


def _rank_used(c: Circuit, rank: Optional[int]) -> int:
    if c.kind == "add16":
        return 0
    if rank is None:
        return c.eff_rank
    return min(int(rank), 16)


def variant_features(
    accel: Accelerator,
    genomes: np.ndarray,
    library: Library,
    *,
    ac_features: Optional[np.ndarray] = None,   # optional per-(kind,idx) table
    accel_level: bool = True,
    rank_genes: bool = False,
) -> np.ndarray:
    """(n_variants, d) feature matrix.

    ``ac_features``: dict-free composition table — a {kind: (n_circ, d_ac)}
    mapping (built by the pipeline from cheap or synth per-AC features).
    If given, the composed block is sum / max pooling of per-slot rows.
    ``accel_level``: include the accelerator-level analytic block
    (column-conditional error composition + rank-cost model) — the thing
    pipelines D/E/F add.
    """
    from ...accel.base import RANK_CHOICES  # lazy: avoid circular import

    genomes = np.atleast_2d(np.asarray(genomes, dtype=np.int64))
    n = genomes.shape[0]
    slots = accel.slots
    n_slots = len(slots)
    mul_idx = accel.mul_slot_indices()
    consts = accel.mul_slot_constants()

    blocks: List[np.ndarray] = []

    # --- block 1: composed per-AC features (pipelines B/C/D/E) ------------
    if ac_features is not None:
        per_kind = {}
        for kind, table in ac_features.items():
            per_kind[kind] = np.asarray(table, dtype=np.float64)
        comp_sum = np.zeros((n, next(iter(per_kind.values())).shape[1]))
        comp_max = np.zeros_like(comp_sum)
        for i, s in enumerate(slots):
            rows = per_kind[s.kind][genomes[:, i]]
            comp_sum += rows * s.weight
            comp_max = np.maximum(comp_max, rows)
        blocks += [comp_sum, comp_max]

    # --- block 2: accelerator-level analytic features ---------------------
    if accel_level:
        me = np.zeros(n)
        mae = np.zeros(n)
        var = np.zeros(n)
        wce = np.zeros(n)
        ep = np.zeros(n)
        mre = np.zeros(n)
        add_mae = np.zeros(n)
        add_me = np.zeros(n)
        # per-slot gathered stats (vectorized over population via fancy
        # indexing into a per-slot stats matrix)
        for j, i in enumerate(mul_idx):
            kind = slots[i].kind
            circuits = library.kind(kind)
            stats = np.stack(
                [column_error_stats(c, consts[j]) for c in circuits]
            )  # (n_circ, 7)
            rows = stats[genomes[:, i]]
            me += rows[:, 0]
            mae += rows[:, 1]
            var += rows[:, 6]
            wce = np.maximum(wce, rows[:, 3])
            ep += rows[:, 4]
            mre += rows[:, 5]
        for i, s in enumerate(slots):
            if s.kind != "add16":
                continue
            circuits = library.kind(s.kind)
            stats = np.stack([c.error_features for c in circuits])
            rows = stats[genomes[:, i]]
            add_me += rows[:, 0]
            add_mae += rows[:, 1]

        # rank-cost model: matmul count multiplier sum_groups (1 + rank_g),
        # distinct circuit count, total correction rank
        ranks = np.zeros((n, len(mul_idx)), dtype=np.int64)
        for j, i in enumerate(mul_idx):
            kind = slots[i].kind
            circuits = library.kind(kind)
            native = np.array(
                [c.native_width is not None for c in circuits], dtype=bool
            )[genomes[:, i]]
            if rank_genes:
                rank_gene = genomes[:, n_slots + j]
                eff = np.array([c.deploy_rank for c in circuits])[genomes[:, i]]
                chosen = np.array(
                    [
                        eff[t] if RANK_CHOICES[rank_gene[t]] is None
                        else RANK_CHOICES[rank_gene[t]]
                        for t in range(n)
                    ]
                )
            else:
                chosen = np.array([c.deploy_rank for c in circuits])[genomes[:, i]]
            exact_mask = np.array(
                [c.is_exact for c in circuits], dtype=bool
            )[genomes[:, i]]
            ranks[:, j] = np.where(exact_mask | native, 0, chosen)

        total_rank = ranks.sum(axis=1)
        matmul_mult = (1.0 + ranks).sum(axis=1) / max(len(mul_idx), 1)
        distinct = np.array(
            [len(set(map(tuple, zip(g[mul_idx], ranks[t])))) for t, g in
             enumerate(genomes)],
            dtype=np.float64,
        )
        blocks.append(
            np.stack(
                [
                    me, mae, np.sqrt(np.maximum(var, 0)), wce,
                    ep, mre, add_me, add_mae,
                    total_rank.astype(np.float64),
                    matmul_mult,
                    distinct,
                ],
                axis=1,
            )
        )

    if not blocks:
        raise ValueError("no feature blocks selected")
    return np.concatenate(blocks, axis=1)
