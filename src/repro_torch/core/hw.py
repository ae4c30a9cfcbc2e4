"""TPU v5e hardware constants and the three-term roofline model.

These constants are the COST MODEL the ``latency`` and ``energy`` labels
are computed from (``core.features.synth``); they are not a measurement
of the card the port runs on.  Keeping the same model keeps the labels
comparable with the JAX package's.

The paper's DSE optimizes (QoR, power, LUTs, delay) on a Xilinx FPGA.  Our
retarget optimizes (QoR, energy, latency, HBM bytes) on a TPU v5e pod
(DESIGN.md §2).  All absolute constants are documented here; Pareto
orderings only depend on them through ratios, and the §Roofline deliverable
uses exactly these numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

__all__ = [
    "TPUv5e",
    "V5E",
    "RooflineTerms",
    "roofline",
]


@dataclass(frozen=True)
class TPUv5e:
    """Per-chip constants (from the assignment brief + public v5e specs)."""

    peak_bf16_flops: float = 197e12   # FLOP/s per chip
    peak_int8_ops: float = 394e12     # MXU int8 = 2x bf16
    peak_int4_ops: float = 788e12     # int4 = 4x bf16 (projected)
    hbm_bw: float = 819e9             # bytes/s per chip
    ici_bw: float = 50e9              # bytes/s per link (assignment constant)
    hbm_bytes: float = 16e9           # capacity per chip

    def dtype_cost_factor(self, width_bits: int) -> float:
        """Relative compute cost per MAC vs bf16 (v5e widens throughput at
        narrow widths; only power-of-two widths are native)."""
        if width_bits <= 4:
            return self.peak_bf16_flops / self.peak_int4_ops
        if width_bits <= 8:
            return self.peak_bf16_flops / self.peak_int8_ops
        return 1.0

    # Energy model (J) — order-of-magnitude literature values; used for the
    # paper's "power" objective analogue.  Consistency matters, absolutes
    # don't (DESIGN.md §2).
    e_flop: float = 0.3e-12           # J per bf16 FLOP
    e_hbm_byte: float = 15e-12        # J per HBM byte
    e_ici_byte: float = 30e-12        # J per ICI byte


V5E = TPUv5e()


@dataclass(frozen=True)
class RooflineTerms:
    """The three §Roofline terms, in seconds per executed step (per chip),
    plus the derived energy (J) and bottleneck label."""

    t_compute: float
    t_memory: float
    t_collective: float
    flops: float              # per-device HLO FLOPs
    hbm_bytes: float          # per-device HLO bytes accessed
    coll_bytes: float         # per-device collective bytes on the wire

    @property
    def t_step(self) -> float:
        # Optimistic (fully-overlapped) execution: max of the three rails.
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_serial(self) -> float:
        # Pessimistic (no overlap) execution.
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def energy(self) -> float:
        return (
            self.flops * V5E.e_flop
            + self.hbm_bytes * V5E.e_hbm_byte
            + self.coll_bytes * V5E.e_ici_byte
        )

    def as_dict(self) -> Dict[str, float]:
        return {
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "t_step": self.t_step,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "energy": self.energy,
            "bottleneck": self.bottleneck,
        }


def roofline(
    flops: float,
    hbm_bytes: float,
    coll_bytes: float,
    *,
    hw: TPUv5e = V5E,
) -> RooflineTerms:
    """Three-term roofline from *per-device* FLOPs / HBM bytes / wire bytes.

    compute    = FLOPs / peak;  memory = bytes / HBM bw;
    collective = wire bytes / ICI link bw  (per assignment definition).
    """
    return RooflineTerms(
        t_compute=flops / hw.peak_bf16_flops,
        t_memory=hbm_bytes / hw.hbm_bw,
        t_collective=coll_bytes / hw.ici_bw,
        flops=flops,
        hbm_bytes=hbm_bytes,
        coll_bytes=coll_bytes,
    )
