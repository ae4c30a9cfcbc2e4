"""Hardware constants and the three-term roofline model.

These constants are the COST MODEL the ``latency`` and ``energy`` labels
are computed from (``core.features.synth``); they are not a measurement.

* ``H100_SXM`` (the default) is the card the port runs on: NVIDIA H100
  SXM at its 700 W power limit, rates from NVIDIA's data sheet (dense,
  without sparsity), energies per operation and per byte from published
  figures.  Time is charged at the rate of the unit a width runs on
  (``dtype_cost_factor``), energy at the operand's own width
  (``energy_factor``).
* ``V5E`` is the JAX package's cost model (TPU v5e), kept so that the
  port's labels can be made comparable with the JAX package's: pass
  ``hw=V5E`` and ``energy`` is bit-identical to the reference's.  Its
  numbers are the reference's, not the port's.

The paper's DSE optimizes (QoR, power, LUTs, delay) on a Xilinx FPGA;
this retarget optimizes (QoR, energy, latency, HBM bytes) on an
accelerator's matrix units.  Pareto orderings depend on the constants
only through ratios.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Union

__all__ = [
    "H100",
    "H100_SXM",
    "TPUv5e",
    "V5E",
    "HW_MODELS",
    "hw_name",
    "RooflineTerms",
    "roofline",
]


# Energy per operation, 45 nm at 0.9 V: M. Horowitz, "Computing's energy
# problem (and what we can do about it)", ISSCC 2014.  The card's own
# process is smaller; only the ratios of these figures enter a Pareto
# ordering.
_E_MUL8 = 0.2e-12     # J, 8-bit integer multiply
_E_ADD32 = 0.1e-12    # J, 32-bit integer add (an int8 MAC's accumulate)
_E_MUL16F = 1.1e-12   # J, 16-bit float multiply (a bf16 MAC's multiply)
_E_ADD32F = 0.9e-12   # J, 32-bit float add (a bf16 MAC's fp32 accumulate)


@dataclass(frozen=True)
class H100:
    """NVIDIA H100 SXM, per card.  Rates: NVIDIA H100 Tensor Core GPU data
    sheet, SXM column, dense (no sparsity), at the 700 W power limit —
    the same rates ``chip_smoke.py`` bounds its kernel rows with.  The
    data sheet gives no energy per operation or per byte: the energies
    are published figures named beside each."""

    peak_bf16_flops: float = 989e12   # bf16 tensor-core FLOP/s, dense
    peak_int8_ops: float = 1979e12    # int8 tensor-core OP/s, dense
    hbm_bw: float = 3.35e12           # HBM3 bytes/s
    ici_bw: float = 900e9             # NVLink 4 bytes/s per card (18 links)
    hbm_bytes: float = 80e9           # HBM3 capacity
    power_limit_w: float = 700.0      # SXM board power limit

    def dtype_cost_factor(self, width_bits: int) -> float:
        """Relative compute TIME per MAC vs bf16.  Hopper's tensor cores
        take int8 at twice the bf16 rate and have no int4 path, so every
        width up to 8 bits takes what int8 takes."""
        if width_bits <= 8:
            return self.peak_bf16_flops / self.peak_int8_ops
        return 1.0

    def energy_factor(self, width_bits: int) -> float:
        """Relative ENERGY per MAC vs one bf16 MAC (fp32 accumulate),
        counted at the operand's own width: an integer multiply's energy
        grows with its partial products, as the square of the width
        (Horowitz's 8- and 32-bit multiplies differ 15.5x for 4x the
        width), and the int32 accumulate stays.  That a narrow operand
        on the int8 datapath spares its idle partial products' energy
        is this model's assumption, not a measurement on the card."""
        if width_bits > 8:
            return 1.0
        mult = _E_MUL8 * (width_bits / 8) ** 2
        return (mult + _E_ADD32) / (_E_MUL16F + _E_ADD32F)

    # Energy model (J)
    e_flop: float = (_E_MUL16F + _E_ADD32F) / 2   # per bf16 FLOP (Horowitz;
    #                                               a MAC is 2 FLOPs): 1 pJ
    e_hbm_byte: float = 8 * 3.9e-12   # per HBM byte: HBM2's ~3.9 pJ/bit,
    #   M. O'Connor et al., "Fine-Grained DRAM: Energy-Efficient DRAM for
    #   Extreme Bandwidth Systems", MICRO 2017 (no per-bit HBM3 figure is
    #   published for the card)
    e_ici_byte: float = 700.0 / 900e9  # per NVLink byte: DERIVED, the power
    #   limit over the NVLink rate (no published figure; the labels move
    #   no collective bytes, so it enters none of them)


H100_SXM = H100()


@dataclass(frozen=True)
class TPUv5e:
    """The JAX package's cost model, per TPU v5e chip (its assignment
    brief and public v5e specs).  Kept for parity with the reference's
    labels; none of these numbers describes the port's card."""

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

    def energy_factor(self, width_bits: int) -> float:
        """Relative energy per MAC vs bf16: the reference's labels charge
        energy at the time factor."""
        return self.dtype_cost_factor(width_bits)

    # Energy model (J) — the reference's order-of-magnitude literature
    # values for its "power" objective analogue.
    e_flop: float = 0.3e-12           # J per bf16 FLOP
    e_hbm_byte: float = 15e-12        # J per HBM byte
    e_ici_byte: float = 30e-12        # J per ICI byte


V5E = TPUv5e()

Hardware = Union[H100, TPUv5e]

# the cost models by the name the CLIs (``--hw``) and the fleet's wire
# descriptors give them
HW_MODELS = {"h100": H100_SXM, "v5e": V5E}


def hw_name(hw: Hardware) -> str:
    """The ``HW_MODELS`` name of ``hw``; ``KeyError`` for a cost model
    that has none (a context costed on it cannot cross a process)."""
    for name, model in HW_MODELS.items():
        if hw == model:
            return name
    raise KeyError(f"cost model {hw!r} has no name in HW_MODELS")


@dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms, in seconds per executed step (per
    device), plus the derived energy (J, on the constants ``hw`` the
    terms were built with) and bottleneck label."""

    t_compute: float
    t_memory: float
    t_collective: float
    flops: float              # per-device FLOPs
    hbm_bytes: float          # per-device bytes accessed
    coll_bytes: float         # per-device collective bytes on the wire
    hw: Hardware = field(default=H100_SXM, repr=False)

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
            self.flops * self.hw.e_flop
            + self.hbm_bytes * self.hw.e_hbm_byte
            + self.coll_bytes * self.hw.e_ici_byte
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
    hw: Hardware = H100_SXM,
) -> RooflineTerms:
    """Three-term roofline from *per-device* FLOPs / HBM bytes / wire bytes.

    compute    = FLOPs / bf16 peak;  memory = bytes / HBM rate;
    collective = wire bytes / interconnect rate.
    """
    return RooflineTerms(
        t_compute=flops / hw.peak_bf16_flops,
        t_memory=hbm_bytes / hw.hbm_bw,
        t_collective=coll_bytes / hw.ici_bw,
        flops=flops,
        hbm_bytes=hbm_bytes,
        coll_bytes=coll_bytes,
        hw=hw,
    )
