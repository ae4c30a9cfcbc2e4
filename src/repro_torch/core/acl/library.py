"""The approximate-circuit library (ACL) registry.

This is the JAX-side equivalent of the paper's EvoApprox8b library [22]:
a catalogue of 8-bit approximate multipliers and 16-bit approximate adders,
each carrying

  * a behavioral model (``fn``) — bit-exact vectorized numpy,
  * an exhaustive product table (multipliers) and error table,
  * error statistics (the QoR-surrogate features of the paper),
  * a low-rank SVD factorization of the error table (the TPU deployment
    path, DESIGN.md §2),
  * closed-form *structural* cost features (the ABC-analogue features) and
  * a reference hardware cost on the target TPU (roofline energy/latency
    contribution per MAC — the Vivado-analogue label is produced by
    ``core.features.synth``, not here).

Everything is cached on first access: the registry is cheap to import.
"""

from __future__ import annotations

import functools
import hashlib
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from . import adders, multipliers, tables

__all__ = [
    "Circuit",
    "Library",
    "default_library",
    "library_fingerprint",
    "MUL8U",
    "MUL8S",
    "ADD16",
]


@dataclass(frozen=True)
class Circuit:
    """One approximate circuit: behavioral model + cached analyses."""

    name: str
    kind: str  # "mul8u" | "mul8s" | "add16"
    fn: Callable  # vectorized numpy behavioral model
    # Structural knobs (used by the cheap feature extractor):
    trunc_bits: int = 0       # LSBs removed from the datapath
    pp_rows: int = 8          # partial-product rows kept (multipliers)
    carry_window: int = 16    # longest exact carry chain (adders)
    is_exact: bool = False
    # Operand-truncation circuits deploy NATIVELY on the MXU as a
    # reduced-width integer matmul (no correction terms): the truncation
    # IS the quantization.  None for every other family.
    native_width: Optional[int] = None
    _cache: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def deploy_width(self) -> int:
        """Integer operand width of the MXU deployment (8 = int8 base)."""
        return self.native_width if self.native_width is not None else 8

    @property
    def deploy_rank(self) -> int:
        """Correction rank of the faithful deployment: 0 for exact and for
        natively-deployable truncations, eff_rank otherwise."""
        if self.kind == "add16" or self.is_exact or self.native_width is not None:
            return 0
        return self.eff_rank

    def deploy_cost_factor(self) -> float:
        """Relative MAC cost of this circuit's faithful MXU deployment vs
        ONE bf16 MAC: base matmul at deploy_width + deploy_rank bf16
        correction matmuls (DESIGN.md §2; the TPU-native Pareto lever —
        on the MXU, power-of-two truncations are the cheap family, exotic
        logic-level circuits cost MORE than exact).

        This is a surrogate FEATURE (cheap extractor, circuit-level
        pre-filter), not a label, so it stays on the JAX package's
        ``hw.V5E`` cost model whatever constants the labels use: the
        port's features stay bit-identical to the reference's."""
        from .. import hw

        base = hw.V5E.dtype_cost_factor(self.deploy_width)
        if self.kind == "add16":
            return 0.0  # adders ride the MXU accumulators for free
        return base + float(self.deploy_rank)

    # ---- cached heavy analyses -------------------------------------------------
    def _get(self, key, build):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    @property
    def signed(self) -> bool:
        return self.kind == "mul8s"

    @property
    def table(self) -> np.ndarray:
        """(256,256) exhaustive product table (multipliers only)."""
        if self.kind == "add16":
            raise ValueError("adders are not exhaustively tabulated")
        build = (
            (lambda: tables.product_table_s8(self.fn))
            if self.signed
            else (lambda: tables.product_table_u8(self.fn))
        )
        return self._get("table", build)

    @property
    def etab(self) -> np.ndarray:
        """(256,256) error table E = approx - exact (multipliers only)."""
        return self._get(
            "etab", lambda: tables.error_table(self.table, signed=self.signed)
        )

    @property
    def stats(self) -> tables.ErrorStats:
        if self.kind == "add16":
            return self._get("stats", lambda: tables.adder_error_stats(self.fn))
        return self._get(
            "stats", lambda: tables.error_stats(self.table, signed=self.signed)
        )

    @property
    def eff_rank(self) -> int:
        """Effective rank of the error table at 99% energy (TPU deployment
        cost factor: rank-k correction = k extra MXU matmuls)."""
        if self.kind == "add16":
            return 0  # adders deploy as elementwise maps, no matmul correction
        if self.is_exact:
            return 0
        return self._get("eff_rank", lambda: tables.effective_rank(self.etab))

    def factors(self, rank: int) -> tables.RankFactors:
        key = ("factors", rank)
        return self._get(key, lambda: tables.svd_factors(self.etab, rank))

    # ---- cheap structural cost features (ABC analogue, per-MAC) ----------------
    @property
    def structural_features(self) -> np.ndarray:
        """Closed-form per-circuit cost proxies.  Mirrors the role of ABC's
        AIG statistics in the paper: fast, synthesis-free, correlated with
        the true hardware cost.  Order: [pp_rows, 8-trunc_bits,
        carry_window, eff_rank, log10(1+mse), mae, ep]."""

        def build():
            s = self.stats
            return np.array(
                [
                    float(self.pp_rows),
                    float(8 - self.trunc_bits),
                    float(self.carry_window),
                    float(self.eff_rank),
                    np.log10(1.0 + s.mse),
                    s.mae,
                    s.ep,
                ]
            )

        return self._get("sfeat", build)

    @property
    def error_features(self) -> np.ndarray:
        """The QoR-surrogate inputs: 'mean and average error' (paper §III)
        plus the extended AC benchmarking metrics."""
        return self.stats.as_array()


def _mk_mul(name, fn, **kw) -> Circuit:
    return Circuit(name=name, kind="mul8u", fn=fn, **kw)


def _mk_muls(name, fn, **kw) -> Circuit:
    return Circuit(name=name, kind="mul8s", fn=multipliers.signed_wrap(fn), **kw)


def _mk_add(name, fn, **kw) -> Circuit:
    return Circuit(name=name, kind="add16", fn=fn, **kw)


def _build_mul8u() -> List[Circuit]:
    out = [_mk_mul("mul8u_exact", multipliers.mul8_exact, is_exact=True)]
    for k in range(1, 7):
        out.append(
            _mk_mul(
                f"mul8u_trunc{k}",
                functools.partial(multipliers.mul8_trunc, k=k),
                trunc_bits=k,
                pp_rows=8 - k,
                native_width=8 - k,
            )
        )
    for k in range(1, 7):
        out.append(
            _mk_mul(
                f"mul8u_perf{k}",
                functools.partial(multipliers.mul8_perforated, k=k),
                pp_rows=8 - k,
            )
        )
    for k in range(2, 9, 2):
        out.append(
            _mk_mul(
                f"mul8u_bam{k}",
                functools.partial(multipliers.mul8_broken_array, k=k),
                trunc_bits=k // 2,
            )
        )
    out.append(_mk_mul("mul8u_mitchell", multipliers.mul8_mitchell, pp_rows=2))
    for k in range(3, 7):
        out.append(
            _mk_mul(
                f"mul8u_drum{k}",
                functools.partial(multipliers.mul8_drum, k=k),
                pp_rows=k,
            )
        )
    out.append(_mk_mul("mul8u_kulkarni", multipliers.mul8_kulkarni, pp_rows=7))
    return out


def _build_mul8s() -> List[Circuit]:
    out = [
        Circuit(
            name="mul8s_exact",
            kind="mul8s",
            fn=multipliers.signed_wrap(multipliers.mul8_exact),
            is_exact=True,
        )
    ]
    for k in range(1, 7):
        out.append(
            _mk_muls(
                f"mul8s_trunc{k}",
                functools.partial(multipliers.mul8_trunc, k=k),
                trunc_bits=k,
                pp_rows=8 - k,
                native_width=8 - k,
            )
        )
    for k in range(1, 7):
        out.append(
            _mk_muls(
                f"mul8s_perf{k}",
                functools.partial(multipliers.mul8_perforated, k=k),
                pp_rows=8 - k,
            )
        )
    out.append(_mk_muls("mul8s_mitchell", multipliers.mul8_mitchell, pp_rows=2))
    for k in range(3, 7):
        out.append(
            _mk_muls(
                f"mul8s_drum{k}",
                functools.partial(multipliers.mul8_drum, k=k),
                pp_rows=k,
            )
        )
    out.append(_mk_muls("mul8s_kulkarni", multipliers.mul8_kulkarni, pp_rows=7))
    return out


def _build_add16() -> List[Circuit]:
    out = [_mk_add("add16_exact", adders.add_exact, is_exact=True)]
    for k in range(2, 9, 2):
        out.append(
            _mk_add(
                f"add16_loa{k}",
                functools.partial(adders.add_loa, k=k),
                trunc_bits=k,
                carry_window=16 - k,
            )
        )
    for k in range(2, 9, 2):
        out.append(
            _mk_add(
                f"add16_trunc{k}",
                functools.partial(adders.add_trunc, k=k),
                trunc_bits=k,
                carry_window=16 - k,
            )
        )
    for seg in (4, 8):
        out.append(
            _mk_add(
                f"add16_seg{seg}",
                functools.partial(adders.add_segmented, seg=seg),
                carry_window=seg,
            )
        )
    for k in (4, 8):
        out.append(
            _mk_add(
                f"add16_eta1_{k}",
                functools.partial(adders.add_eta1, k=k),
                carry_window=16 - k,
            )
        )
    for la in (4, 8):
        out.append(
            _mk_add(
                f"add16_aca{la}",
                functools.partial(adders.add_speculative, la=la),
                carry_window=la,
            )
        )
    return out


class Library:
    """A named collection of circuits, indexable by kind and by name.

    The DSE genome stores *indices into a kind's circuit list*, so the
    library object is the single source of truth for genome decoding.
    """

    def __init__(self, circuits: List[Circuit]):
        self.circuits = list(circuits)
        self.by_name: Dict[str, Circuit] = {c.name: c for c in self.circuits}
        self.by_kind: Dict[str, List[Circuit]] = {}
        for c in self.circuits:
            self.by_kind.setdefault(c.kind, []).append(c)

    def __len__(self) -> int:
        return len(self.circuits)

    def __getitem__(self, name: str) -> Circuit:
        return self.by_name[name]

    def kind(self, kind: str) -> List[Circuit]:
        return self.by_kind[kind]

    def index(self, kind: str, name: str) -> int:
        return [c.name for c in self.by_kind[kind]].index(name)

    def exact_index(self, kind: str) -> int:
        for i, c in enumerate(self.by_kind[kind]):
            if c.is_exact:
                return i
        raise ValueError(f"no exact circuit of kind {kind}")

    def subset(self, names) -> "Library":
        return Library([self.by_name[n] for n in names])


@functools.lru_cache(maxsize=1)
def default_library() -> Library:
    return Library(_build_mul8u() + _build_mul8s() + _build_add16())


# fixed probe operands per circuit kind for behavioral fingerprinting
_PROBE_OPS = {
    "mul8u": (np.arange(0, 256, 15, dtype=np.int64),
              np.arange(255, -1, -15, dtype=np.int64)),
    "mul8s": (np.arange(-128, 128, 15, dtype=np.int64),
              np.arange(127, -129, -15, dtype=np.int64)),
    "add16": (np.arange(-32768, 32768, 3855, dtype=np.int64),
              np.arange(32767, -32769, -3855, dtype=np.int64)),
}

# Memoized per live Library OBJECT: weak keys cannot alias two libraries
# the way ``id(library)`` can after the first is collected and the id is
# reused, and content-equal libraries hash to the same digest anyway.
_FP_MEMO: "weakref.WeakKeyDictionary[Library, str]" = weakref.WeakKeyDictionary()


def library_fingerprint(library: Library) -> str:
    """Content digest of the genome decoding map AND circuit behavior.

    Genomes store indices into the per-kind lists, so order and names
    matter — but so does each circuit's behavior: structural knobs plus
    a fixed behavioral probe of ``fn`` are hashed so that editing a
    circuit without renaming it re-keys every content-addressed consumer
    (label store, LUT caches, fused-sim jit cache) instead of serving
    stale state."""
    fp = _FP_MEMO.get(library)
    if fp is not None:
        return fp
    h = hashlib.sha256()
    for kind, circuits in sorted(library.by_kind.items()):
        for c in circuits:
            h.update(repr((kind, c.name, c.trunc_bits, c.pp_rows,
                           c.carry_window, bool(c.is_exact),
                           c.native_width)).encode())
            probe = _PROBE_OPS.get(kind)
            if probe is not None:
                out = np.asarray(c.fn(*probe)).astype(np.int64)
                h.update(out.tobytes())
    fp = h.hexdigest()[:16]
    _FP_MEMO[library] = fp
    return fp


# Convenience kind constants
MUL8U = "mul8u"
MUL8S = "mul8s"
ADD16 = "add16"
