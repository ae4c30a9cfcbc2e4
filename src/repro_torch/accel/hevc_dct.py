"""HEVC 4x4 integer DCT — the paper's evaluation application (§IV).

The forward transform matrix (HEVC core transform, [25]):

    C = [[64,  64,  64,  64],
         [83,  36, -36, -83],
         [64, -64, -64,  64],
         [36, -83,  83, -36]]

Each output row i is one multiple-constant-multiplication block MCM_i:
four signed 8-bit multipliers (|constants| <= 83) + a 3-adder tree.  The
2-D transform applies the four MCMs column-wise, renormalizes (>>8, the
HEVC first-stage shift adapted to keep the 8-bit circuit domain), then
row-wise.  QoR = PSNR of the exact-IDCT reconstruction from approximate
coefficients vs the reconstruction from exact coefficients, over 4x4
blocks of the synthetic image set.

Adders run on 16-bit two's-complement patterns via ``signed16``.

``simulate``/``exact_output`` and the float64 inverse transform
``_reconstruct`` are the numpy behavioural bodies; population batches
run on the torch engine through the plans registered below (the DCT's
plan returns the integer coefficients and ``_reconstruct`` finishes them
on the host).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.acl.library import Circuit
from ..device import resolve_device
from . import fused
from .base import Accelerator, Slot, grouped_deploy_signature
from .images import sample_images

__all__ = ["HEVC_C", "MCMAccelerator", "HEVCDct", "signed16"]

HEVC_C = np.array(
    [
        [64, 64, 64, 64],
        [83, 36, -36, -83],
        [64, -64, -64, 64],
        [36, -83, 83, -36],
    ],
    dtype=np.int64,
)

_SHIFT1 = 8  # stage-1 renormalization to stay in the signed 8-bit domain

# slot groups of one MCM product: multiplier j contracts column j
_MCM_GROUPS = [(j, j + 1) for j in range(4)]


def signed16(fn: Callable) -> Callable:
    """Lift an unsigned 16-bit adder model to signed two's complement:
    wrap to 16 bits, apply, sign-extend."""

    def wrapped(a, b):
        a16 = np.asarray(a, dtype=np.int64) & 0xFFFF
        b16 = np.asarray(b, dtype=np.int64) & 0xFFFF
        s = np.asarray(fn(a16, b16), dtype=np.int64) & 0xFFFF
        return np.where(s >= 0x8000, s - 0x10000, s)

    return wrapped


def _blocks(images: np.ndarray) -> np.ndarray:
    """(..., n, H, W) uint8 -> (..., m, 4, 4) signed residual blocks
    (pixel - 128); leading axes (e.g. a genome batch) pass through."""
    lead, (n, h, w) = images.shape[:-3], images.shape[-3:]
    h4, w4 = h - h % 4, w - w % 4
    x = images[..., :h4, :w4].reshape(lead + (n, h4 // 4, 4, w4 // 4, 4))
    x = np.moveaxis(x, -2, -3).reshape(lead + (-1, 4, 4))
    return x.astype(np.int64) - 128


def _mcm_apply(row: int, x: np.ndarray, muls, adds) -> np.ndarray:
    """y = sum_j C[row, j] * x[..., j] with per-slot circuits.

    x: (..., 4) signed 8-bit domain values."""
    coeffs = HEVC_C[row]
    # mul8s behavioral models are sign-magnitude wrapped: f(x, -c) = -f(x, c)
    prods = [muls[j](x[..., j], int(coeffs[j])) for j in range(4)]
    s0 = adds[0](prods[0], prods[1])
    s1 = adds[1](prods[2], prods[3])
    return adds[2](s0, s1)


def _rshift_round(v: np.ndarray, k: int) -> np.ndarray:
    return (v + (1 << (k - 1))) >> k


def _check_range(values: np.ndarray, lo: int, hi: int, what: str) -> None:
    """The population gather indexes its tables with ``value + 128``
    (signed) or the pixel itself: values outside the 8-bit domain would
    read outside the table, so they are refused here, on the host."""
    if values.size and (values.min() < lo or values.max() > hi):
        raise ValueError(f"{what} must lie in [{lo}, {hi}]")


def _grouped_rank_k(x, w, specs, path):
    """One MCM product per output column: x (m, 4) @ w (4, 1), one spec
    per contraction column (one rank-k launch on the ``mxu`` path)."""
    from ..kernels.approx_matmul import grouped_matmul

    return grouped_matmul(x, w, specs, _MCM_GROUPS, path=path)


class MCMAccelerator(Accelerator):
    """One MCM block (paper: MCM1..MCM4 of the HEVC use-case)."""

    batched_sim = True

    def __init__(self, row: int):
        if not 0 <= row < 4:
            raise ValueError(f"MCM row must be in 0..3, got {row}")
        self.row = row
        self.name = f"mcm{row + 1}"
        self.slots = [Slot(f"mul{j}", "mul8s", 1.0) for j in range(4)] + [
            Slot(f"add{j}", "add16", 1.0) for j in range(3)
        ]

    def sample_inputs(self, n: int, seed: int = 0) -> np.ndarray:
        imgs = sample_images(n, size=32, seed=seed)
        return _blocks(imgs).reshape(-1, 4)  # row vectors of residuals

    def _decode(self, circuits: Sequence[Circuit]):
        muls = [c.fn for c in circuits[:4]]
        adds = [signed16(c.fn) for c in circuits[4:]]
        return muls, adds

    def simulate(self, circuits: Sequence[Circuit], inputs: np.ndarray) -> np.ndarray:
        muls, adds = self._decode(circuits)
        return _mcm_apply(self.row, inputs, muls, adds)

    def exact_output(self, inputs: np.ndarray) -> np.ndarray:
        return inputs @ HEVC_C[self.row]

    # --- deployment -------------------------------------------------------
    def matmul_shape(self) -> Tuple[int, int, int]:
        return (1024, 4, 1)

    def slot_groups(self) -> List[Tuple[int, int]]:
        return list(_MCM_GROUPS)

    def mul_slot_constants(self):
        return [int(c) for c in HEVC_C[self.row]]

    def deploy_signature(self, specs):
        return grouped_deploy_signature(self, specs)

    def deploy_cost(self, specs, inputs: Optional[np.ndarray] = None
                    ) -> Dict[str, float]:
        """The graph ``build_deploy`` runs: one grouped (m, 4) @ (4, 1)
        product over the deploy input's m rows."""
        from ..core.features.synth import grouped_cost

        if inputs is None:
            inputs = self.sample_inputs(1, seed=1)
        return grouped_cost(len(inputs), 1, _MCM_GROUPS, specs)

    def build_deploy(self, specs: Sequence, inputs: Optional[np.ndarray] = None,
                     *, device=None):
        """-> (fn, args): one grouped rank-k product (m, 4) @ (4, 1) of the
        residual rows against the row's signed constants, on ``device``
        (default ``"cuda"``).  ``fn(x, w, path="mxu")``; ``path="lut"``
        runs the same graph through the product tables."""
        dev = resolve_device(device)
        if inputs is None:
            inputs = self.sample_inputs(1, seed=1)
        x = torch.from_numpy(
            np.ascontiguousarray(inputs, dtype=np.int32)).to(dev)   # (m, 4)
        w = torch.from_numpy(
            HEVC_C[self.row].reshape(4, 1).astype(np.int32)).to(dev)

        def fn(x, w, path="mxu"):
            return _grouped_rank_k(x, w, specs, path)

        return fn, (x, w)


class HEVCDct(Accelerator):
    """Full 2-D 4x4 approximate DCT: 16 mul8s + 12 add16 slots (four MCM
    blocks), applied column-wise then row-wise with a >>8 renorm."""

    name = "hevc_dct4x4"
    batched_sim = True
    deploy_passes = 2  # column stage + row stage

    def __init__(self):
        self.mcms = [MCMAccelerator(r) for r in range(4)]
        self.slots = []
        for m in self.mcms:
            self.slots += [
                Slot(f"{m.name}_{s.name}", s.kind, s.weight) for s in m.slots
            ]

    def sample_inputs(self, n: int, seed: int = 0) -> np.ndarray:
        return sample_images(n, size=32, seed=seed)

    def _split(self, circuits: Sequence[Circuit]):
        per = []
        for r in range(4):
            sub = circuits[r * 7 : (r + 1) * 7]
            muls = [c.fn for c in sub[:4]]
            adds = [signed16(c.fn) for c in sub[4:]]
            per.append((muls, adds))
        return per

    def _transform(self, blocks: np.ndarray, per) -> np.ndarray:
        """blocks: (..., m, 4, 4) -> coefficients (..., m, 4, 4)."""
        # stage 1: columns.  T[i, c] = MCM_i(X[:, c])
        t = np.stack(
            [
                _mcm_apply(r, np.swapaxes(blocks, -1, -2), per[r][0], per[r][1])
                for r in range(4)
            ],
            axis=-2,
        )  # (..., m, 4(row), 4(col))
        t = np.clip(_rshift_round(t, _SHIFT1), -128, 127)
        # stage 2: rows.  Y[i, k] = MCM_k(T[i, :])  (transform the rows)
        y = np.stack(
            [_mcm_apply(r, t, per[r][0], per[r][1]) for r in range(4)],
            axis=-1,
        )  # (..., m, 4, 4)
        return y

    def _reconstruct(self, coeffs: np.ndarray) -> np.ndarray:
        """Exact float inverse of the renormalized forward transform
        (float64 on the host: its contraction order sets the bits)."""
        cinv = np.linalg.inv(HEVC_C.astype(np.float64))
        # forward was  Y ~= (C X C^T) / 2^8  (stage-1 shift); invert:
        x = cinv @ (coeffs.astype(np.float64) * (1 << _SHIFT1)) @ cinv.T
        return x

    def simulate(self, circuits: Sequence[Circuit], inputs: np.ndarray) -> np.ndarray:
        per = self._split(circuits)
        return self._reconstruct(self._transform(_blocks(inputs), per))

    def exact_output(self, inputs: np.ndarray) -> np.ndarray:
        exact = [
            ([lambda a, b: a * b] * 4, [lambda a, b: a + b] * 3) for _ in range(4)
        ]
        return self._reconstruct(self._transform(_blocks(inputs), exact))

    # --- deployment -------------------------------------------------------
    def matmul_shape(self) -> Tuple[int, int, int]:
        return (1024, 4, 4)

    def slot_groups(self) -> List[Tuple[int, int]]:
        # mul slot j of MCM r contracts column j; groups returned MCM-major
        return [(j, j + 1) for _ in range(4) for j in range(4)]

    def mul_slot_constants(self):
        return [int(HEVC_C[r, j]) for r in range(4) for j in range(4)]

    def deploy_signature(self, specs):
        """The 2-D DCT deploys each spec as a (m,1)@(1,1) product in BOTH
        passes; the 16 slots are shape-interchangeable, so classes are
        the sorted multiset.  Its builder is not plain grouped_matmul —
        the family carries the class name (no cross-accelerator sharing)
        plus the canonical deploy input shape, which differs when the
        DCT runs in situ inside a pipeline (smaller intermediate images
        re-block to a different m)."""
        shape = getattr(self, "_native_input_shape", None)
        if shape is None:
            shape = np.shape(self.sample_inputs(1, seed=1))
            self._native_input_shape = shape
        family = ("hevc_dct4x4_2pass", shape,
                  tuple(int(v) for v in self.matmul_shape()))
        classes = tuple(sorted(
            (int(sp.rank), int(sp.trunc_bits), bool(sp.signed))
            for sp in specs
        ))
        return family, classes

    def deploy_cost(self, specs, inputs: Optional[np.ndarray] = None
                    ) -> Dict[str, float]:
        """The graph ``build_deploy`` runs: in each of the two passes, one
        grouped (m, 4) @ (4, 1) product per output column r (its specs
        ``specs[4r:4r+4]``), m the residual rows of the deploy input."""
        from ..core.features.synth import grouped_cost

        if inputs is None:
            inputs = self.sample_inputs(1, seed=1)
        m = 4 * _blocks(np.asarray(inputs)).shape[-3]
        total = {"flops": 0.0, "hbm_bytes": 0.0}
        for r in range(4):
            c = grouped_cost(m, 1, _MCM_GROUPS, specs[4 * r:4 * r + 4])
            for k in total:
                total[k] += c[k] * self.deploy_passes
        return total

    def build_deploy(self, specs: Sequence, inputs: Optional[np.ndarray] = None,
                     *, device=None):
        """-> (fn, args): the two-pass deployment on ``device`` (default
        ``"cuda"``).  Each pass is four grouped rank-k launches, one per
        output column r: x (m, 4) @ C^T[:, r] with the per-(r, j) specs
        ``specs[4r + j]``; between the passes round(y / 2^8) clipped to
        the signed 8-bit domain.  Stage 2 reads column j of the stage-1
        output as the JAX package's deployment does.  ``fn(x, w,
        path="mxu")``; ``path="lut"`` runs the same graph through the
        product tables."""
        dev = resolve_device(device)
        if inputs is None:
            inputs = self.sample_inputs(1, seed=1)
        x = torch.from_numpy(np.ascontiguousarray(
            _blocks(np.asarray(inputs)).reshape(-1, 4), dtype=np.int32)).to(dev)
        w = torch.from_numpy(
            np.ascontiguousarray(HEVC_C.T, dtype=np.int32)).to(dev)

        def one_pass(x, w, path):
            return torch.cat([
                _grouped_rank_k(x, w[:, r:r + 1], specs[4 * r:4 * r + 4], path)
                for r in range(4)
            ], dim=1)

        def fn(x, w, path="mxu"):
            y = one_pass(x, w, path)                       # (m, 4) stage 1
            y = torch.clamp(torch.round(y / (1 << _SHIFT1)), -128, 127)
            return one_pass(y.to(torch.int32), w, path)

        return fn, (x, w)


# --- population engine plans ----------------------------------------------

def _mcm_fused_apply(eng, lut, x, mul_genes, add_genes, per_genome):
    """Device twin of the MCM adder tree over a population: x (..., 4)
    residuals (leading genome axis iff per_genome), returns (G, ...)."""
    G = mul_genes.shape[0]
    mid = tuple(x.shape[1:-1] if per_genome else x.shape[:-1])
    cols = x + 128
    cols = cols.reshape((G, -1, 4)) if per_genome else cols.reshape((-1, 4))
    prods = eng.gather(lut, mul_genes, cols, per_genome=per_genome)
    s0 = eng.select_add(add_genes[:, 0], prods[..., 0], prods[..., 1], signed=True)
    s1 = eng.select_add(add_genes[:, 1], prods[..., 2], prods[..., 3], signed=True)
    out = eng.select_add(add_genes[:, 2], s0, s1, signed=True)
    return out.reshape((G,) + mid)


def _blocks_torch(images: torch.Tensor) -> torch.Tensor:
    """Device twin of ``_blocks`` (int32 domain)."""
    lead, (n, h, w) = tuple(images.shape[:-3]), tuple(images.shape[-3:])
    h4, w4 = h - h % 4, w - w % 4
    x = images[..., :h4, :w4].reshape(lead + (n, h4 // 4, 4, w4 // 4, 4))
    x = torch.movedim(x, -2, -3).reshape(lead + (-1, 4, 4))
    return x - 128


def _to_device_i32(values: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(values, dtype=np.int32)).to(device)


@fused.register_fused(MCMAccelerator)
def _mcm_fused_plan(accel, library, eng):
    """Single-MCM device program; integer outputs, so QoR reduces on the
    device against the exact ``inputs @ C[row]``."""
    lut = eng.lut("mul8s", HEVC_C[accel.row], tag=f"mcm{accel.row}")

    def stage_fn(genes, x, per_genome):
        return _mcm_fused_apply(
            eng, lut, x, genes[:, :4], genes[:, 4:7], per_genome
        )

    def prep(inputs, device):
        x = np.asarray(inputs)
        _check_range(x, -128, 127, f"{accel.name} inputs (residuals)")
        return _to_device_i32(x, device)

    return fused.FusedPlan(
        stage_fn=stage_fn,
        prep=prep,
        post=fused.host_int64,
        qor_ref=lambda a, inputs: np.asarray(a.exact_output(inputs)),
    )


@fused.register_fused(HEVCDct)
def _hevc_fused_plan(accel, library, eng):
    """Full 2-D DCT on the device: blocking, both MCM passes, renorm and
    clip between.  The device returns the INTEGER coefficients; the
    float64 inverse transform stays on the host (``_reconstruct``),
    because float64 contraction order, and hence the bits, is the numpy
    path's there."""
    luts = [eng.lut("mul8s", HEVC_C[r], tag=f"mcm{r}") for r in range(4)]

    def stage_fn(genes, x, per_genome):
        blocks = _blocks_torch(x)

        def mcm(r, v, per_g):
            return _mcm_fused_apply(
                eng, luts[r], v,
                genes[:, 7 * r : 7 * r + 4],
                genes[:, 7 * r + 4 : 7 * r + 7],
                per_g,
            )

        xt = torch.swapaxes(blocks, -1, -2)
        t = torch.stack([mcm(r, xt, per_genome) for r in range(4)], dim=-2)
        t = torch.clamp((t + (1 << (_SHIFT1 - 1))) >> _SHIFT1, -128, 127)
        # stage 2 sees the PER-GENOME intermediate t regardless of how
        # the population's input was shared
        y = torch.stack([mcm(r, t, True) for r in range(4)], dim=-1)
        return y  # integer coefficients (G, ..., m, 4, 4)

    def prep(inputs, device):
        images = np.asarray(inputs)
        _check_range(images, 0, 255, f"{accel.name} inputs (pixels)")
        return _to_device_i32(images, device)

    return fused.FusedPlan(
        stage_fn=stage_fn,
        prep=prep,
        post=lambda raw, inputs, per_genome: accel._reconstruct(
            raw.cpu().numpy().astype(np.int64)),
        qor_ref=None,
        device_natural=False,
    )
