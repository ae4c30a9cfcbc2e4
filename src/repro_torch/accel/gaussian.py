"""The paper's motivational accelerator (Fig. 1): a 3x3 Gaussian filter
composed of nine 8-bit multipliers and eight 16-bit adders.

Kernel = [[1,2,1],[2,4,2],[1,2,1]] / 16.  Products are at most 255*4 and
the 9-term adder tree peaks below 2^16, so the 16-bit adder models apply
without wraparound in the exact case.

Deployment form: im2col matmul (n_pix, 9) @ (9, 1) with one K-column per
multiplier slot (DESIGN.md §2).

``simulate``/``exact_output`` are the numpy behavioural bodies (the
exact output is the QoR reference); population batches run on the
torch engine through the plan registered below.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.acl.library import Circuit
from ..device import resolve_device
from . import fused
from .base import Accelerator, Slot, grouped_deploy_signature
from .images import sample_images

__all__ = ["GaussianFilter", "GAUSS_COEFFS"]

GAUSS_COEFFS = np.array([1, 2, 1, 2, 4, 2, 1, 2, 1], dtype=np.int64)

# adder-tree wiring: pairs reduced in order; 8 adders for 9 operands
# a0=(p0,p1) a1=(p2,p3) a2=(p4,p5) a3=(p6,p7) a4=(a0,a1) a5=(a2,a3)
# a6=(a4,a5) a7=(a6,p8)
_TREE = [(0, 1), (2, 3), (4, 5), (6, 7), (9, 10), (11, 12), (13, 14), (15, 8)]


def _im2col(images: np.ndarray) -> np.ndarray:
    """(..., n, H, W) -> (..., n*(H-2)*(W-2), 9) sliding 3x3 windows.

    Window element (dy, dx) lands in column 3*dy+dx, matching the slot
    order of the 9 multipliers."""
    win = np.lib.stride_tricks.sliding_window_view(images, (3, 3), axis=(-2, -1))
    return win.reshape(images.shape[:-3] + (-1, 9))


class GaussianFilter(Accelerator):
    name = "gaussian3x3"
    batched_sim = True
    slots = [Slot(f"mul{i}", "mul8u", 1.0) for i in range(9)] + [
        Slot(f"add{i}", "add16", 1.0) for i in range(8)
    ]

    def sample_inputs(self, n: int, seed: int = 0) -> np.ndarray:
        return sample_images(n, size=32, seed=seed)

    def _run(self, images: np.ndarray, muls: Sequence, adds: Sequence) -> np.ndarray:
        cols = _im2col(images)  # (..., m, 9)
        prods = [muls[i](cols[..., i], GAUSS_COEFFS[i]) for i in range(9)]
        vals = list(prods)  # indices 0..8; adder outputs appended as 9..16
        for fn, (ia, ib) in zip(adds, _TREE):
            vals.append(fn(vals[ia], vals[ib]))
        acc = vals[-1]
        out = acc >> 4  # /16
        h, w = images.shape[-2:]
        return out.reshape(images.shape[:-2] + (h - 2, w - 2))

    def simulate(self, circuits: Sequence[Circuit], inputs: np.ndarray) -> np.ndarray:
        muls = [c.fn for c in circuits[:9]]
        adds = [c.fn for c in circuits[9:]]
        return self._run(inputs, muls, adds)

    def exact_output(self, inputs: np.ndarray) -> np.ndarray:
        exact_mul = lambda a, b: a * b
        exact_add = lambda a, b: a + b
        return self._run(inputs, [exact_mul] * 9, [exact_add] * 8)

    # --- deployment -------------------------------------------------------
    def matmul_shape(self) -> Tuple[int, int, int]:
        return (900, 9, 1)  # 32x32 image -> 900 windows

    def slot_groups(self) -> List[Tuple[int, int]]:
        return [(i, i + 1) for i in range(9)]

    def mul_slot_constants(self):
        return [int(c) for c in GAUSS_COEFFS]

    def deploy_signature(self, specs):
        return grouped_deploy_signature(self, specs)

    def build_deploy(self, specs: Sequence, inputs: Optional[np.ndarray] = None,
                     *, device=None):
        """-> (fn, args): the rank-k deployment of this variant on
        ``device`` (default ``"cuda"``).

        Weight operand = the Gaussian coefficients (constants); activation
        operand = the im2col'd image windows.  ``fn(x, w, path="mxu")``
        runs the deployment (rank-k kernel per slot group);
        ``path="lut"`` runs the same graph through each circuit's
        product table (the behavioural route).
        """
        from ..kernels.approx_matmul import grouped_matmul

        dev = resolve_device(device)
        if inputs is None:
            inputs = self.sample_inputs(1, seed=1)
        x = torch.from_numpy(
            np.ascontiguousarray(_im2col(inputs), dtype=np.int32)).to(dev)
        w = torch.from_numpy(GAUSS_COEFFS.reshape(9, 1).astype(np.int32)).to(dev)
        groups = self.slot_groups()

        def fn(x, w, path="mxu"):
            return grouped_matmul(x, w, specs, groups, path=path)

        return fn, (x, w)


# --- population engine plan ------------------------------------------------

@fused.register_fused(GaussianFilter)
def _gaussian_fused_plan(accel, library, eng):
    """Whole-filter device program: im2col (nine shifted slices), (G, m, 9)
    LUT gather, all-circuits adder tree with per-genome selection, >>4
    normalization.  Integer outputs, so the QoR tail (SSE vs the exact
    filter) also runs on the device."""
    lut = eng.lut("mul8u", GAUSS_COEFFS, tag=accel.name)

    def stage_fn(genes, x, per_genome):
        h, w = x.shape[-2], x.shape[-1]
        cols = torch.stack(
            [
                x[..., dy : h - 2 + dy, dx : w - 2 + dx]
                for dy in range(3)
                for dx in range(3)
            ],
            dim=-1,
        )  # (..., n, h-2, w-2, 9), window (dy, dx) in slot column 3*dy+dx
        if per_genome:
            cols = cols.reshape((cols.shape[0], -1, 9))
        else:
            cols = cols.reshape((-1, 9))
        prods = eng.gather(lut, genes[:, :9], cols, per_genome=per_genome)
        vals = [prods[..., i] for i in range(9)]
        for j, (ia, ib) in enumerate(_TREE):
            vals.append(
                eng.select_add(genes[:, 9 + j], vals[ia], vals[ib], signed=False)
            )
        out = vals[-1] >> 4
        lead = (tuple(x.shape[:-2]) if per_genome
                else (genes.shape[0],) + tuple(x.shape[:-2]))
        return out.reshape(lead + (h - 2, w - 2))

    def prep(inputs, device):
        images = np.asarray(inputs)
        if images.size and (images.min() < 0 or images.max() > 255):
            raise ValueError("gaussian3x3 inputs must be 8-bit pixel values")
        return torch.from_numpy(
            np.ascontiguousarray(images, dtype=np.int32)).to(device)

    return fused.FusedPlan(
        stage_fn=stage_fn,
        prep=prep,
        post=fused.host_int64,
        qor_ref=lambda a, inputs: np.asarray(a.exact_output(inputs)),
    )
