"""Approximate matmul of one circuit choice, on its two routes.

``ApproxSpec`` packages everything a deployment site needs about one
circuit choice: the rank-k factors (deployment route), the exhaustive
table (behavioural route) and the signedness.  ``grouped_matmul``
implements the per-slot assignment semantics of the DSE: the K
(contraction) axis is partitioned into slot groups, each with its own
circuit.

The kernel wrappers dispatch on the tensor's device: on a CUDA tensor
``grouped_rank_k_matmul_kernel`` (every slot group of a variant, packed
by ``pack_groups``) and ``rank_k_matmul_kernel`` (one group) launch
``csrc/rank_k.cu`` once, and ``lut_matmul_kernel`` launches the kernel
that ``LUT_ROUTES`` picks from the shape and the table (or raise): the
16-bit table resident in shared memory (``csrc/lut_matmul_sm90.cu``,
table narrowed on the host by ``pack_lut``) or the int32 table read
from L2 (``csrc/lut_matmul.cu``).  On a CPU tensor they run the plain
versions in ``ref``.

Also provides the symmetric int8 quantization helpers that put float
tensors into the 8-bit circuit domain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ... import _build
from . import ref

__all__ = [
    "ApproxSpec",
    "from_circuit",
    "approx_matmul",
    "grouped_matmul",
    "pack_groups",
    "grouped_rank_k_matmul_kernel",
    "rank_k_matmul_kernel",
    "lut_matmul_kernel",
    "launch_lut",
    "PackedLut",
    "pack_lut",
    "lut_swizzle",
    "lut_route",
    "LUT_ROUTES",
    "LUT_SHARED_MIN_WORK",
    "quantize_sym",
    "dequantize",
]


@dataclass(frozen=True)
class ApproxSpec:
    """Deployment data of one circuit at one chosen rank.

    Truncation-family circuits carry ``trunc_bits`` > 0 and rank 0: they
    deploy NATIVELY as a reduced-width integer matmul (operands masked to
    8 - trunc_bits bits).  Everything else deploys as an int8 base
    matmul + ``rank`` correction matmuls."""

    name: str
    signed: bool
    rank: int
    u: np.ndarray          # (256, rank) f32
    v: np.ndarray          # (256, rank) f32
    table: Optional[np.ndarray] = None   # (256,256) i32, behavioural route
    trunc_bits: int = 0    # native reduced-width deployment

    @property
    def width(self) -> int:
        return 8 - self.trunc_bits

    @property
    def is_exact(self) -> bool:
        return self.rank == 0 and self.name.endswith("_exact")


def from_circuit(circuit, rank: Optional[int] = None) -> ApproxSpec:
    """Build an ApproxSpec from a ``core.acl.library.Circuit``.

    rank=None uses the circuit's faithful deployment rank (0 for exact
    and natively-truncating circuits, the 99%-energy effective rank
    otherwise); an explicit rank is the beyond-paper DSE axis.
    """
    if circuit.kind == "add16":
        raise ValueError("adders do not deploy as matmul corrections")
    native = circuit.native_width is not None
    r = circuit.deploy_rank if rank is None else (0 if native else int(rank))
    if circuit.is_exact or native or r == 0:
        u = np.zeros((256, 0), np.float32)
        v = np.zeros((256, 0), np.float32)
    else:
        f = circuit.factors(r)
        u, v = f.u, f.v
    return ApproxSpec(
        name=circuit.name,
        signed=circuit.signed,
        rank=u.shape[1],
        u=u,
        v=v,
        table=circuit.table.astype(np.int32),
        trunc_bits=circuit.trunc_bits if native else 0,
    )


# --- kernel wrappers --------------------------------------------------------

def _check_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"need (m, k) @ (k, n), got {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def _check_cuda(x, w, signed: bool) -> int:
    """Device-side preconditions of the matmul kernels; returns the table
    index offset."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for t, nm in ((x, "x"), (w, "w")):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous int32, got {t.dtype}")
    m, k = x.shape
    n = w.shape[1]
    if max(m, n, k) >= 2 ** 31 or (m + 15) // 16 > 65535:
        raise ValueError(f"shape ({m}, {k}) @ ({k}, {n}) too large")
    return 128 if signed else 0


# shared memory a block may have, less the kernel's two static 16x16 tiles
_RANK_K_SMEM = 232448 - 2 * 16 * 17 * 4


def _pack(groups) -> np.ndarray:
    """The packed int32 layout of the rank-k kernel, written here only:
    ``[G, G x (start, stop, rank, table offset, index offset, truncation
    bits), then each group's U and V as float32]``.  ``groups`` holds
    ``(start, stop, u, v, signed, truncation bits)`` per group."""
    if not groups:
        raise ValueError("no slot groups")
    desc, tables, at = [len(groups)], [], 0
    for s, e, u, v, signed, tb in groups:
        u, v = (np.ascontiguousarray(t, np.float32) for t in (u, v))
        if u.shape != v.shape or u.ndim != 2 or u.shape[0] != 256:
            raise ValueError(f"u, v must be (256, r), got {u.shape}, "
                             f"{v.shape}")
        r = u.shape[1]
        desc += [s, e, r, at, 128 if signed else 0, tb]
        tables += [u.reshape(-1), v.reshape(-1)]
        at += 512 * r
    return np.concatenate([np.asarray(desc, np.int32),
                           np.concatenate(tables).view(np.int32)])


def pack_groups(specs: Sequence[ApproxSpec],
                groups: Sequence[Tuple[int, int]]) -> np.ndarray:
    """One variant's slot groups in the packed layout of the rank-k
    kernel (``_pack``)."""
    if len(specs) != len(groups):
        raise ValueError(f"{len(specs)} specs for {len(groups)} groups")
    return _pack([(s, e, spec.u, spec.v, spec.signed, spec.trunc_bits)
                  for spec, (s, e) in zip(specs, groups)])


def _check_packed(packed: np.ndarray, k: int) -> Tuple[int, int]:
    """(groups, table floats) of a packed layout; raises on a descriptor
    that reads outside the contraction or the tables."""
    n_groups = int(packed[0]) if packed.size else 0
    n_uv = packed.size - 1 - ref.DESC_WORDS * n_groups
    if n_groups < 1 or n_uv < 0:
        raise ValueError("malformed packed groups")
    for g in range(n_groups):
        s, e, r, at, off, tb = (int(a) for a in packed[
            1 + ref.DESC_WORDS * g:1 + ref.DESC_WORDS * (g + 1)])
        if not (0 <= s <= e <= k and r >= 0 and 0 <= at
                and at + 512 * r <= n_uv and off in (0, 128)
                and 0 <= tb < 8):
            raise ValueError(f"group {g} ({s}, {e}, r={r}, at={at}, "
                             f"offset={off}, trunc={tb}) outside a "
                             f"contraction of {k} and {n_uv} table floats")
    return n_groups, n_uv


def _check_smem(n_groups: int, n_uv: int) -> None:
    """The card's cap: the kernel stages every group's tables and
    descriptors in one block's shared memory."""
    if 4 * (n_uv + ref.DESC_WORDS * n_groups) > _RANK_K_SMEM:
        raise ValueError(f"ranks too large for the U/V shared-memory stage "
                         f"({n_uv} table floats)")


def _launch_rank_k(x, w, packed: np.ndarray, n_groups: int,
                   n_uv: int) -> torch.Tensor:
    _check_cuda(x, w, False)
    _check_smem(n_groups, n_uv)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    packed = torch.from_numpy(packed).to(x.device)
    _build.call("rank_k", x.device, x.data_ptr(), w.data_ptr(),
                packed.data_ptr(), out.data_ptr(), m, n, k, n_groups, n_uv)
    return out


def grouped_rank_k_matmul_kernel(x: torch.Tensor, w: torch.Tensor,
                                 packed: np.ndarray) -> torch.Tensor:
    """(m, n) float32: every slot group of ``packed`` (``pack_groups``)
    on its contraction range, partials summed in group order.  On a CUDA
    tensor the layout is uploaded with one copy and the kernel launches
    once."""
    _check_operands(x, w)
    packed = np.ascontiguousarray(packed, np.int32)
    n_groups, n_uv = _check_packed(packed, x.shape[1])
    if x.device.type == "cpu":
        return ref.grouped_rank_k_matmul(x, w, torch.from_numpy(packed))
    return _launch_rank_k(x, w, packed, n_groups, n_uv)


def rank_k_matmul_kernel(
    x: torch.Tensor, w: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
    *, signed: bool = False,
) -> torch.Tensor:
    """(m, n) float32 ``x @ w + sum_r U[x] @ V[w]``: the grouped kernel
    with one group over the whole contraction."""
    _check_operands(x, w)
    u, v = (t.detach().float().cpu().numpy() for t in (u, v))
    return grouped_rank_k_matmul_kernel(
        x, w, _pack([(0, x.shape[1], u, v, signed, 0)]))


# --- the table matmul's two routes -------------------------------------------

# Swizzled byte offset of entry (a, b) of the narrowed table, as
# csrc/lut_matmul_sm90.cu reads it:
#   (a << 9) | ((b << 1) ^ ((a & 31) << 2))
LUT_ROW_SHIFT, LUT_COL_SHIFT = 9, 1
LUT_SWIZZLE_MASK, LUT_SWIZZLE_SHIFT = 31, 2

# m * n * k from which the shared-memory route takes less card time than
# the L2 one.  Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py,
# kernel_lut_crossover, device time a call on uniform cubes): both about
# 7 us at 64^3; above it the shared route stays near 7 us to 192^3 (its
# blocks stage the 128 KB table once each) while the L2 route grows with
# the work (9 us at 80^3, 14 at 128^3, 43 at 256^3); below it the L2
# route is faster (4 against 5 us at 32^3).
LUT_SHARED_MIN_WORK = 1 << 18
# (table range fits 16 bits, m * n * k >= LUT_SHARED_MIN_WORK) -> kernel
LUT_ROUTES = {
    (True, True): "lut_matmul_sm90",
    (True, False): "lut_matmul",
    (False, True): "lut_matmul",
    (False, False): "lut_matmul",
}


def lut_swizzle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Byte offset of entry (a, b) in the narrowed table's layout."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    return (a << LUT_ROW_SHIFT) | ((b << LUT_COL_SHIFT) ^ (
        (a & LUT_SWIZZLE_MASK) << LUT_SWIZZLE_SHIFT))


def _check_table(table: np.ndarray) -> np.ndarray:
    table = np.ascontiguousarray(table)
    if table.shape != (256, 256):
        raise ValueError(f"table must be (256, 256), got {table.shape}")
    if not np.issubdtype(table.dtype, np.integer):
        raise ValueError(f"table must be integer, got {table.dtype}")
    return table.astype(np.int32, copy=False)


def pack_lut(table: np.ndarray) -> Tuple[np.ndarray, int]:
    """A (256, 256) int32 product table narrowed for the shared-memory
    route: ``(T - tmin)`` as uint16 in the swizzled layout (``lut_swizzle``,
    65536 entries, 128 KB), and ``tmin = min(T)``.  Raises if
    ``max(T) - min(T)`` exceeds 65535."""
    t = _check_table(table).astype(np.int64)
    tmin = int(t.min())
    if int(t.max()) - tmin > 65535:
        raise ValueError(f"table range {int(t.max()) - tmin} exceeds 16 bits")
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    narrow = np.empty(65536, np.uint16)
    narrow[lut_swizzle(a, b).reshape(-1) >> 1] = (t - tmin).reshape(-1)
    return narrow, tmin


def lut_route(m: int, n: int, k: int, fits16: bool) -> str:
    """The kernel (a ``_build.KERNELS`` name) that takes an (m, k) @ (k, n)
    table matmul whose table range does (``fits16``) or does not fit 16
    bits."""
    return LUT_ROUTES[(bool(fits16), m * n * k >= LUT_SHARED_MIN_WORK)]


class PackedLut:
    """A product table ready for both routes: the int32 table on the host
    and, on first use per route and device, its device copy (the
    narrowed 128 KB ``pack_lut`` layout for the shared-memory route, the
    int32 table for the L2 one), kept for later calls so that a call
    after the first moves no table."""

    def __init__(self, table: np.ndarray):
        self.table = _check_table(table)
        self.fits16 = (int(self.table.max()) - int(self.table.min())
                       <= 65535)
        self.tmin = int(self.table.min())
        self._dev: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def device_table(self, route: str, device: torch.device) -> torch.Tensor:
        key = (route, torch.device(device))
        dev = self._dev.get(key)
        if dev is None:
            if route == "lut_matmul_sm90":
                narrow, _ = pack_lut(self.table)
                host = torch.from_numpy(narrow.view(np.int16))
            elif route == "lut_matmul":
                host = torch.from_numpy(self.table)
            else:
                raise ValueError(f"unknown lut route {route!r}")
            dev = self._dev[key] = host.to(device).contiguous()
        return dev


def _packed(table) -> PackedLut:
    if isinstance(table, PackedLut):
        return table
    if isinstance(table, torch.Tensor):
        if table.dtype != torch.int32:
            raise ValueError("table must be int32")
        table = table.detach().cpu().numpy()
    return PackedLut(table)


def launch_lut(route: str, x: torch.Tensor, w: torch.Tensor,
               table: PackedLut, *, signed: bool = False) -> torch.Tensor:
    """Launch the lut kernel ``route`` (one of ``LUT_ROUTES``'s) on CUDA
    tensors: ``lut_matmul_kernel`` with the route named rather than
    chosen, so that a measurement can time both kernels at one shape."""
    _check_operands(x, w)
    if route not in set(LUT_ROUTES.values()):
        raise ValueError(f"unknown lut route {route!r}")
    if route == "lut_matmul_sm90" and not table.fits16:
        raise ValueError("table range exceeds 16 bits: only the L2 route "
                         "takes it")
    if x.shape[1] > 33000:
        raise ValueError("k too large for an exact int32 sum")
    off = _check_cuda(x, w, signed)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    args = [x.data_ptr(), w.data_ptr(),
            table.device_table(route, x.device).data_ptr(), out.data_ptr(),
            m, n, k, off]
    if route == "lut_matmul_sm90":
        args.append(table.tmin)
    _build.call(route, x.device, *args)
    return out


def lut_matmul_kernel(
    x: torch.Tensor, w: torch.Tensor,
    table: Union[torch.Tensor, np.ndarray, PackedLut],
    *, signed: bool = False,
) -> torch.Tensor:
    """(m, n) int32 ``out[i, j] = sum_k T[x[i,k], w[k,j]]``, exact.

    ``table`` is a (256, 256) int32 table (a tensor or a numpy array) or
    a ``PackedLut``.  On a CUDA tensor it launches the kernel that
    ``lut_route`` picks for the shape and the table.  A table given as a
    device tensor is read back to the host once, to pack it: hand a host
    table or a ``PackedLut`` where the call is timed."""
    _check_operands(x, w)
    if x.device.type == "cpu":
        if isinstance(table, torch.Tensor):
            if tuple(table.shape) != (256, 256):
                raise ValueError(
                    f"table must be (256, 256), got {tuple(table.shape)}")
            return ref.lut_matmul(x, w, table, signed=signed)
        table = torch.from_numpy(_packed(table).table)
        return ref.lut_matmul(x, w, table, signed=signed)
    table = _packed(table)
    m, k = x.shape
    return launch_lut(lut_route(m, w.shape[1], k, table.fits16), x, w,
                      table, signed=signed)


# --- the two routes -----------------------------------------------------------

def approx_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: ApproxSpec,
    *,
    path: str = "mxu",     # "mxu" (rank-k deployment) | "lut" (behavioural)
) -> torch.Tensor:
    """Approximate ``x @ w`` under one circuit spec, float32 out.

    path="mxu": deployment semantics — for truncation circuits the
    operands are masked to the circuit's width first (in the rank-k
    kernel, on load), then the rank-k product runs.  path="lut":
    behavioural bit-exact semantics through the circuit's product
    table."""
    if path == "mxu":
        return grouped_matmul(x, w, [spec], [(0, x.shape[1])])
    if path != "lut":
        raise ValueError(f"unknown path {path!r}")
    if spec.table is None:
        raise ValueError(f"spec {spec.name} carries no product table")
    x = x.to(torch.int32).contiguous()
    w = w.to(torch.int32).contiguous()
    return lut_matmul_kernel(x, w, PackedLut(spec.table),
                             signed=spec.signed).float()


def grouped_matmul(
    x: torch.Tensor,                     # (m, k)
    w: torch.Tensor,                     # (k, n)
    specs: Sequence[ApproxSpec],
    groups: Sequence[Tuple[int, int]],   # [start, stop) K-ranges per spec
    *,
    path: str = "mxu",
) -> torch.Tensor:
    """Per-slot-group approximate matmul: contraction columns [s, e) of
    group g use circuit specs[g]; the partials are summed in group order.
    path="mxu" packs the groups on the host and runs them all in one
    rank-k launch; path="lut" runs one table matmul per group."""
    if len(specs) != len(groups):
        raise ValueError(f"{len(specs)} specs for {len(groups)} groups")
    if path == "mxu":
        return grouped_rank_k_matmul_kernel(
            x.to(torch.int32).contiguous(), w.to(torch.int32).contiguous(),
            pack_groups(specs, groups))
    if path != "lut":
        raise ValueError(f"unknown path {path!r}")
    out = None
    for spec, (s, e) in zip(specs, groups):
        part = approx_matmul(x[:, s:e], w[s:e, :], spec, path=path)
        out = part if out is None else out + part
    return out


def quantize_sym(
    t: torch.Tensor, *, dim: Optional[int] = None, bits: int = 8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric linear quantization to signed `bits` integers.

    Returns (q, scale) with t ~= q * scale; q in [-(2^(b-1)-1), 2^(b-1)-1].
    dim=None: per-tensor scale; otherwise per-slice along `dim`.
    """
    qmax = float(2 ** (bits - 1) - 1)
    if dim is None:
        amax = torch.max(torch.abs(t))
    else:
        amax = torch.amax(torch.abs(t), dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / qmax
    q = torch.clamp(torch.round(t / scale), -qmax, qmax).to(torch.int32)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
