"""The redesigned LUT matmul's arithmetic, layout and routes, modelled in
plain torch on the CPU: the table narrowed to ``T - min(T)`` as uint16 in
the swizzled layout that ``pack_lut`` writes and ``csrc/lut_matmul_sm90.cu``
reads, summed in uint32 with ``k * min(T)`` added modulo 2^32, byte-equal
to the JAX package's ``lut_matmul_pallas`` (interpret mode) and to both
packages' reference; the route table; and a model of the shared-memory
banks that a warp's lookups hit, read from the kernel's ``constexpr``
layout.  The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py``."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import approx_matmul as ref_am
from repro_torch import _build
from repro_torch._build import SRC_DIR
from repro_torch.core.acl.library import default_library
from repro_torch.kernels import approx_matmul as am

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load_chip_smoke()


def _cu_constants(path) -> dict:
    """The namespace-level ``constexpr int`` constants of a kernel source,
    evaluated in order (each may name the ones before it)."""
    env: dict = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 Path(path).read_text(), flags=re.M):
        env[name] = int(eval(expr, {"__builtins__": {}}, dict(env)))
    return env


CU = _cu_constants(SRC_DIR / "lut_matmul_sm90.cu")


def _swizzle(a, b):
    """Byte offset of entry (a, b) as the kernel reads it."""
    return (a << CU["kRowShift"]) | ((b << CU["kColShift"]) ^ (
        (a & CU["kSwizzleMask"]) << CU["kSwizzleShift"]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the narrowed arithmetic
# ---------------------------------------------------------------------------

def _narrow_model(x, w, narrow, tmin, signed):
    """What ``csrc/lut_matmul_sm90.cu`` computes: each term a 16-bit load at
    the XOR of the operands' row and column parts, the sum in uint32, then
    ``+ k * tmin`` modulo 2^32, read as int32.  Returns the result and the
    uint32 sums before the bias."""
    off = 128 if signed else 0
    a = x.long() + off
    b = w.long() + off
    assert int(a.min()) >= 0 and int(a.max()) <= 255
    assert int(b.min()) >= 0 and int(b.max()) <= 255
    rows = (a << CU["kRowShift"]) | ((a & CU["kSwizzleMask"])
                                     << CU["kSwizzleShift"])
    cols = b << CU["kColShift"]
    addr = rows[:, :, None] ^ cols[None, :, :]               # (m, k, n)
    entries = torch.from_numpy(narrow.astype(np.int64))[addr >> 1]
    acc = entries.sum(dim=1) % 2 ** 32
    res = (acc + x.shape[1] * tmin) % 2 ** 32
    res = torch.where(res >= 2 ** 31, res - 2 ** 32, res)
    return res.to(torch.int32), acc


def _operands(signed, m, k, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 128) if signed else (0, 256)
    return (rng.integers(lo, hi, (m, k)).astype(np.int32),
            rng.integers(lo, hi, (k, n)).astype(np.int32))


@pytest.mark.parametrize("name", ["mul8u_exact", "mul8s_exact",
                                  "mul8u_bam6", "mul8s_drum4",
                                  "mul8u_mitchell", "mul8s_perf3"])
def test_narrowed_arithmetic_byte_equal_to_pallas_interpret(name):
    c = LIB[name]
    table = c.table.astype(np.int32)
    x, w = _operands(c.signed, 64, 64, 32, seed=len(name))
    want = np.asarray(ref_am.lut_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(table),
        signed=c.signed, bm=32, bn=32, bk=32, interpret=True))
    narrow, tmin = am.pack_lut(table)
    got, _ = _narrow_model(_t(x), _t(w), narrow, tmin, c.signed)
    assert got.numpy().tobytes() == want.astype(np.int32).tobytes()
    plain = am.lut_matmul(_t(x), _t(w), _t(table), signed=c.signed)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("m,k,n", [(33, 37, 29), (1, 5, 1), (70, 3, 65),
                                   (65, 6, 33)])
def test_narrowed_arithmetic_ragged_shapes(m, k, n):
    """Shapes no multiple of the kernel's tiles or its 4 k-steps, against
    both packages' reference."""
    for name in ("mul8u_kulkarni", "mul8s_mitchell"):
        c = LIB[name]
        table = c.table.astype(np.int32)
        x, w = _operands(c.signed, m, k, n, seed=m * k + n)
        want = np.asarray(ref_am.lut_matmul(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(table),
            signed=c.signed))
        narrow, tmin = am.pack_lut(table)
        got, _ = _narrow_model(_t(x), _t(w), narrow, tmin, c.signed)
        assert got.numpy().tobytes() == want.astype(np.int32).tobytes()


def _full_range_table(seed):
    """A synthetic table spanning -32768..32767, the widest 16-bit range."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-32768, 32768, (256, 256)).astype(np.int32)
    t[3, 5], t[250, 7] = -32768, 32767
    return t


def test_narrowed_sum_wraps_at_k_33000():
    """At k = 33000 with the table's extreme entries the uint32 sum plus
    k * tmin wraps modulo 2^32, and the int32 result is still exact."""
    table = _full_range_table(0)
    m, k, n = 8, 33000, 8
    x, w = _operands(False, m, k, n, seed=33000)
    x[:4] = 250                      # rows of the largest entry
    w[:, :4] = 7
    x[6:] = 3                        # rows of the smallest entry
    w[:, 6:] = 5
    want = np.asarray(ref_am.lut_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(table),
        bm=8, bn=8, bk=1000, interpret=True))
    narrow, tmin = am.pack_lut(table)
    assert tmin == -32768
    got, acc = _narrow_model(_t(x), _t(w), narrow, tmin, False)
    assert got.numpy().tobytes() == want.astype(np.int32).tobytes()
    assert torch.equal(got, am.lut_matmul(_t(x), _t(w), _t(table)))
    assert int(got[0, 0]) == k * 32767 and int(got[7, 7]) == -k * 32768
    bias = (k * tmin) % 2 ** 32
    assert bool((acc + bias >= 2 ** 32).any())       # the sum wrapped
    assert int(acc.max()) < 2 ** 32


# ---------------------------------------------------------------------------
# packing and routes
# ---------------------------------------------------------------------------

def test_kernel_layout_matches_host_packing():
    assert (CU["kRowShift"], CU["kColShift"], CU["kSwizzleMask"],
            CU["kSwizzleShift"]) == (am.ops.LUT_ROW_SHIFT,
                                     am.ops.LUT_COL_SHIFT,
                                     am.ops.LUT_SWIZZLE_MASK,
                                     am.ops.LUT_SWIZZLE_SHIFT)
    assert CU["kTableBytes"] == 2 * 65536
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    off = _swizzle(a, b)
    assert np.array_equal(off, am.lut_swizzle(a, b))
    # a bijection onto the even bytes of the 128 KB table
    assert np.array_equal(np.sort(off.reshape(-1)), 2 * np.arange(65536))


@pytest.mark.parametrize("name", ["mul8u_exact", "mul8s_kulkarni"])
def test_pack_lut_round_trip(name):
    table = LIB[name].table.astype(np.int32)
    narrow, tmin = am.pack_lut(table)
    assert narrow.dtype == np.uint16 and narrow.shape == (65536,)
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    assert np.array_equal(narrow[_swizzle(a, b) >> 1].astype(np.int64) + tmin,
                          table)


def test_every_library_multiplier_fits_16_bits():
    widths = {c.name: int(c.table.max()) - int(c.table.min())
              for c in LIB.by_name.values() if c.kind != "add16"}
    assert len(widths) == 42
    assert max(widths.values()) == 65025 == widths["mul8u_exact"]
    for name in widths:
        assert am.PackedLut(LIB[name].table).fits16


def test_pack_lut_refuses_a_range_over_16_bits():
    table = np.zeros((256, 256), np.int32)
    table[0, 0], table[255, 255] = -30000, 35535          # 65535: fits
    narrow, tmin = am.pack_lut(table)
    assert tmin == -30000 and int(narrow.max()) == 65535
    table[255, 255] = 35536                                # 65536
    with pytest.raises(ValueError, match="16 bits"):
        am.pack_lut(table)
    assert not am.PackedLut(table).fits16
    with pytest.raises(ValueError, match="256, 256"):
        am.pack_lut(table[:, :255])


@pytest.mark.parametrize("m,n,k,fits16,route", [
    (512, 512, 512, True, "lut_matmul_sm90"),
    (131072, 1, 64, True, "lut_matmul_sm90"),
    (900, 1, 1, True, "lut_matmul"),           # a gaussian slot group
    (512, 512, 512, False, "lut_matmul"),      # wider than 16 bits
    (64, 33000, 64, False, "lut_matmul"),
])
def test_lut_route(m, n, k, fits16, route):
    assert am.lut_route(m, n, k, fits16) == route


def test_lut_route_crossover_and_kernels():
    w = am.LUT_SHARED_MIN_WORK
    assert am.lut_route(1, 1, w, True) == "lut_matmul_sm90"
    assert am.lut_route(1, 1, w - 1, True) == "lut_matmul"
    assert set(am.LUT_ROUTES.values()) <= set(_build.KERNELS)
    assert set(am.LUT_ROUTES.values()) <= set(_build.LAUNCHES)
    assert {r for (fits, _), r in am.LUT_ROUTES.items()
            if not fits} == {"lut_matmul"}


@pytest.mark.parametrize("route,table,match", [
    ("lut_matmul_flat", "library", "unknown lut route"),
    ("lut_matmul_sm90", "wide", "16 bits"),
    ("lut_matmul_sm90", "library", "unsupported device"),
    ("lut_matmul", "library", "unsupported device"),
])
def test_launch_lut_refuses_what_no_kernel_takes(route, table, match):
    """A named route launches its kernel or raises: an unknown name, the
    shared route for a table wider than 16 bits, a CPU tensor (the plain
    version is ``lut_matmul_kernel``'s CPU path, never a launch's)."""
    t = (LIB["mul8u_bam6"].table if table == "library"
         else np.arange(65536, dtype=np.int32).reshape(256, 256) * 2)
    x, w = _operands(False, 4, 4, 4, seed=0)
    with pytest.raises(ValueError, match=match):
        am.launch_lut(route, _t(x), _t(w), am.PackedLut(t))


@pytest.mark.parametrize("form", ["tensor", "numpy", "packed"])
def test_lut_matmul_kernel_takes_every_table_form_on_cpu(form):
    c = LIB["mul8s_drum4"]
    table = c.table.astype(np.int32)
    x, w = _operands(True, 19, 23, 17, seed=5)
    given = {"tensor": _t(table), "numpy": table,
             "packed": am.PackedLut(table)}[form]
    got = am.lut_matmul_kernel(_t(x), _t(w), given, signed=True)
    assert torch.equal(got, am.lut_matmul(_t(x), _t(w), _t(table),
                                          signed=True))


# ---------------------------------------------------------------------------
# shared-memory banks
# ---------------------------------------------------------------------------

def _layout(name):
    """A thread layout of the kernel: 256 threads in (rows, cols), each
    ``tm`` rows strided by the thread rows and ``tn`` neighbouring
    columns, staged ``kc`` k-steps at a time."""
    cols, tm, tn = (CU[f"k{name}Cols"], CU[f"k{name}TM"], CU[f"k{name}TN"])
    rows = CU["kThreads"] // cols
    return dict(rows=rows, cols=cols, tm=tm, tn=tn, bm=rows * tm,
                bn=cols * tn, kc=CU[f"k{name}KC"])


WIDE, NARROW = _layout("Wide"), _layout("Narrow")


def _wavefronts(addrs) -> int:
    """Wavefronts of one warp-wide shared load: the most distinct 4-byte
    words that fall in one of the 32 banks (lanes reading one word share
    it)."""
    words = {int(a) >> 2 for a in addrs}
    per_bank = np.bincount([wd % 32 for wd in words], minlength=32)
    return int(per_bank.max())


def _block_wavefronts(lay, a, b, swizzle=_swizzle):
    """Wavefronts of every warp-wide lookup of a group of k-steps over one
    block's tile: ``a`` (bm, q) row indices, ``b`` (q, bn) column
    indices.  Lane l of warp v is thread t = 32 v + l at thread row
    t // cols and column t % cols, owning rows row + i * rows and columns
    tn * column + j, as in the kernel."""
    t = np.arange(32)
    out = []
    for v in range(CU["kThreads"] // 32):
        tr = (32 * v + t) // lay["cols"]
        tc = (32 * v + t) % lay["cols"]
        for q in range(a.shape[1]):
            for i in range(lay["tm"]):
                for j in range(lay["tn"]):
                    out.append(_wavefronts(swizzle(
                        a[tr + i * lay["rows"], q],
                        b[q, lay["tn"] * tc + j])))
    return out


def _mean_wavefronts(lay, kind, draws=10, seed=0, swizzle=_swizzle):
    rng = np.random.default_rng(seed)
    got = []
    for _ in range(draws):
        a = rng.integers(0, 256, (lay["bm"], CU["kKGroup"]))
        b = rng.integers(0, 256, (CU["kKGroup"], lay["bn"]))
        if kind == "constant column":       # lanes share b, differ in a
            b[:] = b[:, :1]
        got += _block_wavefronts(lay, a, b, swizzle)
    return float(np.mean(got))


def _unswizzled(a, b):
    return (a << CU["kRowShift"]) | (b << CU["kColShift"])


@pytest.mark.parametrize("layout", ["wide", "narrow"])
@pytest.mark.parametrize("kind", ["uniform", "constant column"])
def test_warp_lookups_take_at_most_4_wavefronts(layout, kind):
    lay = WIDE if layout == "wide" else NARROW
    assert _mean_wavefronts(lay, kind) <= 4.0


def test_swizzle_spreads_rows_that_share_a_column():
    """The narrow layout's 32 lanes read 32 rows at one column: unswizzled
    every lookup would take about 30 wavefronts (all in one bank, but
    where two lanes share a row), swizzled about 3.  In the wide layout
    the two thread rows of a warp look up the same columns."""
    narrow = _mean_wavefronts(NARROW, "constant column")
    assert narrow <= 4.0
    assert _mean_wavefronts(NARROW, "constant column",
                            swizzle=_unswizzled) >= 25.0
    assert (_mean_wavefronts(WIDE, "uniform")
            < _mean_wavefronts(WIDE, "uniform", swizzle=_unswizzled))


def test_layouts_fit_shared_memory():
    """The table, two stages of each layout's operands and the mbarrier
    within a block's 227 KB; n up to kNarrowMaxN takes the narrow one."""
    for lay in (WIDE, NARROW):
        stage = lay["bm"] * (lay["kc"] + CU["kPad"]) + lay["kc"] * lay["bn"]
        assert (CU["kTableBytes"] + CU["kAlign"] + 2 * 4 * stage + 16
                <= CU["kMaxSmem"] == 232448)
        assert lay["bm"] * lay["kc"] % (4 * CU["kThreads"]) == 0
    assert (WIDE["bm"], WIDE["bn"]) == (64, 32)
    assert NARROW["bn"] == 1 and CU["kNarrowMaxN"] < WIDE["bn"]


def test_conflict_free_smoke_operands_take_one_wavefront():
    """``chip_smoke.py``'s conflict-free row: one x for every row and each
    column its own bank, so every warp-wide lookup is one wavefront."""
    table = LIB["mul8u_bam6"].table.astype(np.int32)
    rng = np.random.default_rng(2)
    bm, bn, q = WIDE["bm"], WIDE["bn"], CU["kKGroup"]
    x, w = chip_smoke._lut_operands(rng, bm, 16, 2 * bn, False,
                                    "conflict-free", table)
    for c0 in (0, bn):
        for k0 in range(0, 16, q):
            got = _block_wavefronts(WIDE, x[:, k0:k0 + q],
                                    w[k0:k0 + q, c0:c0 + bn])
            assert max(got) == 1


def test_extreme_smoke_operands_reach_the_int32_edge():
    """``chip_smoke.py``'s long-k row: the first rows and columns sum the
    table's largest entry 33000 times, within 0.1% of 2^31."""
    table = LIB["mul8u_exact"].table.astype(np.int32)
    rng = np.random.default_rng(3)
    x, w = chip_smoke._lut_operands(rng, 4, 33000, 4, False, "extreme", table)
    got = am.lut_matmul(_t(x), _t(w), _t(table))
    assert int(got[0, 0]) == 33000 * 65025
    assert 2 ** 31 - int(got[0, 0]) < 2 ** 31 / 1000
