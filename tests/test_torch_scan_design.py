"""The redesigned selective-scan and population-gather kernels' arithmetic
and tiling, modelled in plain torch on the CPU: the scan's states
grouped per thread, exp(dt * A) as exp2(dt * (A * log2 e)) with the
approximate exponential's error, and y summed in the kernel's shuffle
order, held against the JAX package's ``selective_scan_reference`` at
the JAX tests' tolerances; the gather's blocks of genomes and plane
spans, byte-equal to ``population_lut_gather_ref`` on ragged shapes.
The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.population_lut import population_lut_gather_ref as ref_pop
from repro.kernels.selective_scan import selective_scan_reference
from repro_torch._build import SRC_DIR
from repro_torch.kernels.population_lut import (
    population_lut_gather,
    population_lut_gather_ref,
)
from repro_torch.kernels.selective_scan import (
    KERNEL_MAX_STATE,
    selective_scan_kernel,
)

from _torch_threads import bounded_torch_threads  # noqa: F401

# chip_smoke.py's scan gates: tests/test_kernels_scan.py's tolerance at
# its shapes, 1e-4 over 1024 sequential steps
SCAN_TOL, SCAN_WIDE_TOL = 1e-5, 1e-4
LOG2E = 1.4426950408889634
# ex2.approx.f32: at most 2 ulp of relative error (PTX ISA)
EX2_REL_ERR = 2.0 ** -22


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

# threads per channel, 4 states each, for every n in 1..16
TPC = 4


def _scan_kernel_model(x, dt, A, B, C, h0, noise=None):
    """What ``csrc/selective_scan.cu`` computes, in float32 torch.  The
    channel's 16 states are 4 per thread (zeros past n); per step
    e = exp2(dt * (A * log2 e)) (times 1 + ``noise``, a (s, b, di, 16)
    array of relative errors), h = e h + (dt x) B, each thread's partial
    sum over its 4 states in order, then the butterfly's order across
    the channel's 4 threads."""
    b, s, di = x.shape
    n = A.shape[1]
    w = 4 * TPC

    def pad(t):
        out = torch.zeros(t.shape[:-1] + (w,))
        out[..., :n] = t
        return out

    a2 = pad(A * torch.tensor(LOG2E, dtype=torch.float32))
    Bp, Cp, h = pad(B), pad(C), pad(h0)
    ys = []
    for t in range(s):
        dtt = dt[:, t]
        e = torch.exp2(dtt[..., None] * a2[None])
        if noise is not None:
            e = e * (1 + torch.from_numpy(noise[t]))
        h = e * h + (dtt * x[:, t])[..., None] * Bp[:, t, None, :]
        prod = (h * Cp[:, t, None, :]).reshape(b, di, TPC, 4)
        p = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]) + prod[..., 3]
        ys.append((p[..., 0] + p[..., 2]) + (p[..., 1] + p[..., 3]))
    return torch.stack(ys, dim=1), h[..., :n]


def _scan_inputs(rng, b, s, di, n):
    """Drawn as ``_inputs`` in tests/test_kernels_scan.py."""
    return (rng.standard_normal((b, s, di)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, s, di)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, (di, n))).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            (rng.standard_normal((b, di, n)) * 0.1).astype(np.float32))


def _model_against_reference(b, s, di, n, tol, seed):
    rng = np.random.default_rng(seed)
    arrs = _scan_inputs(rng, b, s, di, n)
    y_r, h_r = selective_scan_reference(*(jnp.asarray(a) for a in arrs))
    noise = (rng.uniform(-1, 1, (s, b, di, 4 * TPC)) * EX2_REL_ERR).astype(
        np.float32)
    worst = 0.0
    for nz in (None, noise):
        y, hT = _scan_kernel_model(*(torch.from_numpy(a) for a in arrs),
                                   noise=nz)
        assert y.shape == (b, s, di) and hT.shape == (b, di, n)
        for got, want in ((y, y_r), (hT, h_r)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=tol, atol=tol)
            worst = max(worst, float(np.abs(got.numpy()
                                            - np.asarray(want)).max()))
    return worst


@pytest.mark.parametrize("b,s,di,n", [
    (1, 16, 8, 4), (2, 64, 32, 8), (1, 128, 16, 16),   # test_kernels_scan
    (2, 37, 13, 5), (1, 50, 6, 3), (1, 23, 9, 1),      # ragged, n 1..16
    (1, 40, 4, 13),
])
def test_scan_model_within_jax_tolerance(b, s, di, n):
    """At the JAX tests' shapes, and at step groups, tiles and state
    counts the kernel's tiling leaves ragged, within rtol/atol 1e-5."""
    _model_against_reference(b, s, di, n, SCAN_TOL, seed=s * 31 + n)


@pytest.mark.parametrize("n", [16, 5])
def test_scan_model_over_1024_steps(n):
    """1024 sequential steps, as falcon-mamba-7b's prefill runs them,
    within the wide gate; the approximate exponential's error stays an
    order of magnitude inside it."""
    worst = _model_against_reference(1, 1024, 48, n, SCAN_WIDE_TOL,
                                      seed=1024 + n)
    assert worst < SCAN_WIDE_TOL / 10


def _butterfly(p):
    """The lanes of ``reduce_steps`` in csrc/selective_scan.cu: p[q][j] is
    thread q's partial of step j; returns what each thread ends with."""
    v = []
    for q in range(4):
        r = q ^ 2
        keep = (p[q][2], p[q][3]) if q & 2 else (p[q][0], p[q][1])
        sent = (p[r][0], p[r][1]) if r & 2 else (p[r][2], p[r][3])
        v.append((keep[0] + sent[0], keep[1] + sent[1]))
    out = []
    for q in range(4):
        r = q ^ 1
        keep = v[q][1] if q & 1 else v[q][0]
        sent = v[r][0] if r & 1 else v[r][1]
        out.append(keep + sent)
    return out


@pytest.mark.parametrize("decades", [2, 4])
def test_scan_butterfly_leaves_step_q_with_thread_q(decades):
    """Thread q ends with the whole sum of step q, added in the order the
    model uses, (p0 + p2) + (p1 + p3), to the last bit, for partials
    spread over +-``decades`` orders of magnitude."""
    rng = np.random.default_rng(decades)
    for _ in range(100):
        scale = 10.0 ** rng.integers(-decades, decades + 1, (TPC, TPC))
        p = [[np.float32(v) for v in row]
             for row in rng.standard_normal((TPC, TPC)) * scale]
        got = _butterfly(p)
        for q in range(TPC):
            assert got[q] == (p[0][q] + p[2][q]) + (p[1][q] + p[3][q])


@pytest.mark.parametrize("n", [0, KERNEL_MAX_STATE + 1, 32])
def test_scan_kernel_refuses_state_sizes_it_cannot_take(n):
    b, s, di = 1, 4, 8
    x = torch.zeros((b, s, di))
    A = -torch.ones((di, n))
    Bc = torch.zeros((b, s, n))
    with pytest.raises(ValueError, match="state size"):
        selective_scan_kernel(x, x, A, Bc, Bc)


# ---------------------------------------------------------------------------
# population gather
# ---------------------------------------------------------------------------

def _cu_constants(path) -> dict:
    """The ``constexpr int`` constants of a kernel source, evaluated in
    order (each may name the ones before it)."""
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 Path(path).read_text()):
        env[name] = int(eval(expr, {"__builtins__": {}}, dict(env)))
    return env


_GATHER = _cu_constants(SRC_DIR / "population_lut.cu")
SPAN = _GATHER["kSpan"]


def genomes_per_block(S: int) -> int:
    """Genomes a block of ``csrc/population_lut.cu`` takes at S slots, as
    its ``genomes_per_block``; raises where the entry point refuses S (one
    genome's S rows do not fit in a block's shared memory)."""
    fit = _GATHER["kMaxSmem"] // (S * _GATHER["kRowInts"] * 4)
    if fit < 1:
        raise ValueError(f"S = {S}: {S} KB of LUT rows exceed a block's "
                         "shared memory")
    return min(_GATHER["kGenomes"], fit)


def _wrap(s, S):
    return torch.where(s == S, torch.zeros_like(s), s)


def _gather_tiling_model(lut, genes, cols, per_genome):
    """What ``csrc/population_lut.cu`` computes, block by block: a block
    stages the selected rows of ``genomes_per_block(S)`` genomes, then
    covers one SPAN of the flat (M * S) plane, 4 consecutive elements a
    thread (slots by wrapping increments) where the plane is a multiple
    of 4, one element a thread otherwise.  Fails if an element is
    written twice or never."""
    C, S, _ = lut.shape
    G = genes.shape[0]
    P = cols.shape[-2] * S
    bg = genomes_per_block(S)
    cflat = cols.reshape(G, P) if per_genome else cols.reshape(P)
    out = torch.zeros((G, P), dtype=lut.dtype)
    writes = torch.zeros((G, P), dtype=torch.int32)
    sl = torch.arange(S)
    for g0 in range(0, G, bg):
        ng = min(bg, G - g0)
        rows = lut[genes[g0:g0 + ng].long(), sl]           # (ng, S, 256)
        gl = torch.arange(ng)[:, None, None]
        for e0 in range(0, P, SPAN):
            e1 = min(e0 + SPAN, P)
            if P % 4 == 0:
                e = torch.arange(e0, e1, 4)
                s4 = [e % S]
                for _ in range(3):
                    s4.append(_wrap(s4[-1] + 1, S))
                s = torch.stack(s4, dim=1)                 # (chunks, 4)
                idx = e[:, None] + torch.arange(4)
            else:
                idx = torch.arange(e0, e1)[:, None]
                s = idx % S
            c = (cflat[g0:g0 + ng][:, idx] if per_genome
                 else cflat[idx][None].expand(ng, -1, -1))
            assert int(c.min()) >= 0 and int(c.max()) < 256
            out[g0:g0 + ng, idx] = rows[gl, s[None], c.long()]
            writes[g0:g0 + ng, idx] += 1
    assert bool((writes == 1).all())
    return out.reshape(G, -1, S)


@pytest.mark.parametrize("per_genome", [False, True])
@pytest.mark.parametrize("G,M,S", [
    (7, 911, 9),     # G no multiple of 4; plane 8199: ragged, 2 spans
    (9, 912, 9),     # plane 8208, a multiple of 4, 2 spans
    (5, 256, 3),     # tests/test_torch_kernels.py's shape
    (3, 40, 100),    # 100 KB of rows a genome: 2 genomes a block
])
def test_gather_tiling_byte_equal(G, M, S, per_genome):
    rng = np.random.default_rng(G * M + S)
    C = 5
    lut = rng.integers(-40000, 70000, size=(C, S, 256)).astype(np.int32)
    genes = rng.integers(0, C, size=(G, S)).astype(np.int32)
    cols = rng.integers(0, 256, size=(G, M, S) if per_genome
                        else (M, S)).astype(np.int32)
    want = ref_pop(lut, genes, cols, per_genome=per_genome)
    t = [torch.from_numpy(a) for a in (lut, genes, cols)]
    got = _gather_tiling_model(*t, per_genome)
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == want.astype(np.int32).tobytes()
    plain = population_lut_gather_ref(*t, per_genome=per_genome)
    assert torch.equal(got, plain)
    assert torch.equal(population_lut_gather(*t, per_genome=per_genome),
                       plain)


def test_gather_tiling_genomes_per_block():
    assert genomes_per_block(9) == 4       # gaussian3x3: 36 KB of rows
    assert genomes_per_block(56) == 4      # 224 KB, the most that fits 4
    assert genomes_per_block(57) == 3
    assert genomes_per_block(227) == 1
    with pytest.raises(ValueError, match="shared memory"):
        genomes_per_block(228)
