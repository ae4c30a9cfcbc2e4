"""The tensor-core attention backward's design, modelled in plain torch.

``csrc/flash_attention_bwd_sm90.cu`` runs only on the card, where
``chip_smoke.py`` holds it against autograd through the plain forward.
Here, where nothing can launch a kernel, the parts of its design that
decide whether that can hold are checked one by one:

- its partition: every visible (query, key) pair of a causal GQA/MQA
  case is visited exactly once by the dK/dV CTAs (one per key tile,
  query head and batch row, from the diagonal on) and once by the dQ
  CTAs, and the dK/dV grid launches its heaviest tiles first;
- its reduction: per-query-head float32 partials of dK and dV, summed
  in ascending head order, give the plain dK and dV;
- its roundings (P and dS rounded once to bf16, D from the bf16 forward
  output, lse from the forward) sit inside the chip's bf16 gate;
- ``ops.py``'s backward routes, the log-sum-exp that the autograd
  function hands from the forward to the backward, and the refusal of a
  CUDA tensor that comes without it (the device check mocked).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import repeat_kv
from repro_torch import _build
from repro_torch.kernels.flash_attention import (
    BWD_HEAD_DIMS,
    BWD_ROUTES,
    KERNEL_ROUTES,
    attention,
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
    bwd_route,
    flash_attention_bwd_kernel,
)
from repro_torch.kernels.flash_attention import ops as flash_ops

from _torch_threads import bounded_torch_threads  # noqa: F401

# chip_smoke.py's gate for the bf16 backward rows: rtol, and atol as a
# fraction of the largest element of the plain gradient
GATE_RTOL, GATE_FRAC = 2 ** -6, 2 ** -7
TILE = 64   # keys a dK/dV CTA, queries a dK/dV step, keys a dQ step


def _dq_rows_per_cta(d: int) -> int:
    """Query rows a dQ CTA: one consumer warpgroup at d = 256, two below
    (``DqCfg``)."""
    return TILE * (1 if d == 256 else 2)


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------

def _visible(s: int, causal: bool) -> torch.Tensor:
    """(s, s) bool, [query, key]: the pairs the mask leaves visible."""
    vis = torch.ones((s, s), dtype=torch.bool)
    return torch.tril(vis) if causal else vis


def _dkdv_visits(b, h, s, causal):
    """The dK/dV grid as the kernel walks it: CTA ``x`` of a 1-d grid is
    (key tile x // (b h), query head and batch row x % (b h)); it loops
    over query tiles from the diagonal (causal) or 0 to the end.  Yields
    (cta, batch, head, key tile, query tile)."""
    nt = (s + TILE - 1) // TILE
    for x in range(nt * b * h):
        bh, kt = x % (b * h), x // (b * h)
        for qt in range(kt if causal else 0, nt):
            yield x, bh // h, bh % h, kt, qt


def _dq_visits(b, h, s, d, causal):
    """The dQ grid: CTA ``x`` is (query tile nq - 1 - x // (b h), ...),
    each of its warpgroups 64 rows; a warpgroup skips key tiles past its
    last row's diagonal.  Yields (batch, head, query rows, key tile)."""
    bq = _dq_rows_per_cta(d)
    nq = (s + bq - 1) // bq
    for x in range(nq * b * h):
        bh = x % (b * h)
        q0 = (nq - 1 - x // (b * h)) * bq
        kend = min(s, q0 + bq) if causal else s
        for wg in range(bq // TILE):
            first = q0 + wg * TILE
            if first >= s:
                continue
            last = min(first + TILE - 1, s - 1)
            for t in range((kend + TILE - 1) // TILE):
                if not causal or t * TILE <= last:
                    yield bh // h, bh % h, (first, last + 1), t


@pytest.mark.parametrize("b,h,kvh,s,d,causal", [
    (1, 8, 1, 200, 256, True),     # MQA, ragged (200 = 3 x 64 + 8)
    (2, 8, 2, 256, 128, True),     # GQA 8/2
    (1, 4, 2, 130, 64, False),     # non-causal, ragged
])
def test_every_visible_pair_is_visited_once(b, h, kvh, s, d, causal):
    vis = _visible(s, causal)
    kv = torch.zeros((b, h, s, s), dtype=torch.int32)   # [.., query, key]
    for _, bi, hi, kt, qt in _dkdv_visits(b, h, s, causal):
        q = slice(qt * TILE, min(s, qt * TILE + TILE))
        k = slice(kt * TILE, min(s, kt * TILE + TILE))
        # the kernel masks P to 0 on the pairs the mask hides
        kv[bi, hi, q, k] += vis[q, k].int()
    assert torch.equal(kv, vis.int().expand(b, h, s, s))
    dq = torch.zeros_like(kv)
    for bi, hi, (r0, r1), t in _dq_visits(b, h, s, d, causal):
        k = slice(t * TILE, min(s, t * TILE + TILE))
        dq[bi, hi, r0:r1, k] += vis[r0:r1, k].int()
    assert torch.equal(dq, vis.int().expand(b, h, s, s))


def test_dkdv_grid_launches_heaviest_tiles_first():
    """gemma-2b's micro-batch (b=4, H=8, s=1024): 16 x 8 x 4 = 512 CTAs,
    one a (key tile, query head, batch row), their causal work (query
    tiles) non-increasing in launch order."""
    b, h, s = 4, 8, 1024
    work = {}
    for x, *_ in _dkdv_visits(b, h, s, True):
        work[x] = work.get(x, 0) + 1
    assert len(work) == 512
    order = [work[x] for x in sorted(work)]
    assert order == sorted(order, reverse=True)
    assert order[0] == 16 and order[-1] == 1


# ---------------------------------------------------------------------------
# the reduction, and the roundings
# ---------------------------------------------------------------------------

def _per_head_terms(q, k, v, do, *, lse, o, causal=True, bf16_ops=False):
    """Per query head, in float32: P = exp(scale q.k - lse), dP = dO.v,
    D = rowsum(dO * O), dS = P (dP - D); with ``bf16_ops`` P and dS
    rounded once to bf16 before their products, as the kernel's wgmma
    operands are.  Returns (dq, dk per head, dv per head)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    scale = d ** -0.5
    qf, dof = q.float(), do.float()
    kr = k.float().repeat_interleave(h // kvh, 1)
    vr = v.float().repeat_interleave(h // kvh, 1)
    vis = _visible(s, causal)
    sc = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    p = torch.where(vis, torch.exp(sc - lse[..., None]), torch.zeros(()))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if bf16_ops:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk_h = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv_h = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq, dk_h, dv_h


def _group_sum(part: torch.Tensor, kvh: int) -> torch.Tensor:
    """The reduce launch: group g's query heads g rep .. g rep + rep - 1
    summed in ascending order, in float32."""
    b, h, s, d = part.shape
    rep = h // kvh
    out = part[:, 0::rep].clone()
    for r in range(1, rep):
        out = out + part[:, r::rep]
    return out


def _inputs(b, h, kvh, s, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for shape in ((b, h, s, d), (b, kvh, s, d),
                                     (b, kvh, s, d), (b, h, s, d))]


@pytest.mark.parametrize("b,h,kvh,s,d", [(1, 8, 1, 96, 64),
                                         (2, 6, 2, 80, 128)])
def test_head_partials_summed_in_order_are_the_plain_gradient(b, h, kvh, s,
                                                              d):
    q, k, v, do = _inputs(b, h, kvh, s, d, seed=s)
    o = attention_ref(q, k, v, causal=True)
    lse = attention_lse_ref(q, k, causal=True)
    dq, dk_h, dv_h = _per_head_terms(q, k, v, do, lse=lse, o=o)
    want = attention_bwd_ref(q, k, v, do, causal=True)
    # float32 both ways, P = exp(s - lse) here and softmax's autograd
    # there: float32 roundings apart, 1e-4 of the largest gradient (a
    # wrong partition or a head summed twice is off by O(1))
    for got, w in zip((dq, _group_sum(dk_h, kvh), _group_sum(dv_h, kvh)),
                      want):
        torch.testing.assert_close(got, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def test_kernel_roundings_sit_inside_the_bf16_gate():
    """(b, H, KVH, s, d) = (1, 8, 1, 256, 256), bf16 inputs: the kernel's
    arithmetic (lse from the forward, D from the bf16 output, bf16 P and
    dS into their products, per-head float32 partials summed in order,
    outputs rounded once to bf16) against autograd through the plain
    forward in float32, under chip_smoke.py's gate.  The margin is the
    largest |got - want| / (atol + rtol |want|): at most 1 passes."""
    q, k, v, do = _inputs(1, 8, 1, 256, 256, seed=0, dtype=torch.bfloat16)
    o = attention_ref(q, k, v, causal=True)            # bf16, as the kernel's
    lse = attention_lse_ref(q, k, causal=True)
    dq, dk_h, dv_h = _per_head_terms(q, k, v, do, lse=lse, o=o,
                                     bf16_ops=True)
    got = (dq.bfloat16(), _group_sum(dk_h, 1).bfloat16(),
           _group_sum(dv_h, 1).bfloat16())
    want = attention_bwd_ref(q, k, v, do, causal=True)
    margins = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        atol = GATE_FRAC * float(w.abs().max())
        margins.append(float(((g - w).abs() / (atol + GATE_RTOL * w.abs()))
                             .max()))
    print(f"bf16 backward model: gate margins dq, dk, dv = {margins}")
    assert max(margins) <= 1.0


def test_lse_reference_matches_logsumexp_of_jax_scores():
    """``attention_lse_ref`` (what the forward kernel's log-sum-exp is held
    to on the card) is the natural-log logsumexp of the scaled, causally
    masked scores, here formed in JAX with the JAX package's GQA
    expansion; and exp(s - lse) sums to one on every row."""
    q, k, _, _ = _inputs(1, 4, 2, 48, 64, seed=3)
    got = attention_lse_ref(q, k, causal=True, q_offset=5)
    kr = repeat_kv(jnp.asarray(k.numpy()), 2)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q.numpy()), kr) * 64 ** -0.5
    mask = jnp.arange(48)[None, :] <= jnp.arange(48)[:, None] + 5
    want = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    sc = torch.from_numpy(np.array(jnp.where(mask, s, -1e30)))
    rows = torch.exp(sc - got[..., None]).sum(-1)
    torch.testing.assert_close(rows, torch.ones_like(rows))


# ---------------------------------------------------------------------------
# ops.py: the backward routes and the log-sum-exp hand-over
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", BWD_HEAD_DIMS)
def test_backward_routes(d):
    assert bwd_route(torch.bfloat16, d) == "flash_attention_bwd_sm90"
    assert bwd_route(torch.float32, d) == "flash_attention_bwd"
    # the tensor-core backward follows the tensor-core forward
    assert KERNEL_ROUTES[(torch.bfloat16, d)] == "flash_attention_sm90"
    assert set(BWD_ROUTES.values()) <= set(_build.KERNELS)
    assert set(BWD_ROUTES.values()) <= set(_build.LAUNCHES)


@pytest.mark.parametrize("dtype,d", [(torch.float16, 128),
                                     (torch.bfloat16, 96),
                                     (torch.float32, 512)])
def test_backward_route_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError, match="no flash-attention backward"):
        bwd_route(dtype, d)


def test_cuda_tensor_without_the_forward_lse_raises(monkeypatch):
    """The device check mocked to pass a CPU tensor as a CUDA one: the
    tensor-core route refuses before any launch when the forward's lse
    is missing or of the wrong shape."""
    launched = []
    monkeypatch.setattr(flash_ops, "_require_cuda", lambda t: None)
    monkeypatch.setattr(_build, "call", lambda *a: launched.append(a))
    q, k, v, do = _inputs(1, 4, 2, 16, 64, seed=1, dtype=torch.bfloat16)
    out = attention_ref(q, k, v)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_bwd_kernel(q, k, v, out, do)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_attention_bwd_kernel(q, k, v, out, do,
                                   lse=torch.zeros((1, 4, 15)))
    assert launched == []


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_hands_the_forward_lse_to_the_backward(monkeypatch, dtype):
    """``FlashAttention`` on the card (the device check and both kernels
    mocked by their plain versions): the bf16 route asks the forward for
    its log-sum-exp and passes it to the backward; float32 passes none."""
    seen = {}

    def fwd(q, k, v, *, causal=True, q_offset=0, with_lse=False):
        seen["with_lse"] = with_lse
        out = attention_ref(q, k, v, causal=causal)
        return (out, attention_lse_ref(q, k, causal=causal)) if with_lse \
            else out

    def bwd(q, k, v, out, dout, *, causal=True, lse=None):
        seen["lse"] = lse
        return attention_bwd_ref(q, k, v, dout, causal=causal)

    monkeypatch.setattr(flash_ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(flash_ops, "flash_attention_kernel", fwd)
    monkeypatch.setattr(flash_ops, "flash_attention_bwd_kernel", bwd)
    q, k, v, do = _inputs(1, 4, 2, 24, 64, seed=2, dtype=dtype)
    for t in (q, k, v):
        t.requires_grad_(True)
    attention(q, k, v, causal=True).backward(do)
    bf16 = dtype == torch.bfloat16
    assert seen["with_lse"] is bf16
    if bf16:
        torch.testing.assert_close(seen["lse"],
                                   attention_lse_ref(q.detach(), k.detach()))
    else:
        assert seen["lse"] is None
    want = attention_bwd_ref(q.detach(), k.detach(), v.detach(), do)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g, w)
