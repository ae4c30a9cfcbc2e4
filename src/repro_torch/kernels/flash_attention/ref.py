"""Plain PyTorch versions of the flash-attention forward and backward.

Masked softmax attention with GQA and a causal mask shifted by
``q_offset``: the CPU path of ``ops.attention`` and the version the CUDA
kernels are held against on the card.

It follows the JAX package's Pallas kernel (``flash_attention_fwd``):
q is cast to float32 first and then scaled by ``d**-0.5`` in float32;
scores, max, exp and sums are float32; masked scores are ``-1e30``; the
output is ``acc / max(l, 1e-30)`` cast to q's dtype.  The JAX package's
chunked path (``chunked_attention``, which its model code runs) scales
in the input dtype before the cast instead, so on bf16 inputs the two
differ by one bf16 rounding of ``q * scale``; the model-level tolerance
absorbs it.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_bwd_ref", "attention_lse_ref",
           "NEG_INF"]

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,          # (b, h, sq, d)
    k: torch.Tensor,          # (b, kvh, sk, d)
    v: torch.Tensor,          # (b, kvh, sk, d)
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """(b, h, sq, d) in q's dtype.  Query head ``i`` reads kv head
    ``i // (h // kvh)``; no repeated copy of k/v is made."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = d ** -0.5
    qg = q.float().reshape(b, kvh, rep, sq, d) * scale
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float())
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, sq, d).to(q.dtype)


def attention_lse_ref(
    q: torch.Tensor,          # (b, h, sq, d)
    k: torch.Tensor,          # (b, kvh, sk, d)
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """(b, h, sq) float32: each query row's log-sum-exp (natural log) of
    its scaled, masked scores, as ``attention_ref`` forms them; what the
    tensor-core forward kernel writes for the backward."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, sq, d) * d ** -0.5
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float())
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def attention_bwd_ref(
    q: torch.Tensor,          # (b, h, sq, d)
    k: torch.Tensor,          # (b, kvh, sk, d)
    v: torch.Tensor,          # (b, kvh, sk, d)
    dout: torch.Tensor,       # (b, h, sq, d)
    *,
    causal: bool = True,
) -> tuple:
    """(dq, dk, dv) in the inputs' dtypes: autograd through
    ``attention_ref`` on float32 copies at q_offset 0, the version the
    backward kernels (``csrc/flash_attention_bwd.cu``,
    ``csrc/flash_attention_bwd_sm90.cu``) are held against."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_(True)
                      for t in (q, k, v))
        out = attention_ref(qf, kf, vf, causal=causal)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
