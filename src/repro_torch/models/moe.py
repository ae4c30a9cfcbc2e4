"""Feed-forward layers: the dense SwiGLU/GeGLU MLP and the
mixture-of-experts layer (top-k token-choice routing with GShard
capacity dispatch), the port of the JAX package's ``models/moe.py``.

The MoE layer keeps the JAX package's semantics exactly: the router
runs in float32 on the RMS-normed input, padded experts are masked out
of the softmax, the top-k gates are renormalised, and each expert takes
at most ``cap`` assignments of a routing group, all first choices
queued ahead of all second choices.  The JAX package dispatches and
combines with one-hot einsums; here the assignments are scattered into
the experts' slots and gathered back by index, which moves the same
rows (a dropped assignment lands in a spare slot that weighs 0).  The expert products run in bf16 (``torch.bmm``: the JAX
package computes them with plain einsums too, outside any Pallas
kernel).

The JAX package's ``moe_layer`` accepts a policy but never applies it to
the expert products, so the ``expert_in``/``expert_out`` genes of the
LM DSE move energy and never the logits.  The port keeps this: the
expert weights are stored bf16 under every policy and ``proj_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .approx_linear import ApproxPolicy, linear, param_dtypes
from .common import ParamModule, ParamSpec, act_fn, rms_norm
from .config import ModelConfig

__all__ = ["DenseMLP", "dense_mlp_param_specs", "MoE", "moe_param_specs",
           "moe_layer", "moe_forward", "moe_aux", "moe_routing", "Routing",
           "MOE_GROUP"]

_CLASSES = {"wi": "ffn_in", "wg": "ffn_in", "wo": "ffn_out"}

# a sequence longer than this (and a multiple of it) is routed in groups
# of this many tokens: the capacity, and the experts' slots, scale with
# the group's length, not the sequence's
MOE_GROUP = 4096


def dense_mlp_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": ParamSpec((d,), init="zeros", logical=("norm",)),
        "wi": ParamSpec((d, f), logical=("embed", "mlp")),
        "wg": ParamSpec((d, f), logical=("embed", "mlp")),
        "wo": ParamSpec((f, d), logical=("mlp", "embed")),
    }


class DenseMLP(ParamModule):
    def __init__(self, cfg: ModelConfig, policy: Optional[ApproxPolicy],
                 device, proj_dtype: Optional[torch.dtype] = None):
        specs = dense_mlp_param_specs(cfg)
        super().__init__(specs, param_dtypes(specs, _CLASSES, policy,
                                             proj_dtype), device)
        self.cfg = cfg
        self.policy = policy

    def forward(self, x: torch.Tensor, *,
                policy: Optional[ApproxPolicy] = None) -> torch.Tensor:
        cfg = self.cfg
        policy = self.policy if policy is None else policy
        h = rms_norm(x, self.norm, cfg.rms_eps)
        up = linear(h, self.wi, "ffn_in", policy)
        gate = act_fn(cfg.mlp_act)(linear(h, self.wg, "ffn_in", policy))
        return linear(up * gate, self.wo, "ffn_out", policy)


def moe_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.padded_experts
    return {
        "norm": ParamSpec((d,), init="zeros", logical=("norm",)),
        "router": ParamSpec((d, e), logical=("embed", None)),
        "wi": ParamSpec((e, d, f),
                        logical=("experts", "embed", "expert_mlp")),
        "wg": ParamSpec((e, d, f),
                        logical=("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((e, f, d),
                        logical=("experts", "expert_mlp", "embed")),
    }


# storage dtypes: the router and the norm float32, the experts bf16 (no
# policy reaches them)
_MOE_DTYPES = {"norm": torch.float32, "router": torch.float32,
               "wi": torch.bfloat16, "wg": torch.bfloat16,
               "wo": torch.bfloat16}


@dataclass
class Routing:
    """One routing of a group of tokens: each token's ``k`` chosen
    experts (``idx``, descending gate), their renormalised gates, each
    assignment's slot in its expert (``pos``, its rank among the group's
    assignments to that expert) and whether it fits the capacity."""

    probs: torch.Tensor    # (b, s, e) float32 softmax over padded experts
    gates: torch.Tensor    # (b, s, k) float32, renormalised
    idx: torch.Tensor      # (b, s, k) int64 expert of each choice
    pos: torch.Tensor      # (b, s, k) int64 slot in the expert
    keep: torch.Tensor     # (b, s, k) bool, pos < cap
    cap: int


def moe_routing(h: torch.Tensor, router: torch.Tensor,
                cfg: ModelConfig) -> Routing:
    """Route the normed tokens ``h`` (b, s, d): each row of ``b`` is one
    routing group."""
    b, s, _ = h.shape
    e, k = cfg.padded_experts, cfg.n_experts_active
    cap = max(int(s * k / e * cfg.capacity_factor), 1)
    logits = h.float() @ router.float()
    if e > cfg.n_experts:
        logits[..., cfg.n_experts:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts the lower expert first among equal
    # probabilities, as jax.lax.top_k does
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], order[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # the rank of each assignment in its expert's queue: k-th choices
    # are queued after all (k-1)-th choices of the group
    sel = F.one_hot(idx, e)                                  # (b, s, k, e)
    flat = sel.transpose(1, 2).reshape(b, k * s, e)
    rank = (torch.cumsum(flat, dim=1) - flat).reshape(b, k, s, e)
    pos = rank.transpose(1, 2).gather(-1, idx[..., None])[..., 0]
    return Routing(probs=probs, gates=gates, idx=idx, pos=pos,
                   keep=pos < cap, cap=cap)


def moe_aux(r: Routing, cfg: ModelConfig) -> torch.Tensor:
    """The Switch load-balance loss of one routing over the real experts
    (float32)."""
    n, k = cfg.n_experts, cfg.n_experts_active
    me = r.probs[..., :n].mean(dim=(0, 1))
    sel = F.one_hot(r.idx, cfg.padded_experts)[..., :n].to(torch.float32)
    ce = sel.sum(dim=2).mean(dim=(0, 1)) * n / k
    return (n * torch.sum(me * ce)).to(torch.float32)


def moe_forward(
    p: Mapping[str, torch.Tensor],
    x: torch.Tensor,                  # (b, s, d)
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Routing]:
    """(out, routing): the experts' combined output, in the type of ``x``
    promoted with bf16, and the routing it took (``moe_aux`` turns it
    into the load-balance loss where that is read)."""
    b0, s0, d = x.shape
    if MOE_GROUP and s0 > MOE_GROUP and s0 % MOE_GROUP == 0:
        x = x.reshape(b0 * (s0 // MOE_GROUP), MOE_GROUP, d)
    b, s, _ = x.shape
    e, k = cfg.padded_experts, cfg.n_experts_active
    h = rms_norm(x, p["norm"], cfg.rms_eps)
    r = moe_routing(h, p["router"], cfg)

    # dispatch: every assignment's token into its expert's slot; a
    # dropped one goes to the spare slot ``cap``, which weighs 0 in the
    # combine (no mask indexing, so no host sync)
    dev = x.device
    bf = torch.bfloat16
    bi = torch.arange(b, device=dev)[:, None, None].expand(b, s, k)
    slot = torch.where(r.keep, r.pos, r.cap)
    xin = torch.zeros((e, b, r.cap + 1, d), dtype=bf, device=dev)
    xin[r.idx, bi, slot] = h.to(bf)[:, :, None, :]
    xin = xin.reshape(e, b * (r.cap + 1), d)

    up = torch.bmm(xin, p["wi"].to(bf))
    gate = act_fn(cfg.mlp_act)(torch.bmm(xin, p["wg"].to(bf)))
    hout = torch.bmm(up * gate, p["wo"].to(bf)).reshape(e, b, r.cap + 1, d)
    del xin, up, gate

    # combine: each choice's expert row times its gate, rounded to x's
    # dtype first as the JAX package's combine weights are; a dropped
    # choice weighs 0
    w = (r.gates * r.keep).to(x.dtype).float()
    acc = torch.zeros((b, s, d), dtype=torch.float32, device=dev)
    for j in range(k):
        rows = hout[r.idx[..., j], bi[..., j], slot[..., j]]   # (b, s, d)
        acc += w[..., j, None] * rows.float()
    out = acc.to(torch.promote_types(x.dtype, bf))
    if (b, s) != (b0, s0):
        out = out.reshape(b0, s0, d)
    return out, r


def moe_layer(
    p: Mapping[str, torch.Tensor],
    x: torch.Tensor,                  # (b, s, d)
    cfg: ModelConfig,
    *,
    policy: Optional[ApproxPolicy] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, aux): ``moe_forward``'s output and the Switch load-balance
    loss over the real experts (float32).  ``policy`` is accepted and
    not applied, as in the JAX package."""
    del policy
    out, r = moe_forward(p, x, cfg)
    return out, moe_aux(r, cfg)


class MoE(ParamModule):
    """The mixture-of-experts feed-forward layer of one MoE position of
    ``block_pattern``; ``forward`` returns ``(out, routing)``: serving
    never reads the load-balance loss, so it is left to ``moe_aux``."""

    def __init__(self, cfg: ModelConfig, device):
        specs = moe_param_specs(cfg)
        super().__init__(specs, _MOE_DTYPES, device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, *,
                policy: Optional[ApproxPolicy] = None
                ) -> Tuple[torch.Tensor, Routing]:
        del policy
        p = {name: getattr(self, name) for name in self.specs}
        return moe_forward(p, x, self.cfg)
