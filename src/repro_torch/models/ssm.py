"""Mamba-1 selective-SSM layer.

Parameterization follows Mamba-1 (falcon-mamba): in_proj -> (x, z),
depthwise causal conv (k=4), x_proj -> (dt, B, C), dt via softplus,
A = -exp(A_log), y = C.h + D*x, out = out_proj(y * silu(z)).

Prefill runs the selective-scan kernel over the whole prompt and keeps
the post-prompt state; decode is the one-step recurrence in plain
PyTorch against a (conv, ssm) cache, as in the JAX package.  A training
forward (no cache, under grad) on the card goes through the scan's
autograd function (``kernels.selective_scan.SelectiveScan``): the
forward kernel with its chunk states, and the backward kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import selective_scan
from .approx_linear import ApproxPolicy, linear, param_dtypes
from .common import ParamModule, ParamSpec, rms_norm, silu
from .config import ModelConfig

__all__ = ["Mamba", "mamba_param_specs", "init_mamba_cache"]

_CLASSES = {"in_proj": "ssm_in", "x_proj": "ssm_out", "dt_proj": "ssm_out",
            "out_proj": "ssm_out"}


def mamba_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di = cfg.d_model, cfg.d_inner
    n, dtr, ck = cfg.ssm_state, cfg.resolved_dt_rank, cfg.ssm_conv
    return {
        "norm": ParamSpec((d,), init="zeros", logical=("norm",)),
        "in_proj": ParamSpec((d, 2 * di), logical=("embed", "mlp")),
        "conv_w": ParamSpec((ck, di), scale=0.1, logical=("conv", "mlp")),
        "conv_b": ParamSpec((di,), init="zeros", logical=("mlp",)),
        "x_proj": ParamSpec((di, dtr + 2 * n), logical=("mlp", None)),
        "dt_proj": ParamSpec((dtr, di), logical=("dt", "mlp")),
        "dt_bias": ParamSpec((di,), init="ones", scale=1.0,
                             logical=("mlp",)),
        "A_log": ParamSpec((di, n), init="ones", logical=("mlp", "state")),
        "D": ParamSpec((di,), init="ones", logical=("mlp",)),
        "out_proj": ParamSpec((di, d), logical=("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds.  x: (b, s, di), w: (k, di)."""
    k = w.shape[0]
    s = x.shape[1]
    out = x * w[-1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[-1 - i]
    return out + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))   # jax.nn.softplus


class Mamba(ParamModule):
    def __init__(self, cfg: ModelConfig, policy: Optional[ApproxPolicy],
                 device, proj_dtype: Optional[torch.dtype] = None):
        specs = mamba_param_specs(cfg)
        super().__init__(specs, param_dtypes(specs, _CLASSES, policy,
                                             proj_dtype), device)
        self.cfg = cfg
        self.policy = policy

    def forward(
        self,
        x: torch.Tensor,                                 # (b, s, d)
        *,
        cache: Optional[Dict[str, torch.Tensor]] = None,
        decode: bool = False,
        impl: str = "kernel",
        policy: Optional[ApproxPolicy] = None,
    ) -> torch.Tensor:
        """cache: {"conv": (b, k-1, di), "ssm": (b, di, n)} float32,
        updated in place.  Modes: cache None -> plain forward; cache +
        decode False -> prefill (scan kernel, post-prompt state kept);
        cache + decode True -> one-step recurrence (s == 1).  ``policy``,
        where given, replaces the one the layer was built with."""
        cfg = self.cfg
        policy = self.policy if policy is None else policy
        n = cfg.ssm_state
        dtr = cfg.resolved_dt_rank
        h = rms_norm(x, self.norm, cfg.rms_eps)
        xz = linear(h, self.in_proj, "ssm_in", policy)
        x_in, z = torch.chunk(xz, 2, dim=-1)

        if not decode:
            xc = _causal_conv(x_in.float(), self.conv_w.float(),
                              self.conv_b.float())
        else:
            window = torch.cat([cache["conv"], x_in.float()], dim=1)
            xc = (torch.einsum("bki,ki->bi", window, self.conv_w.float())
                  + self.conv_b)[:, None]
            new_conv = window[:, 1:]
        xc = silu(xc)

        proj = linear(xc.to(x.dtype), self.x_proj, "ssm_out", policy)
        dt_raw = proj[..., :dtr]
        Bc = proj[..., dtr:dtr + n].float()
        Cc = proj[..., dtr + n:].float()
        dt = _softplus(
            linear(dt_raw, self.dt_proj, "ssm_out", policy).float()
            + self.dt_bias)
        A = -torch.exp(self.A_log.float())

        if not decode:
            h0 = cache["ssm"] if cache is not None else None
            y, h_final = selective_scan(xc, dt, A, Bc, Cc, h0, impl=impl)
            if cache is not None:        # prefill: persist post-prompt state
                k1 = cfg.ssm_conv - 1
                tail = x_in.float()[:, -k1:, :]
                cache["conv"][:, k1 - tail.shape[1]:] = tail
                cache["ssm"].copy_(h_final)
        else:
            a = torch.exp(dt[:, 0, :, None] * A[None])          # (b, di, n)
            bx = (dt[:, 0] * xc[:, 0])[..., None] * Bc[:, 0, None, :]
            hnew = a * cache["ssm"] + bx
            y = torch.einsum("bin,bn->bi", hnew, Cc[:, 0])[:, None]
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(hnew)

        y = y + xc * self.D.float()
        y = (y * silu(z.float())).to(x.dtype)
        return linear(y, self.out_proj, "ssm_out", policy)


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    di, n, ck = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((batch, ck - 1, di), dtype=torch.float32,
                            device=device),
        "ssm": torch.zeros((batch, di, n), dtype=torch.float32,
                           device=device),
    }
