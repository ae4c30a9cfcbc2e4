"""Feed-forward layers.  Only the dense SwiGLU/GeGLU MLP is ported so
far; the mixture-of-experts layer comes with the MoE families."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .approx_linear import ApproxPolicy, linear, param_dtypes
from .common import ParamModule, ParamSpec, act_fn, rms_norm
from .config import ModelConfig

__all__ = ["DenseMLP", "dense_mlp_param_specs"]

_CLASSES = {"wi": "ffn_in", "wg": "ffn_in", "wo": "ffn_out"}


def dense_mlp_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": ParamSpec((d,), init="zeros"),
        "wi": ParamSpec((d, f)),
        "wg": ParamSpec((d, f)),
        "wo": ParamSpec((f, d)),
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
