"""Shared model building blocks: parameter specs and their seeded
initialisation, RMSNorm, RoPE, activations.

``ParamSpec`` declares a parameter's shape and initialiser once;
``init_params`` draws it from an explicit ``torch.Generator`` with the
distributions of the JAX package's ``init_tree`` (normal x scale, zeros,
ones).  The two frameworks draw different numbers from the same seed:
tests carry the JAX package's parameters across as numpy
(``convert.lm_params_from_numpy``) instead of re-drawing them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ParamSpec",
    "ParamModule",
    "init_params",
    "rms_norm",
    "make_rope",
    "apply_rope",
    "act_fn",
    "silu",
]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float = 0.02
    # each dimension's logical axis name (the JAX package's), which
    # dist.sharding resolves to mesh axes; () where none is declared
    logical: Tuple[Optional[str], ...] = ()


def init_params(
    specs: Mapping[str, ParamSpec],
    seed: int,
    device,
    *,
    out: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Materialise ``specs`` (in their iteration order) from one
    ``torch.Generator`` seeded with ``seed`` on ``device``.

    A normal draw is float32 times ``scale``, then cast to the storage
    dtype, as ``init_tree`` casts to the spec's dtype.  With ``out``, each
    tensor of that dict is filled in place (its dtype is the storage
    dtype) and no second copy of the weights is held; without it, float32
    tensors are returned."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    res: Dict[str, torch.Tensor] = {} if out is None else out
    for name, spec in specs.items():
        dst = res.get(name) if out is not None else None
        if dst is None:
            dst = torch.empty(spec.shape, dtype=torch.float32, device=device)
            res[name] = dst
        if tuple(dst.shape) != tuple(spec.shape):
            raise ValueError(f"{name}: tensor {tuple(dst.shape)} vs spec "
                             f"{tuple(spec.shape)}")
        if spec.init == "zeros":
            dst.zero_()
        elif spec.init == "ones":
            dst.fill_(1.0)
        elif spec.init == "normal":
            draw = torch.randn(spec.shape, generator=gen, device=device,
                               dtype=torch.float32)
            dst.copy_(draw.mul_(spec.scale))
            del draw
        else:
            raise ValueError(f"{name}: unknown init {spec.init!r}")
    return res


class ParamModule(nn.Module):
    """A layer whose parameters are declared by ParamSpecs (stored in
    the dtype ``dtypes`` gives, uninitialised until the model is seeded
    or loaded)."""

    def __init__(self, specs: Mapping[str, ParamSpec],
                 dtypes: Mapping[str, torch.dtype], device):
        super().__init__()
        self.specs = specs
        for name, spec in specs.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(spec.shape, dtype=dtypes[name], device=device),
                requires_grad=False))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    # x * sigmoid(x) in x's dtype, two roundings, as jax.nn.silu
    return x * torch.sigmoid(x)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def act_fn(name: str):
    return {"silu": silu, "gelu": _gelu, "relu": torch.relu}[name]


def make_rope(head_dim: int, theta: float = 10000.0,
              fraction: float = 1.0) -> np.ndarray:
    """Inverse-frequency vector (rot_dim//2,); cos/sin are computed on
    the fly from positions.  fraction < 1 rotates only the first
    ``fraction*head_dim`` dims."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    return (1.0 / (theta ** (np.arange(0, rot, 2) / rot))).astype(np.float32)


def apply_rope(
    x: torch.Tensor,                           # (b, h, s, d)
    inv_freq: torch.Tensor,                    # (rot//2,) float32
    positions: Optional[torch.Tensor] = None,  # (s,) or (b, s); None=arange
) -> torch.Tensor:
    b, h, s, d = x.shape
    rot2 = inv_freq.shape[0]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    ang = positions[..., :, None].float() * inv_freq
    c, sn = torch.cos(ang), torch.sin(ang)
    if c.dim() == 2:
        c, sn = c[None, None], sn[None, None]
    else:
        c, sn = c[:, None], sn[:, None]
    xr = x[..., : 2 * rot2].float().reshape(b, h, s, rot2, 2)
    x1, x2 = xr[..., 0], xr[..., 1]
    rotated = torch.stack([x1 * c - x2 * sn, x1 * sn + x2 * c], dim=-1)
    rotated = rotated.reshape(b, h, s, 2 * rot2).to(x.dtype)
    return torch.cat([rotated, x[..., 2 * rot2:]], dim=-1)
