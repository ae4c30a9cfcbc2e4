"""The DSE-selectable approximate projection of the LM stack.

Every heavy projection calls ``linear(x, w, cls, policy)`` with a
*projection class* name ("qkv", "attn_out", "ffn_in", "ffn_out",
"expert_in", "expert_out", "ssm_in", "ssm_out", "lm_head").  An
``ApproxPolicy`` maps classes to (circuit, rank): such projections run
as an int8-quantized matmul plus the rank-r ``U[x] . V[w]`` correction
of the circuit's error table; unmapped classes run exact bf16.

The approximate route follows the JAX package's ``_approx_matmul_nd``
(``models/approx_linear.py``), which computes the correction with a
gather and an einsum outside any Pallas kernel, so here it is plain
PyTorch too.

Weights are stored in the dtype their route needs (``weight_dtype``):
bf16 for the exact route, whose every use casts to bf16 first (a
one-time cast gives the same bits), float32 where a policy quantizes
them.  A model that serves more than one policy (``accel.lm``) stores
every projection float32 (``proj_dtype``), as the JAX package keeps its
one float32 parameter tree: the exact route then casts at use, which
gives the bits of bf16 storage.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..kernels.approx_matmul import from_circuit, quantize_sym

__all__ = ["ApproxPolicy", "linear", "weight_dtype", "param_dtypes",
           "PROJ_CLASSES"]

PROJ_CLASSES = (
    "qkv",
    "attn_out",
    "ffn_in",
    "ffn_out",
    "expert_in",
    "expert_out",
    "ssm_in",
    "ssm_out",
    "lm_head",
)


@dataclass(frozen=True)
class ApproxPolicy:
    """class name -> (circuit_name, rank|None).  Specs are resolved once
    at construction from the port's circuit library; each spec's U/V
    factors are uploaded once per device."""

    assignments: Mapping[str, Tuple[str, Optional[int]]] = field(
        default_factory=dict
    )
    _specs: Dict[str, object] = field(default_factory=dict, compare=False)
    _factors: Dict[tuple, tuple] = field(default_factory=dict, compare=False)

    def __post_init__(self):
        from ..core.acl.library import default_library

        lib = default_library()
        specs = {}
        for cls, (name, rank) in self.assignments.items():
            if cls not in PROJ_CLASSES:
                raise ValueError(f"unknown projection class {cls!r}")
            c = lib[name]
            if c.kind != "mul8s":
                raise ValueError(
                    f"LM projections quantize to signed int8; {name} is "
                    f"{c.kind}")
            specs[cls] = from_circuit(c, rank)
        object.__setattr__(self, "_specs", specs)

    def spec(self, cls: str):
        return self._specs.get(cls)

    @staticmethod
    def exact() -> "ApproxPolicy":
        return ApproxPolicy({})

    def factors(self, cls: str, device: torch.device):
        """(U, V) of ``cls``'s spec as float32 tensors on ``device``."""
        key = (cls, str(device))
        uv = self._factors.get(key)
        if uv is None:
            sp = self._specs[cls]
            uv = tuple(torch.as_tensor(t, dtype=torch.float32).to(device)
                       for t in (sp.u, sp.v))
            self._factors[key] = uv
        return uv


def weight_dtype(cls: str, policy: Optional[ApproxPolicy],
                 proj_dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """Storage dtype of a projection weight of class ``cls``:
    ``proj_dtype`` where given, else by the route ``policy`` gives it."""
    if proj_dtype is not None:
        return proj_dtype
    if policy is not None and policy.spec(cls) is not None:
        return torch.float32
    return torch.bfloat16


def param_dtypes(specs: Mapping[str, object], classes: Mapping[str, str],
                 policy: Optional[ApproxPolicy],
                 proj_dtype: Optional[torch.dtype] = None,
                 ) -> Dict[str, torch.dtype]:
    """Storage dtype of each parameter: projections by ``weight_dtype``,
    everything else float32."""
    return {name: (weight_dtype(classes[name], policy, proj_dtype)
                   if name in classes else torch.float32) for name in specs}


def _trunc(q: torch.Tensor, t: int) -> torch.Tensor:
    # natively-truncating circuit: reduced-width integer operands
    return torch.sign(q) * ((torch.abs(q) >> t) << t)


def _approx_matmul_nd(x: torch.Tensor, w: torch.Tensor, spec,
                      uv) -> torch.Tensor:
    """x (..., k) @ w (k, n) under an ApproxSpec, with dynamic per-tensor
    symmetric int8 quantization; float32 out."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    qx, sx = quantize_sym(x2)
    qw, sw = quantize_sym(w)
    if spec.trunc_bits:
        qx = _trunc(qx, spec.trunc_bits)
        qw = _trunc(qw, spec.trunc_bits)
    out = qx.float() @ qw.float()
    if spec.rank:
        u, v = uv
        ux = u[(qx + 128).long()]            # (m, k, r)
        vw = v[(qw + 128).long()]            # (k, n, r)
        out = out + torch.einsum("mkr,knr->mn", ux, vw)
    out = out * (sx * sw)
    return out.reshape(*lead, w.shape[1])


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    cls: str,
    policy: Optional[ApproxPolicy] = None,
) -> torch.Tensor:
    """Projection with optional DSE-assigned approximation; bf16 out."""
    spec = policy.spec(cls) if policy is not None else None
    if spec is None:
        return x.to(torch.bfloat16) @ w.to(torch.bfloat16)
    uv = policy.factors(cls, x.device) if spec.rank else None
    return _approx_matmul_nd(x, w.float(), spec, uv).to(torch.bfloat16)
