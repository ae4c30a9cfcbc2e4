"""AdamW with global-norm clipping, a configurable moment dtype (float32
by default; bf16 for the configs whose state must fit in less memory)
and decoupled weight decay: the JAX package's ``optim/adamw.py`` over
ordered dicts of tensors.

The arithmetic is the reference's, operation for operation in float32:
the clip scale ``min(1, max_norm / max(gn, 1e-9))``, the warmup
``lr * min(1, (step + 1) / warmup)`` evaluated at the incremented step,
bias-corrected moments and ``delta = m_hat / (sqrt(v_hat) + eps) + wd *
p``, then ``p -= lr * delta``.  ``torch.optim.AdamW`` is another
function (it scales the decay by lr, and has no warmup), so it is not
used.  The JAX package returns new trees from buffers it donates; here
``update`` writes the parameters, the moments and the gradients in
place and returns the same dicts.  The step count is an int32 tensor on
the parameters' device, so an update never waits for the card.  The
update is elementwise, so a tensor of more than ``UPDATE_SLICE``
elements (a large vocabulary's embedding) is updated slice by slice,
with the same bits, and its float32 temporaries stay a slice's size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["AdamW", "clip_by_global_norm", "UPDATE_SLICE"]

UPDATE_SLICE = 1 << 26     # elements of one slice of a tensor's update


def _slices(p: torch.Tensor, *others: torch.Tensor):
    """``(p, *others)`` as views of at most ``UPDATE_SLICE`` elements
    each, in step; the whole tensors where they are no larger or not all
    contiguous."""
    ts = (p,) + others
    n = p.numel()
    if n <= UPDATE_SLICE or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, UPDATE_SLICE):
        yield tuple(f[i:i + UPDATE_SLICE] for f in flat)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor],
                        max_norm: float) -> Tuple[Mapping[str, torch.Tensor],
                                                  torch.Tensor]:
    """Scale ``grads`` in place so that their global float32 norm is at
    most ``max_norm``; returns (grads, the norm before clipping)."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, gn


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
        dt = getattr(torch, self.moment_dtype)
        dev = next(iter(params.values())).device
        return {
            "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp((step + 1) / max(self.warmup_steps, 1), max=1.0)
        return self.lr * warm

    def update(self, grads: Mapping[str, torch.Tensor],
               state: Dict[str, object], params: Mapping[str, torch.Tensor]
               ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, object],
                          Dict[str, torch.Tensor]]:
        """-> (params, state, metrics); params, moments and grads are
        written in place."""
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        step = state["step"] + 1
        lr = self.schedule(step)
        stepf = step.float()
        b1c = 1.0 - torch.full_like(stepf, self.b1) ** stepf
        b2c = 1.0 - torch.full_like(stepf, self.b2) ** stepf
        m_all, v_all = state["m"], state["v"]
        with torch.no_grad():
            for k, whole in params.items():
                for p, g, m, v in _slices(whole, grads[k], m_all[k],
                                          v_all[k]):
                    g32 = g.float()
                    m_new = self.b1 * m.float() + (1 - self.b1) * g32
                    v_new = self.b2 * v.float() + (1 - self.b2) * g32 * g32
                    delta = (m_new / b1c) / (torch.sqrt(v_new / b2c)
                                             + self.eps)
                    delta += self.weight_decay * p.float()
                    p.copy_(p.float() - lr * delta)
                    m.copy_(m_new)
                    v.copy_(v_new)
                    del g32, m_new, v_new, delta
        state = {"m": m_all, "v": v_all, "step": step}
        return params, state, {"grad_norm": gnorm, "lr": lr}
