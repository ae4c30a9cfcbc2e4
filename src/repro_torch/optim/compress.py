"""Gradient compression, the JAX package's ``optim/compress.py``.

``ef_quantize`` is int8 error-feedback quantization (1-bit-SGD-style
residual carrying): the train step compresses gradients before the
optimizer and carries the quantization residual in the train state, so
compression error does not accumulate as bias.

``compressed_psum`` is the int8 all-reduce of the JAX package's
``compressed_psum`` (inside ``shard_map``) on a ``torch.distributed``
process group, in its order: a MAX all-reduce of ``max |x|``, the scale
that maximum over 127 floored at 1e-12, ``x`` rounded to int8 in
[-127, 127], a SUM all-reduce of those in int32 (as the JAX package
sums them: ranks x 127 stays well inside int32), the sum times the
scale.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ef_quantize", "compressed_psum"]


def ef_quantize(g: torch.Tensor,
                err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization of one gradient tensor.

    Returns (dequantized gradient in g's dtype, new float32 residual);
    pass zeros as ``err`` at step 0."""
    x = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127)
    deq = q * scale
    return deq.to(g.dtype), x - deq


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 all-reduce of ``x`` over ``group`` (the default process group
    when None): the sum over the group's ranks of each rank's ``x``
    quantized with one scale shared by all ranks, float32.  Every rank
    gets the same result."""
    import torch.distributed as dist

    amax = torch.max(torch.abs(x.float())).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    # accumulate in int32 (ranks * 127 stays well inside int32)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * scale
