"""Gradient compression, the JAX package's ``optim/compress.py``.

``ef_quantize`` is int8 error-feedback quantization (1-bit-SGD-style
residual carrying): the train step compresses gradients before the
optimizer and carries the quantization residual in the train state, so
compression error does not accumulate as bias.

``compressed_psum`` is the JAX package's int8 all-reduce inside
``shard_map``; its counterpart waits for the port of ``dist/`` (the
ROADMAP's dist item) and raises until then.
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


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    raise NotImplementedError(
        "compressed_psum is an int8 all-reduce across a device mesh; it "
        "waits for the port of dist/ (torch.distributed), which is not "
        "ported yet")
