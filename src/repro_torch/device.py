"""Device resolution for the port's entry points.

Every entry point takes ``device``.  It defaults to ``"cuda"``: the
port's kernels are what it exists for, so a missing card is an error,
never a quiet run on the CPU.  Callers that want the plain PyTorch
versions (the CPU tests) pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly
    or by default) and PyTorch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
