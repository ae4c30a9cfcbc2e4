"""Mesh construction and the ambient mesh, the JAX package's
``dist/compat.py`` on ``torch.distributed``.

``make_mesh(shape, axes)`` is ``init_device_mesh`` with the axes as the
mesh's dimension names; it needs a process group of ``prod(shape)``
ranks (``launch/cluster.py`` ``init_distributed``).  ``mesh_context``
makes a mesh ambient for the calling thread, where
``dist.sharding.constrain`` reads it; outside any context there is no
mesh and ``constrain`` does nothing.

Not carried: ``compiled_cost_analysis`` and ``opt_barrier`` are XLA's (a
compiled executable's cost numbers, an optimization barrier in a traced
graph) and have no meaning for eager PyTorch.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Sequence, Tuple

__all__ = ["make_mesh", "mesh_context", "ambient_mesh"]


def make_mesh(shape: Tuple[int, ...], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group's ranks: on "cuda" where the backend is NCCL, else on
    "cpu"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} "
                         f"ranks, the process group has {world}")
    device_type = ("cuda" if dist.is_initialized()
                   and dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


_local = threading.local()


def ambient_mesh():
    """The mesh of the innermost ``mesh_context`` of this thread, or
    None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def mesh_context(mesh):
    """Make ``mesh`` ambient for this thread for the context's duration
    (re-entrant: the innermost wins)."""
    if not hasattr(_local, "stack"):
        _local.stack = []
    _local.stack.append(mesh)
    try:
        yield mesh
    finally:
        _local.stack.pop()
