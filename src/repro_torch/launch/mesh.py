"""Production mesh construction, the JAX package's ``launch/mesh.py`` on
``torch.distributed``.

A FUNCTION (not a module-level constant), so importing this module
touches no process group.  The axes are the JAX package's: one pod is
("data", "model"), several are ("pod", "data", "model"), where "pod"
carries only data parallelism (gradient reduction across pods) and
"data"/"model" are the FSDP and tensor-parallel axes.  The shape comes
from the world size: "model" takes up to 16 ranks of a pod, "data" the
rest, so 256 ranks give the JAX package's (16, 16) and 512 over two pods
its (2, 16, 16); one card gives (1, 1).
"""

from __future__ import annotations

import math
from typing import Tuple

from ..dist.compat import make_mesh

__all__ = ["make_production_mesh", "production_shape"]

MODEL_AXIS_MAX = 16   # tensor-parallel ranks a pod, as the JAX package's


def production_shape(world: int, *, multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the production mesh over ``world`` ranks."""
    pods = 2 if multi_pod else 1
    if world < pods or world % pods:
        raise ValueError(f"{world} ranks do not split into {pods} pods")
    per_pod = world // pods
    model = math.gcd(per_pod, MODEL_AXIS_MAX)
    shape = (per_pod // model, model)
    axes = ("data", "model")
    if multi_pod:
        return (pods,) + shape, ("pod",) + axes
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` over the default process group's
    ranks (one rank, no group: a one-device mesh needs a group of one)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    shape, axes = production_shape(world, multi_pod=multi_pod)
    return make_mesh(shape, axes)
