"""Logical-axis sharding rules, the JAX package's ``dist/sharding.py`` on
``torch.distributed``'s ``DeviceMesh`` and DTensor placements.

Model code names array dimensions *logically* (``ParamSpec.logical``:
``("embed", "heads")``) and never mentions mesh axes.  This module owns
the mapping from logical names to mesh axes:

  * ``DEFAULT_RULES``: the global defaults (FSDP weights over "data",
    tensor-parallel weights and activations over "model", batch over
    ("pod", "data"), decode KV sequence over "model");
  * ``rule_overrides``: a thread-local, re-entrant context manager that
    layers per-cell or per-arch overrides on top; ``active_rules()``
    returns the layered overrides;
  * ``spec_for``: rule resolution to a ``PartitionSpec`` (one entry a
    dimension: None, a mesh axis, or a tuple of them) with the two
    properties every caller relies on: an axis is never used for two
    dimensions of one array, and a dimension whose size its shard count
    does not divide falls back toward replication (a tuple rule keeps the
    longest divisible prefix);
  * ``sharding_for``: the ``DeviceMesh`` and the DTensor placements of
    ``spec_for``'s spec (``Shard(dim)`` on each mesh axis a dimension
    takes, ``Replicate()`` on the rest);
  * ``constrain``: redistributes a DTensor to its resolved placements
    against the ambient mesh (``compat.mesh_context``); a no-op outside
    any mesh, and on a tensor that is not a DTensor.

A mesh is read only through its axis sizes: a ``DeviceMesh`` (its
``mesh_dim_names`` and ``shape``) or any object whose ``shape`` is a
dict of axis name to size, as the JAX package's ``Mesh.shape`` is.
Several mesh axes on one dimension shard it in the mesh's axis order,
as the rules list them.  The JAX package's ``constrain_cotangent``
constrains a gradient inside a traced, scanned block; eager PyTorch's
gradients land where their parameters are, so it is not carried.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple, Union

from .compat import ambient_mesh

AxisSpec = Union[None, str, Tuple[str, ...]]
AxisRules = Dict[str, AxisSpec]

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "PartitionSpec",
    "active_rules",
    "mesh_sizes",
    "placements_for",
    "rule_overrides",
    "spec_for",
    "sharding_for",
    "constrain",
]

# Logical-name -> mesh-axis defaults.  Weight axes: FSDP on "data",
# tensor parallel on "model".  Activation ("act_*") axes mirror their
# weight counterparts; "batch" spreads over every data-parallel axis.
DEFAULT_RULES: AxisRules = {
    # weight axes
    "embed": "data",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert_mlp": "model",
    "experts": "data",
    "norm": None,
    "state": None,
    "conv": None,
    "dt": None,
    # activation axes
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "model",
    "act_embed": None,
    "act_mlp": "model",
    "act_heads": "model",
    "act_experts": "data",
}


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), a mesh axis name, or a
    tuple of them (a tuple of one is its axis, as jax's PartitionSpec
    keeps it); compares equal to any sequence of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def active_rules() -> AxisRules:
    """The merged override layers currently in effect (NOT including
    DEFAULT_RULES: resolution merges the defaults underneath)."""
    merged: AxisRules = {}
    for layer in _stack():
        merged.update(layer)
    return merged


@contextmanager
def rule_overrides(rules: Optional[AxisRules]):
    """Layer ``rules`` over the active overrides for the duration of the
    context.  Later layers win; a value of ``None`` un-shards the axis."""
    _stack().append(dict(rules or {}))
    try:
        yield
    finally:
        _stack().pop()


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mesh whose ``shape``
    is that dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def spec_for(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Optional[AxisRules] = None,
) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec on ``mesh``.

    Guarantees: (a) each mesh axis is used at most once per array,
    (b) a dimension keeps only the longest prefix of its rule's axes
    whose cumulative shard count divides the dimension (single-axis
    rules therefore fall back to replication when non-divisible)."""
    merged: AxisRules = {**DEFAULT_RULES, **active_rules(), **(rules or {})}
    sizes = mesh_sizes(mesh)
    used: set = set()
    entries = []
    for name, dim in zip(logical, shape):
        rule = merged.get(name) if name is not None else None
        if rule is None:
            entries.append(None)
            continue
        axes = (rule,) if isinstance(rule, str) else tuple(rule)
        picked = []
        shards = 1
        for a in axes:
            n = int(sizes.get(a, 1))
            if a in used or n <= 1 or dim % (shards * n) != 0:
                break
            picked.append(a)
            shards *= n
        used.update(picked)
        if not picked:
            entries.append(None)
        elif isinstance(rule, str):
            entries.append(picked[0])
        else:
            entries.append(tuple(picked))
    return PartitionSpec(*entries)


def placements_for(spec: Sequence, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``'s axes, in the
    mesh's order: ``Shard(dim)`` on an axis that dimension ``dim``
    takes, ``Replicate()`` on an axis no dimension takes."""
    from torch.distributed.tensor import Replicate, Shard

    on: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            on[a] = dim
    return [Shard(on[a]) if a in on else Replicate()
            for a in mesh_sizes(mesh)]


def sharding_for(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Optional[AxisRules] = None,
) -> tuple:
    """``(mesh, placements)``: ``spec_for``'s spec as DTensor placements
    on ``mesh``'s axes (``distribute_tensor(t, *sharding_for(...))``)."""
    return mesh, placements_for(spec_for(logical, shape, mesh, rules), mesh)


def constrain(x, logical: Sequence[Optional[str]]):
    """``x`` redistributed to its resolved placements on the ambient
    mesh; ``x`` itself when no mesh is ambient or ``x`` is not a
    DTensor."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    _, placements = sharding_for(logical, x.shape, mesh)
    return x.redistribute(mesh, placements)
