"""Distribution of the port over ``torch.distributed``: logical-axis
sharding rules resolved to ``DeviceMesh`` placements (``sharding``) and
mesh construction with an ambient mesh (``compat``)."""

from .compat import ambient_mesh, make_mesh, mesh_context
from .sharding import (DEFAULT_RULES, AxisRules, PartitionSpec, active_rules,
                       constrain, rule_overrides, sharding_for, spec_for)

__all__ = ["AxisRules", "DEFAULT_RULES", "PartitionSpec", "active_rules",
           "ambient_mesh", "constrain", "make_mesh", "mesh_context",
           "rule_overrides", "sharding_for", "spec_for"]
