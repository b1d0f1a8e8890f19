"""ray_tpu_torch.parallel: the port's parallelism plane, mirroring
``ray_tpu.parallel``.

- ``mesh``: the rank grid (one device per rank, a process per rank) with
  the reference's axes, and each axis's collective group once bound;
- ``sharding``: ``PartitionSpec`` and the logical-axis rule table (the
  placement functions come with FSDP, ROADMAP A.5);
- ``plan``: :class:`PartitionPlan`, the name-matched rule table of the
  tensor-parallel serving path, each rank's parameter and KV head slices;
- ``expert``: the MoE model's top-k gating with static capacity, the dense
  and the indexed dispatch/combine, and the all_to_all dispatch/combine over
  an expert-parallel process group.

Ring and Ulysses attention and the pipeline come with later slices of the
port (ROADMAP items A.5-A.6).
"""

from .expert import (
    Routing,
    expert_capacity,
    moe_apply_gspmd,
    moe_apply_indexed,
    moe_combine,
    moe_dispatch,
    route,
    top_k_gating,
)
from .mesh import AXIS_ORDER, BATCH_AXES, Mesh, MeshSpec, local_batch_size, make_mesh
from .plan import (
    DEFAULT_LLM_RULES,
    KV_SPEC,
    PartitionPlan,
    match_partition_rules,
    validate_mesh_for_model,
)
from .sharding import DEFAULT_RULES, P, PartitionSpec, logical_to_spec

__all__ = [
    "AXIS_ORDER",
    "BATCH_AXES",
    "DEFAULT_LLM_RULES",
    "DEFAULT_RULES",
    "KV_SPEC",
    "Mesh",
    "MeshSpec",
    "P",
    "PartitionPlan",
    "PartitionSpec",
    "Routing",
    "expert_capacity",
    "local_batch_size",
    "logical_to_spec",
    "make_mesh",
    "match_partition_rules",
    "moe_apply_gspmd",
    "moe_apply_indexed",
    "moe_combine",
    "moe_dispatch",
    "route",
    "top_k_gating",
    "validate_mesh_for_model",
]
