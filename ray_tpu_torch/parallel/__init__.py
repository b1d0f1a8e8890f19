"""ray_tpu_torch.parallel: the port's parallelism plane, mirroring
``ray_tpu.parallel``.

- ``mesh``: the rank grid (one device per rank, a process per rank) with
  the reference's axes, and each axis's collective group once bound
  (``Mesh.form_groups``: the gang's sub-groups);
- ``sharding``: ``PartitionSpec``, the logical-axis rule table, the Llama
  ViT's and the MoE's parameters' logical axes, ``NamedSharding`` (a
  rank's block of a global tensor), ``param_shardings`` /
  ``tree_shardings``, ``constrain`` and ``process_local_batch``;
- ``fsdp``: :class:`FSDP`, one rank's blocks of a model's parameters,
  gathered over the ``fsdp`` axis block by block in its forward;
- ``plan``: :class:`PartitionPlan`, the name-matched rule table of the
  tensor-parallel serving path, each rank's parameter and KV head slices;
- ``expert``: the MoE model's top-k gating with static capacity (over a
  mesh, the global batch's), the dense and the indexed dispatch/combine,
  and the all_to_all dispatch/combine over an expert-parallel process
  group;
- ``ring_attention`` and ``ulysses``: causal attention over a sequence
  split across a group's ranks, by K/V hops around a ring (the Llama's and
  the MoE's full forward under an ``sp`` mesh) or by an all-to-all
  head/sequence swap;
- ``pipeline``: ``pipeline_apply``, GPipe over a ``pp`` group (each rank
  one stage, one hop a tick), with ``stage_index`` and
  ``select_stage_params``.
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
from .fsdp import FSDP
from .mesh import (
    AXIS_ORDER,
    BATCH_AXES,
    LOSS_AXES,
    EXPERT_AXES,
    Mesh,
    MeshSpec,
    check_model_mesh,
    local_batch_size,
    make_mesh,
)
from .pipeline import pipeline_apply, select_stage_params, stage_index
from .plan import (
    DEFAULT_LLM_RULES,
    KV_SPEC,
    PartitionPlan,
    match_partition_rules,
    validate_mesh_for_model,
)
from .ring_attention import ring_attention
from .sharding import (
    DEFAULT_RULES,
    LLAMA_LOGICAL_AXES,
    MOE_LOGICAL_AXES,
    VIT_LOGICAL_AXES,
    NamedSharding,
    constrain,
    P,
    PartitionSpec,
    logical_to_spec,
    param_shardings,
    process_local_batch,
    tree_shardings,
)
from .ulysses import ulysses_attention

__all__ = [
    "AXIS_ORDER",
    "BATCH_AXES",
    "LOSS_AXES",
    "EXPERT_AXES",
    "DEFAULT_LLM_RULES",
    "DEFAULT_RULES",
    "FSDP",
    "KV_SPEC",
    "LLAMA_LOGICAL_AXES",
    "MOE_LOGICAL_AXES",
    "Mesh",
    "MeshSpec",
    "NamedSharding",
    "P",
    "PartitionPlan",
    "PartitionSpec",
    "Routing",
    "VIT_LOGICAL_AXES",
    "check_model_mesh",
    "constrain",
    "expert_capacity",
    "local_batch_size",
    "logical_to_spec",
    "make_mesh",
    "match_partition_rules",
    "moe_apply_gspmd",
    "moe_apply_indexed",
    "moe_combine",
    "moe_dispatch",
    "param_shardings",
    "pipeline_apply",
    "process_local_batch",
    "ring_attention",
    "route",
    "select_stage_params",
    "stage_index",
    "top_k_gating",
    "tree_shardings",
    "ulysses_attention",
    "validate_mesh_for_model",
]
