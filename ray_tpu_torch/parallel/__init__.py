"""ray_tpu_torch.parallel: the port's parallelism plane, mirroring
``ray_tpu.parallel``.

So far the expert routing of the MoE model (``expert``): top-k gating with
static capacity, the dense and the indexed dispatch/combine, at one rank.
Meshes, sharding plans, ring and Ulysses attention and the pipeline come
with later slices of the port (ROADMAP items A.4-A.6).
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

__all__ = [
    "Routing",
    "expert_capacity",
    "moe_apply_gspmd",
    "moe_apply_indexed",
    "moe_combine",
    "moe_dispatch",
    "route",
    "top_k_gating",
]
