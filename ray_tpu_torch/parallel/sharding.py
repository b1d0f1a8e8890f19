"""Logical-axis sharding rules: the pure part of ray_tpu/parallel/sharding.py.

The t5x/flax "logical axis" pattern: model code names the axes of its
parameters ("embed", "mlp", "heads", ...) and a rule table maps each name
to a mesh axis (or None: replicated). :class:`PartitionSpec` is the port's
stand-in for ``jax.sharding.PartitionSpec``: a tuple of mesh axes, one per
tensor dimension, equal as a tuple to the reference's.

Ported so far: :data:`DEFAULT_RULES` and :func:`logical_to_spec`. The
reference's ``param_shardings``, ``constrain``, ``tree_shardings`` and
``process_local_batch`` place arrays on a GSPMD mesh; their port comes with
FSDP training (ROADMAP A.5).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple


class PartitionSpec(tuple):
    """One mesh axis (a name, a tuple of names, or None) per dimension;
    trailing dimensions not named are replicated, as in JAX."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

# Default rule table: logical axis -> mesh axis (or None = replicate).
# Weights shard "embed" over fsdp (ZeRO-3 style) and output/mlp/head dims
# over tp (megatron style); activations shard batch over the data axes and
# sequence over sp.
DEFAULT_RULES: List[Tuple[str, Any]] = [
    ("batch", ("dcn", "dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("layers", None),
    ("lora_rank", None),
]


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Sequence[Tuple[str, Any]]] = None,
) -> PartitionSpec:
    table = dict(rules or DEFAULT_RULES)
    return P(*[table.get(name) if name else None for name in logical_axes])
