"""Logical-axis sharding rules: the port of ray_tpu/parallel/sharding.py.

The t5x/flax "logical axis" pattern: model code names the axes of its
parameters ("embed", "mlp", "heads", ...) and a rule table maps each name
to a mesh axis (or None: replicated). :class:`PartitionSpec` is the port's
stand-in for ``jax.sharding.PartitionSpec``: a tuple of mesh axes, one per
tensor dimension, equal as a tuple to the reference's.

The reference places one global array on the devices of one program. The
port runs a process per rank, so a :class:`NamedSharding` here names the
block of a global tensor that one rank of a :class:`~.mesh.Mesh` holds
(:meth:`NamedSharding.index`, the reference's ``addressable_shards[i].index``);
a collective (parallel/fsdp.py, the sync-BN of models/resnet.py) stands
where GSPMD would insert one.

- :func:`tree_shardings` and :func:`param_shardings` map logical axes and
  parameters to shardings. flax's ``nn.with_logical_partitioning`` metadata
  has no torch counterpart: :data:`LLAMA_LOGICAL_AXES` is the port's copy
  of the axes that the reference's Llama modules annotate, and a parameter
  it does not name is replicated, as the reference falls back to ``P()``
  (ResNet's parameters).
- :func:`process_local_batch`: a rank's local batch is its shard of the
  global batch; the global batch must divide over the mesh's data axes.

- :data:`VIT_LOGICAL_AXES` and :data:`MOE_LOGICAL_AXES`: the annotations
  of the reference's ViT and MoE modules, for the models over a mesh.
- :func:`constrain` (``with_sharding_constraint`` by logical axes) on a
  rank's block of an activation; its one caller in the reference is the
  ViT over a mesh (``ray_tpu/models/vit.py:163``).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch


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


# The logical axes of each Llama parameter, by its dotted path (first match
# wins): the annotations of ray_tpu/models/llama.py, where ``_dense`` and
# ``LoRADense`` carry them (``:100``, ``:137-146``), the projections
# (``:183``, ``:269``, ``:285-292``), the norms (``:306``, ``:316``,
# ``:393``) and ``embed`` / ``lm_head`` (``:352``, ``:400-401``). The port
# keeps the layers unstacked, so no ``layers`` axis leads.
LLAMA_LOGICAL_AXES: List[Tuple[str, Tuple[str, ...]]] = [
    (r"(^|\.)embed$", ("vocab", "embed")),
    (r"(^|\.)lm_head$", ("embed", "vocab")),
    (r"(^|\.)(attn_norm|mlp_norm|final_norm)$", ("embed",)),
    (r"attn\.(wq|wk|wv)\.base\.kernel$", ("embed", "heads")),
    (r"attn\.(wq|wk|wv)\.lora_a$", ("embed", "lora_rank")),
    (r"attn\.(wq|wk|wv)\.lora_b$", ("lora_rank", "heads")),
    (r"attn\.wo\.base\.kernel$", ("heads", "embed")),
    (r"attn\.wo\.lora_a$", ("heads", "lora_rank")),
    (r"attn\.wo\.lora_b$", ("lora_rank", "embed")),
    (r"mlp\.(w_gate|w_up)\.kernel$", ("embed", "mlp")),
    (r"mlp\.w_down\.kernel$", ("mlp", "embed")),
]


# The ViT's (ray_tpu/models/vit.py): the patch conv's kernel
# (``:128-139``, flax HWIO (None, None, None, "embed"); the port stores it
# OIHW), ``cls_token`` (``:141-147``), ``pos_embed`` (``:152-158``), the
# dense kernels (``:67-76`` through ``_dense``: ``:90-104``) and ``head``
# (``:175-181``). Biases and LayerNorm parameters carry no annotation and
# are replicated, as the reference's ``P()``.
VIT_LOGICAL_AXES: List[Tuple[str, Tuple[str, ...]]] = [
    (r"^patch_embed\.kernel$", ("embed", None, None, None)),
    (r"^cls_token$", (None, None, "embed")),
    (r"^pos_embed$", (None, "seq", "embed")),
    (r"\.(wq|wk|wv)\.kernel$", ("embed", "heads")),
    (r"\.wo\.kernel$", ("heads", "embed")),
    (r"\.fc1\.kernel$", ("embed", "mlp")),
    (r"\.fc2\.kernel$", ("mlp", "embed")),
    (r"^head$", ("embed", "vocab")),
]

# The MoE's (ray_tpu/models/moe.py): the router and the experts
# (``:96-133``), the norms, ``embed`` and ``lm_head`` (``:155-213``), and
# the Llama attention's projections as LLAMA_LOGICAL_AXES gives them.
MOE_LOGICAL_AXES: List[Tuple[str, Tuple[str, ...]]] = [
    (r"(^|\.)embed$", ("vocab", "embed")),
    (r"(^|\.)lm_head$", ("embed", "vocab")),
    (r"(^|\.)(attn_norm|ffn_norm|final_norm)$", ("embed",)),
    (r"attn\.(wq|wk|wv)\.base\.kernel$", ("embed", "heads")),
    (r"attn\.wo\.base\.kernel$", ("heads", "embed")),
    (r"moe\.router$", ("embed", "expert")),
    (r"moe\.(w_gate|w_up)$", ("expert", "embed", "mlp")),
    (r"moe\.w_down$", ("expert", "mlp", "embed")),
]


def _first_match(table, name: str) -> Optional[Tuple[str, ...]]:
    for pattern, axes in table:
        if re.search(pattern, name):
            return axes
    return None


def llama_logical_axes(name: str) -> Optional[Tuple[str, ...]]:
    """The logical axes of the Llama parameter at dotted path ``name``, or
    None (replicated)."""
    return _first_match(LLAMA_LOGICAL_AXES, name)


def vit_logical_axes(name: str) -> Optional[Tuple[str, ...]]:
    """The logical axes of the ViT parameter ``name``, or None."""
    return _first_match(VIT_LOGICAL_AXES, name)


def moe_logical_axes(name: str) -> Optional[Tuple[str, ...]]:
    """The logical axes of the MoE parameter ``name``, or None."""
    return _first_match(MOE_LOGICAL_AXES, name)


def _axis_names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def block_index(shape: Sequence[int], spec: PartitionSpec, coords: Mapping[str, int],
                sizes: Mapping[str, int]) -> List[Tuple[int, int]]:
    """(offset, length) along each dimension of the block of a ``shape``
    tensor that mesh coordinates ``coords`` (axis -> index, axis sizes in
    ``sizes``) hold under ``spec``. Several axes on one dimension split it
    major to minor, as in JAX. A dimension its axes do not divide raises
    ValueError, as the reference's ``device_put`` does."""
    if len(spec) > len(shape):
        raise ValueError(f"the sharding {spec} has more entries than the shape {tuple(shape)}")
    out = []
    for dim, size in enumerate(shape):
        n, i = 1, 0
        for a in _axis_names(spec[dim] if dim < len(spec) else None):
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        if size % n:
            raise ValueError(
                f"the sharding {spec} implies that the global size of its dimension "
                f"{dim} should be divisible by {n}, but it is equal to "
                f"{size} (full shape: {tuple(shape)})"
            )
        out.append((i * (size // n), size // n))
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`~.mesh.Mesh`: which block of
    a global tensor each rank holds (the mesh's own rank by default)."""

    mesh: Any
    spec: PartitionSpec

    def index(self, shape: Sequence[int], rank: Optional[int] = None) -> Tuple[slice, ...]:
        """The block of rank ``rank``, one ``slice(start, stop)`` a
        dimension (the reference's ``addressable_shards[i].index``, with
        the bounds of an unsplit dimension written out)."""
        blocks = block_index(shape, self.spec, self.mesh.coords(rank), self.mesh.shape)
        return tuple(slice(o, o + n) for o, n in blocks)

    def slices(self, shape: Sequence[int], rank: Optional[int] = None) -> List[Tuple[int, int, int]]:
        """(dimension, offset, length) of each dimension that is split."""
        blocks = block_index(shape, self.spec, self.mesh.coords(rank), self.mesh.shape)
        return [(d, o, n) for d, ((o, n), size) in enumerate(zip(blocks, shape)) if n != size]

    def shard_shape(self, shape: Sequence[int]) -> torch.Size:
        return torch.Size(n for _, n in block_index(shape, self.spec, self.mesh.coords(0),
                                                    self.mesh.shape))

    def shard(self, t: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """Rank ``rank``'s block of the global tensor ``t``: a view."""
        for dim, offset, length in self.slices(t.shape, rank):
            t = t.narrow(dim, offset, length)
        return t

    def split_axes(self) -> Tuple[str, ...]:
        """The mesh axes of size > 1 that split some dimension."""
        return tuple(a for axes in self.spec for a in _axis_names(axes)
                     if self.mesh.shape[a] > 1)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def tree_shardings(mesh, logical_tree: Any,
                   rules: Optional[Sequence[Tuple[str, Any]]] = None):
    """Map a tree (nested mappings) of logical-axis tuples to
    :class:`NamedSharding` s."""
    if _is_axes(logical_tree):
        return NamedSharding(mesh, logical_to_spec(logical_tree, rules))
    return {k: tree_shardings(mesh, v, rules) for k, v in logical_tree.items()}


LogicalAxes = Union[Mapping[str, Optional[Tuple[str, ...]]],
                    Callable[[str], Optional[Tuple[str, ...]]]]


def param_shardings(mesh, params: Mapping[str, Any], rules=None,
                    logical_axes: Optional[LogicalAxes] = None, prefix: str = ""):
    """The :class:`NamedSharding` of every parameter of ``params`` (a
    mapping, nested or flat with dotted names; the result has its
    structure). A parameter's logical axes come from ``logical_axes`` (a
    mapping or a function of the dotted path; default
    :func:`llama_logical_axes`); one without axes is replicated (``P()``)."""
    lookup = llama_logical_axes if logical_axes is None else logical_axes
    if isinstance(lookup, Mapping):
        lookup = lookup.get
    out = {}
    for key, val in params.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out[key] = param_shardings(mesh, val, rules, lookup, f"{name}.")
        else:
            axes = lookup(name)
            out[key] = NamedSharding(mesh, logical_to_spec(axes, rules) if axes else P())
    return out


def constrain(x: torch.Tensor, mesh, *logical_axes: Optional[str], rules=None) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axis names, on a rank's block.

    The reference constrains one global array; a rank here holds its block
    of it, laid out as the port lays out activations: split along the
    first dimension over the mesh's data axes (:data:`~.mesh.BATCH_AXES`,
    the rank's batch shard) and replicated along every other axis. Each
    dimension of ``logical_axes`` (mapped through ``rules``) does to that
    block, counting only mesh axes past 1:

    - no axis: the dimension is left as it is;
    - data axes, on the first dimension, exactly the mesh's data axes past
      1 in order: the identity (the block is that shard already);
    - axes that are not data axes, on a dimension other than the first:
      the rank's slice of the dimension (the block is replicated along
      them; several axes split it major to minor, as in JAX); its
      backward puts the cotangent in that slice and zeros around it;
    - anything else raises ValueError: a batch block split otherwise than
      the spec (it would need a gather or another split), data axes off
      the first dimension, or data and other axes on one dimension.

    A dimension the axes do not divide raises ValueError too."""
    from .mesh import BATCH_AXES

    spec = logical_to_spec(logical_axes, rules)
    if len(spec) > x.dim():
        raise ValueError(f"constrain: {len(spec)} logical axes for a {x.dim()}-D tensor")
    data = tuple(a for a in BATCH_AXES if mesh.shape[a] > 1)
    coords = mesh.coords()
    for dim in range(x.dim()):
        names = tuple(a for a in _axis_names(spec[dim] if dim < len(spec) else None)
                      if mesh.shape[a] > 1)
        batchy = tuple(a for a in names if a in BATCH_AXES)
        if dim == 0:
            if names != data:
                raise ValueError(
                    f"constrain: the block's first dimension is its batch shard over {data}; "
                    f"the spec {spec} splits it over {names}")
            continue
        if batchy:
            raise ValueError(f"constrain: data axes {batchy} on dimension {dim} of {spec}; "
                             "a rank's block is split over them along its first dimension")
        n, i = 1, 0
        for a in names:
            n, i = n * mesh.shape[a], i * mesh.shape[a] + coords[a]
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"constrain: dimension {dim} of size {x.shape[dim]} does not "
                                 f"divide over {names} ({n} ranks)")
            size = x.shape[dim] // n
            x = x.narrow(dim, i * size, size)
    return x


def process_local_batch(mesh, local, batch_axes=("dcn", "dp", "fsdp")) -> torch.Tensor:
    """This rank's shard of the global batch, on its device.

    In the reference this assembles one global array from every process's
    local rows (``jax.make_array_from_process_local_data``). In the port
    each rank is a process that computes on its own rows, and the model's
    collectives make the step global, so the local rows are the shard. The
    global batch (local rows x ranks) must divide over the mesh's data
    axes, as the reference requires; ``local`` is (per_rank_batch, ...), a
    tensor or an array."""
    local = torch.as_tensor(local)
    shards = math.prod(mesh.shape[a] for a in batch_axes if a in mesh.shape)
    global_rows = local.shape[0] * mesh.size
    if global_rows % shards:
        raise ValueError(
            f"the global batch of {global_rows} rows ({local.shape[0]} a rank x "
            f"{mesh.size} ranks) does not divide over the mesh's data axes "
            f"({shards} shards)"
        )
    return local.to(mesh.device())
