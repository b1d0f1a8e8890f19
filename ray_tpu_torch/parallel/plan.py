"""Partition-rule planner for the serving engines: the port of
ray_tpu/parallel/plan.py.

A :class:`PartitionPlan` owns a :class:`~.mesh.Mesh` plus an ordered table
of ``(name regex, PartitionSpec)`` rules, matched against the port's
parameter names (the flax paths joined by dots,
``layer_0.attn.wq.base.kernel``). The parameter slices come from its rules
(:meth:`PartitionPlan.shard_params`, :meth:`~PartitionPlan.local_shapes`)
and the KV heads of a rank's attention, decode cache and block pools from
:meth:`~PartitionPlan.kv_heads_per_rank`, so the parameter layout, the
decode-cache layout and the block-pool layout cannot drift apart.

Sharding layout (megatron-style TP, as the reference's):

- wq/wk/wv kernels ``(embed, heads*d)`` split the output axis over ``tp``
  (rank r keeps heads ``[r*h/tp, (r+1)*h/tp)`` and KV heads likewise, so
  GQA groups stay whole); wo ``(heads*d, embed)`` splits its input axis:
  one allreduce per attention.
- w_gate/w_up split ``intermediate``; w_down splits its input: one
  allreduce per MLP.
- ``embed (vocab, dim)`` and ``lm_head (dim, vocab)`` split the vocab axis.
- norms, LoRA ranks and scalars replicate.
- decode-cache KV ``(b, heads, seq, d)`` and the paged block pools
  ``(capacity, heads, block, d)`` split heads (:data:`KV_SPEC`); the port
  stacks layers in front of both, so its tensors carry one more leading
  replicated axis.

The reference places the shards on one program's devices and GSPMD inserts
the collectives. The port runs a process per rank: :meth:`shard_params`
hands rank r its slices, and the model (models/llama.py) calls the plan's
group where GSPMD would put a collective. A plan is bound to a rank and its
group by :meth:`bind` in that rank's process.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..exceptions import MeshValidationError
from .mesh import make_mesh
from .sharding import P, PartitionSpec, block_index

# Ordered (name-regex, PartitionSpec) table for the Llama family: first
# match wins. The reference's table with "." for its "/".
DEFAULT_LLM_RULES: List[Tuple[str, PartitionSpec]] = [
    (r"attn\.(wq|wk|wv)\.base\.kernel$", P(None, "tp")),
    (r"attn\.wo\.base\.kernel$", P("tp", None)),
    # LoRA factors follow their base kernel: where the base splits its
    # output axis (wq/wk/wv), lora_b (rank, out) splits out and lora_a
    # replicates; where it splits its input axis (wo), lora_a (in, rank)
    # splits in and lora_b replicates. Rank never splits.
    (r"attn\.(wq|wk|wv)\.lora_a$", P()),
    (r"attn\.(wq|wk|wv)\.lora_b$", P(None, "tp")),
    (r"attn\.wo\.lora_a$", P("tp", None)),
    (r"attn\.wo\.lora_b$", P()),
    (r"mlp\.(w_gate|w_up)\.kernel$", P(None, "tp")),
    (r"mlp\.w_down\.kernel$", P("tp", None)),
    (r"(^|\.)embed$", P("tp", None)),
    (r"(^|\.)lm_head$", P(None, "tp")),
    (r".*", P()),  # norms, router weights, scalars
]

# decode-cache / block-pool KV layout: heads at axis 1 in both
# (batch|capacity, heads, seq|block, head_dim)
KV_SPEC = P(None, "tp", None, None)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def match_partition_rules(
    rules: Sequence[Tuple[str, PartitionSpec]], params: Mapping[str, Any]
) -> Dict[str, PartitionSpec]:
    """Map each parameter name (nested mappings are joined with dots) to
    the spec of the first rule whose regex it matches. Raises
    :class:`MeshValidationError` on an unmatched name: a silent replication
    default hides typos in a rule table, so custom tables end with an
    explicit catch-all."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    out: Dict[str, PartitionSpec] = {}
    for name in _flatten(params):
        for pat, spec in compiled:
            if pat.search(name):
                out[name] = spec
                break
        else:
            raise MeshValidationError(f"no partition rule matches parameter {name!r}")
    return out


def validate_mesh_for_model(
    tensor_parallel_size: int,
    num_devices: int,
    n_heads: Optional[int] = None,
    n_kv_heads: Optional[int] = None,
    model_id: str = "?",
) -> None:
    """The admission gate for a sharded replica: every way ``tp`` can be
    wrong surfaces here as a typed :class:`MeshValidationError`, before any
    process is spawned or weight placed."""
    tp = int(tensor_parallel_size)
    if tp < 1:
        raise MeshValidationError(
            f"tensor_parallel_size must be >= 1, got {tp}"
        )
    if num_devices % tp != 0:
        raise MeshValidationError(
            f"tensor_parallel_size {tp} does not divide the local device "
            f"count {num_devices}; a replica's mesh must use whole devices"
        )
    for axis, n in (("n_heads", n_heads), ("n_kv_heads", n_kv_heads)):
        if n is not None and n % tp != 0:
            raise MeshValidationError(
                f"model {model_id!r}: {axis}={n} is not divisible by "
                f"tensor_parallel_size {tp}; attention heads (and the KV "
                f"block pools sharded along them) split evenly or not at all"
            )


def shard_tensor(t: torch.Tensor, spec: PartitionSpec, index: Mapping[str, int],
                 sizes: Mapping[str, int]) -> torch.Tensor:
    """The block of ``t`` at mesh coordinates ``index`` (axis -> index,
    axis sizes in ``sizes``) under ``spec``: a view. A dimension that its
    axes do not divide raises ValueError, as the reference's ``device_put``
    does."""
    for dim, (offset, length) in enumerate(block_index(t.shape, spec, index, sizes)):
        if length != t.shape[dim]:
            t = t.narrow(dim, offset, length)
    return t


class PartitionPlan:
    """One replica's sharding contract: mesh + rules + derived layouts.

    Built once per replica (:meth:`for_model`), then bound in each rank's
    process to that rank and its ``tp`` group (:meth:`bind`). ``backend``
    names the group's collectives: ``"nccl"`` (a card per rank) or
    ``"gloo"`` (ranks on the CPU, or sharing a card)."""

    def __init__(
        self,
        mesh,
        rules: Optional[Sequence[Tuple[str, PartitionSpec]]] = None,
        backend: str = "nccl",
    ):
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
        self.mesh = mesh
        self.rules = list(rules or DEFAULT_LLM_RULES)
        self.backend = backend

    # -- construction --------------------------------------------------------

    @classmethod
    def for_model(
        cls,
        model_config,
        tensor_parallel_size: int,
        sequence_parallel_size: int = 1,
        devices=None,
        rules: Optional[Sequence[Tuple[str, PartitionSpec]]] = None,
        backend: str = "nccl",
    ) -> "PartitionPlan":
        """Validate tp against the device count and the model's head
        counts, then build the replica's rank grid (tp on the fastest axis)
        over the first tp x sp of ``devices`` (default: every card)."""
        from .mesh import normalize_devices

        devs = normalize_devices(devices)
        validate_mesh_for_model(
            tensor_parallel_size,
            len(devs),
            n_heads=getattr(model_config, "n_heads", None),
            n_kv_heads=getattr(model_config, "n_kv_heads", None),
            model_id=type(model_config).__name__,
        )
        if sequence_parallel_size > 1:
            raise NotImplementedError(
                "a serving plan with sequence_parallel_size > 1 is refused on purpose "
                "(ROADMAP kept item 32): the reference's engine runs the decode-mode "
                "model, which never takes the ring, so sp would only repeat tp's work; "
                "training splits the sequence through Llama(config, mesh) instead"
            )
        mesh = make_mesh(
            tensor_parallel_size * max(1, sequence_parallel_size),
            tp=tensor_parallel_size,
            sp=sequence_parallel_size,
            fsdp=1,
            dp=1,
            devices=devs,
        )
        return cls(mesh, rules, backend)

    def bind(self, rank: int, group=None) -> "PartitionPlan":
        """This plan as rank ``rank`` runs it, with its ``tp`` group."""
        return PartitionPlan(self.mesh.bind(rank, {"tp": group} if group else {}),
                             self.rules, self.backend)

    # -- mesh facts ----------------------------------------------------------

    @property
    def tp(self) -> int:
        return int(self.mesh.shape.get("tp", 1))

    @property
    def num_devices(self) -> int:
        return int(self.mesh.size)

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def group(self):
        """The bound rank's ``tp`` collective group (None when unbound)."""
        return self.mesh.group("tp")

    def device(self, rank: Optional[int] = None) -> torch.device:
        return self.mesh.device(rank)

    def describe(self) -> str:
        """Compact mesh tag for spans/metrics/stats: 'tp=2' (only
        non-trivial axes; 'tp=1' when fully trivial so the tag is never
        empty)."""
        parts = [f"{a}={s}" for a, s in self.mesh.shape.items() if s > 1]
        return ",".join(parts) if parts else "tp=1"

    def mesh_shape(self) -> Dict[str, int]:
        return {a: int(s) for a, s in self.mesh.shape.items() if s > 1}

    # -- layouts -------------------------------------------------------------

    def param_specs(self, params: Mapping[str, Any]) -> Dict[str, PartitionSpec]:
        return match_partition_rules(self.rules, params)

    def _shard(self, t: torch.Tensor, spec: PartitionSpec, rank: Optional[int]):
        return shard_tensor(t, spec, self.mesh.coords(rank), self.mesh.shape)

    def shard_params(self, params: Mapping[str, torch.Tensor],
                     rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Rank ``rank``'s (default: the bound rank's) slice of every
        parameter, as views of the given tensors (``.clone()`` one to free
        the full tensor)."""
        specs = self.param_specs(params)
        return {name: self._shard(t, specs[name], rank) for name, t in params.items()}

    def shard_param(self, name: str, t: torch.Tensor,
                    rank: Optional[int] = None) -> torch.Tensor:
        """:meth:`shard_params` of one parameter."""
        return self._shard(t, self.param_specs({name: t})[name], rank)

    def local_shapes(self, shapes: Mapping[str, Sequence[int]]) -> Dict[str, torch.Size]:
        """The shape of each rank's slice of parameters of ``shapes``."""
        return {name: self.shard_param(name, torch.empty(s, device="meta")).shape
                for name, s in shapes.items()}

    def lora_bank_shardings(self, bank: Mapping[str, Any]) -> Dict[str, PartitionSpec]:
        """Specs for an adapter slot bank: each ``lora_a``/``lora_b`` leaf
        is the per-adapter matrix with a leading ``num_slots`` axis, so the
        2-D rule table is matched by name and a replicated slot axis is
        prepended to each spec."""
        return {name: P(None, *spec) for name, spec in self.param_specs(bank).items()}

    def lora_row_shards(self, adapter: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
                        rank: Optional[int] = None) -> Dict[str, Tuple[torch.Tensor, ...]]:
        """Rank ``rank``'s (default: the bound rank's) slice of one slot-bank
        row, from the full adapter ``{projection: (lora_a (n_layers, in, r),
        lora_b (n_layers, r, out))}`` (views). The specs are
        :meth:`lora_bank_shardings`'s, whose replicated leading axis is here
        the layer axis: wq/wk/wv split ``lora_b`` on the output (head) dim
        and replicate ``lora_a``, wo splits ``lora_a`` on the input dim and
        replicates ``lora_b``, as their base kernels split."""
        names = {f"attn.{proj}.{factor}": t for proj, pair in adapter.items()
                 for factor, t in zip(("lora_a", "lora_b"), pair)}
        specs = self.lora_bank_shardings(names)
        return {proj: tuple(self._shard(names[f"attn.{proj}.{factor}"],
                                        specs[f"attn.{proj}.{factor}"], rank)
                            for factor in ("lora_a", "lora_b"))
                for proj in adapter}

    def kv_heads_per_rank(self, n_kv_heads: int) -> int:
        """KV heads in one rank's slice of a decode cache or a block pool
        (:data:`KV_SPEC`'s head axis): the one place that fixes the cache
        and pool layouts. A rank's query heads are these KV heads' whole
        GQA groups."""
        return self._shard(torch.empty(1, n_kv_heads, 1, 1, device="meta"), KV_SPEC,
                           None).shape[1]

    def kv_head_shard(self, t: torch.Tensor, axis: int,
                      rank: Optional[int] = None) -> torch.Tensor:
        """Rank ``rank``'s (default: the bound rank's) KV heads of ``t``,
        whose heads lie on ``axis``: a view of :data:`KV_SPEC`'s head split,
        so the ranks' slices in rank order concatenate back to ``t``."""
        return self._shard(t, P(*([None] * axis), KV_SPEC[1]), rank)

    def kv_sharding(self) -> PartitionSpec:
        """KV leaves, decode-cache rows AND paged block pools (heads is axis
        1 in both per-layer layouts)."""
        return KV_SPEC

    def cache_shardings(self, cache: Mapping[str, torch.Tensor]) -> Dict[str, PartitionSpec]:
        """Specs of a decode cache's tensors (name -> tensor): KV tensors
        (ndim >= 4; the port's carry a leading layer axis) split heads,
        index tensors replicate."""
        return {name: P(*([None] * (t.dim() - 4)), *KV_SPEC) if t.dim() >= 4 else P()
                for name, t in cache.items()}
