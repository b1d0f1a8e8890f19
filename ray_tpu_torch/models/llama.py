"""LLaMA-family transformer: the port of ray_tpu/models/llama.py.

Module and parameter names follow the flax tree, so ``state_dict()`` keys
are the flax paths joined by dots (``layer_0.attn.wq.base.kernel``,
``embed``, ...) and converted weights load one to one (models/convert.py).
Dense kernels are stored as flax stores them, (in, out), and applied as
``x @ kernel``; ``embed`` (vocab, dim) and ``lm_head`` (dim, vocab) are
separate weights.

Tensor parallelism (``Llama(config, plan=, rank=, group=)``, Megatron-style
as the reference's GSPMD plan lays it out, parallel/plan.py): each rank
holds heads/tp query and KV heads (wq/wk/wv column slices, wo row slice),
intermediate/tp of the MLP (w_gate/w_up columns, w_down rows) and vocab/tp
rows of ``embed`` and columns of ``lm_head``; norms are replicated. The
model calls ``group`` where GSPMD puts a collective: an allreduce (SUM)
after wo and after w_down, one after the masked embedding lookup (exact:
one rank's term is non-zero), and an all-gather of the vocab slices of the
logits (exact: each logit is one whole dot product), so activations and
logits come out replicated on every rank: 2 * n_layers + 2 collectives a
model call. The decode caches hold the rank's KV heads.

Numerics follow the reference: a dense layer casts its input and its kernel
to ``config.dtype`` (flax ``DenseGeneral(dtype=bf16, param_dtype=f32)``),
norm weights are cast to the activation dtype before the norm, RoPE tables
are f32, and the logits come out in ``config.dtype``.

``Llama.forward(tokens)`` is the full-sequence forward (flash attention,
the reference's ``decode=False``).

Over a mesh (``Llama(config, mesh)``, the mesh bound with its sub-groups
by ``Mesh.form_groups`` or ``train.collective.gang_mesh``; ``dcn``, ``dp``,
``fsdp``, ``tp`` and ``sp``, as the reference's Llama takes them, ``pp``
refused) each rank is one process holding its block of every parameter by
the reference's rule table (``LLAMA_LOGICAL_AXES``: the heads, the MLP's
hidden units and the vocabulary over ``tp``, ``embed`` over ``fsdp``), its
rows of the global batch (the data axes ``dcn``, ``dp``, ``fsdp``, as
``process_local_batch`` gives them; replicated over ``tp`` and ``sp``) and,
under ``sp``, its contiguous S / sp of each sequence. The full forward
takes the rank's rows at their whole length, gathers each parameter's
``fsdp`` dimension where it is read (parallel/fsdp.py; again in the remat
recompute) and computes what the reference's GSPMD program computes:

- the embedding: the rank's vocabulary rows, a masked lookup summed over
  ``tp`` (``sum_of_ranks``);
- attention: the rank's n_heads / tp query and n_kv_heads / tp KV heads
  (Megatron's f before the projections, g after wo), rotated at their
  global positions (RoPE offset ``sp_rank * S / sp``), through K2 or, under
  ``sp``, the ring over the rank's ``sp`` sub-group
  (parallel/ring_attention.py);
- the MLP: intermediate / tp hidden units between f and g;
- the adapters: a column-split projection's ``x @ lora_a`` (replicated
  over ``tp``) enters the region through its own f, and a row-split wo's
  ``x_r @ lora_a_r`` leaves it through its own g before ``lora_b``
  (replicated over ``tp``). Summing the LoRA term with the base term under
  wo's one g gives the same forward, but then each ``tp`` rank's gradient
  of ``lora_b`` is only its heads' share (and a column-split ``lora_a``'s
  likewise): with the pair around the rank-r products every parameter's
  gradient is whole on its ``tp`` ranks;
- the head: the rank's vocabulary columns, the logits gathered over ``tp``
  (``gather_from_group``), under remat.

It returns the rank's (rows, S / sp, vocab) logits. :func:`next_token_loss`
pairs each sequence shard's last position with the next shard's first token
and sums the ranks' NLL terms over the data axes and ``sp``
(``sum_of_ranks``): every rank returns the global batch's loss, and its
backward gives each rank's parameters their share of the gradient, which
``model.fsdp.sync_gradients`` completes. The decode-mode call never takes
the ring, as in the reference: at a mesh whose only axis past 1 is ``sp``
(every parameter whole) it runs the whole call on every rank; past that
it raises.

``Llama.forward(tokens, cache)`` is the reference's ``decode=True`` path:
attention over a dense per-layer KV cache (a :class:`DecodeCache` of
:class:`LayerCache` views) as plain f32 einsum, as in the reference.

Training: with ``config.remat`` and autograd recording, each block of the
full-sequence forward runs under ``torch.utils.checkpoint`` and is
recomputed in the backward, the reference's save-nothing ``nn.remat``.
A model over a mesh holds its rank's FSDP layout as ``Llama.fsdp`` (None
otherwise).
``config.scan_layers`` (the reference's layers stacked under ``lax.scan``)
builds the same unstacked model: PyTorch has no scan, the loop over blocks
with per-block checkpointing takes its place, and models/convert.py
unstacks the stacked weights.

Multi-tenant serving: ``Llama.forward(tokens, cache, adapters,
adapter_slots)`` takes an adapter slot bank (ray_tpu_torch.lora
``AdapterStore.bank()``) and one slot per row, -1 for the base model. The
bank is stacked over layers, so the rows of every layer are gathered once
per model call (:func:`gather_adapters`), and each q/k/v/o projection adds
``x @ A[slot] @ B[slot]`` in two batched products; slot -1 reads the bank's
all-zero last row, so a base row adds exactly zero.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._internal.device import DeviceLike, resolve_device
from ..collective.functional import copy_to_group, gather_from_group, sum_of_ranks
from ..ops.flash_attention import flash_attention
from ..ops.rmsnorm import rmsnorm
from ..ops.rope import apply_rope, rope_table
from ..parallel.mesh import LOSS_AXES, check_model_mesh
from ..parallel.ring_attention import ring_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    intermediate: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    # the reference's stacked-layer layout; the port builds the same model
    # either way (see the module docstring)
    scan_layers: bool = False
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(
            dim=5120, n_layers=40, n_heads=40, n_kv_heads=40, intermediate=13824, **kw
        )

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            intermediate=14336, rope_theta=500000.0, **kw
        )

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale config: runs on the CPU in seconds."""
        defaults = dict(
            vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
            intermediate=256, max_seq_len=512, remat=False,
        )
        defaults.update(kw)
        return LlamaConfig(**defaults)


@dataclasses.dataclass
class LayerCache:
    """One layer's decode cache, updated IN PLACE by each decode-mode call:
    ``cached_key``/``cached_value`` (b, n_kv_heads, max_seq_len, head_dim) in
    ``config.dtype`` and ``cache_index`` (b,) int32, the next write position
    of each row."""

    cached_key: torch.Tensor
    cached_value: torch.Tensor
    cache_index: torch.Tensor


class DecodeCache(list):
    """The decode cache of every layer, stacked: ``key`` and ``value``
    (n_layers, rows, n_kv_heads, max_seq_len, head_dim) and ``index``
    (n_layers, rows). Its items are one :class:`LayerCache` per layer, views
    into those tensors, which the model reads and writes in place. A row
    copy, a block gather or an index reset is then one op for all layers,
    not one per layer: serving pays for every launch."""

    def __init__(self, key: torch.Tensor, value: torch.Tensor, index: torch.Tensor):
        super().__init__(
            LayerCache(key[i], value[i], index[i]) for i in range(key.shape[0])
        )
        self.key, self.value, self.index = key, value, index

    def row(self, si: int) -> "DecodeCache":
        """Row ``si`` as a 1-row cache that shares this one's storage: a
        decode call on it writes here."""
        return DecodeCache(
            self.key[:, si:si + 1], self.value[:, si:si + 1], self.index[:, si:si + 1]
        )

    def insert_row(self, si: int, row: "DecodeCache") -> None:
        """Copy a 1-row cache, K/V and write position, into row ``si``."""
        self.key[:, si].copy_(row.key[:, 0])
        self.value[:, si].copy_(row.value[:, 0])
        self.index[:, si].copy_(row.index[:, 0])

    def set_index(self, index: torch.Tensor) -> None:
        """Set every layer's write position of each row to ``index``
        (rows,); K/V stay as they are."""
        self.index.copy_(index.to(self.index)[None].expand_as(self.index))


def new_cache(config: LlamaConfig, batch: int, device, plan=None) -> DecodeCache:
    """An empty (all-zero) cache for ``batch`` rows, with a tensor-parallel
    ``plan``'s KV heads per rank."""
    heads = config.n_kv_heads if plan is None else plan.kv_heads_per_rank(config.n_kv_heads)
    shape = (config.n_layers, batch, heads, config.max_seq_len, config.head_dim)
    return DecodeCache(
        torch.zeros(shape, dtype=config.dtype, device=device),
        torch.zeros(shape, dtype=config.dtype, device=device),
        torch.zeros((config.n_layers, batch), dtype=torch.int32, device=device),
    )


def _param(*shape, dtype) -> nn.Parameter:
    # filled by init_params or by loading weights
    return nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)


class Dense(nn.Module):
    """flax ``DenseGeneral`` without bias: ``x.to(dtype) @ kernel.to(dtype)``."""

    def __init__(self, in_features: int, out_features: int, param_dtype, dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(in_features, out_features, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class LoRADense(nn.Module):
    """Dense with the optional static low-rank adapter of the reference:
    y = xW + (alpha/r)·xAB, with ``lora_a`` (in, r) and ``lora_b`` (r, out).

    Multi-tenant serving path: ``adapter`` is a pair of per-row factors
    ``(a (batch, in, r), b (batch, r, out))`` in ``x.dtype``, the rows of a
    slot bank gathered for this call (:func:`gather_adapters`; ``lora_b``
    pre-scaled by alpha/r at attach), and the delta is ``x @ a @ b`` per
    row: ``baddbmm_`` adds it to the base output, exactly zero for a row
    that gathered the bank's zero row."""

    def __init__(self, in_features, out_features, rank, alpha, param_dtype, dtype):
        super().__init__()
        self.base = Dense(in_features, out_features, param_dtype, dtype)
        self.rank = rank
        self.scale = alpha / rank if rank > 0 else 0.0
        if rank > 0:
            self.lora_a = _param(in_features, rank, dtype=param_dtype)
            self.lora_b = _param(rank, out_features, dtype=param_dtype)

    def forward(self, x, adapter=None):
        y = self.base(x)
        if self.rank > 0:
            y = y + (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype) * self.scale
        if adapter is not None:
            a, b = adapter
            # in place: y is this call's own output, and an out-of-place
            # baddbmm would first copy it (one more launch per projection)
            y = y.baddbmm_(torch.bmm(x, a), b)
        return y


    def column_split(self, x_in, x, group):
        """The projection split over ``group`` by columns (the rank's
        output columns): the base reads ``x_in``, the replicated ``x``
        entered into the region (``copy_to_group``), and the adapter's
        ``x @ lora_a``, replicated too, enters it through its own f."""
        y = self.base(x_in)
        if self.rank > 0:
            u = copy_to_group(x @ self.lora_a.to(x.dtype), group)
            y = y + u @ self.lora_b.to(x.dtype) * self.scale
        return y

    def row_split(self, x, group):
        """The projection split over ``group`` by rows: ``x`` is the rank's
        slice of the input, and the base's partial sums and the adapter's
        ``x @ lora_a`` leave the region through a g each (the sum over the
        ranks), so ``lora_b`` reads the whole rank-r product."""
        y = sum_of_ranks(self.base(x), group)
        if self.rank > 0:
            u = sum_of_ranks(x @ self.lora_a.to(x.dtype), group)
            y = y + u @ self.lora_b.to(x.dtype) * self.scale
        return y


PROJECTIONS = ("wq", "wk", "wv", "wo")  # the LoRADense layers of Attention


def gather_adapters(bank, adapter_slots, dtype, device) -> Dict[str, tuple]:
    """The rows of ``bank`` that a call's rows name, for every layer at once.

    ``bank`` maps each projection of :data:`PROJECTIONS` to ``{"lora_a":
    (n_layers, rows, in, r), "lora_b": (n_layers, rows, r, out)}``, whose
    last row is all zero; ``adapter_slots`` are the call's slots on the host
    (one int per row, -1 for the base model, which reads the zero row).
    Returns ``{projection: (a (n_layers, batch, in, r), b (n_layers, batch,
    r, out))}`` in ``dtype``: one gather per factor, and one cast where the
    bank's dtype differs."""
    rows = bank[PROJECTIONS[0]]["lora_a"].shape[1]
    idx = torch.as_tensor(adapter_slots, dtype=torch.long).flatten()
    if bool(((idx < -1) | (idx >= rows - 1)).any()):
        raise ValueError(f"adapter slots {idx.tolist()} outside [-1, {rows - 1})")
    idx = idx.remainder(rows).to(device)
    return {
        name: (bank[name]["lora_a"][:, idx].to(dtype), bank[name]["lora_b"][:, idx].to(dtype))
        for name in PROJECTIONS
    }


def sequence_parallel(mesh):
    """(group, rank, size) of ``mesh``'s ``sp`` axis: (None, 0, 1) without
    a mesh or at sp = 1. An ``sp`` axis past 1 needs the mesh bound with
    its rank's ``sp`` sub-group (the ring runs over it, whatever other axes
    the mesh has); an unbound mesh is refused."""
    if mesh is None or mesh.shape["sp"] == 1:
        return None, 0, 1
    sp = mesh.shape["sp"]
    group = mesh.group("sp")
    if group is None or group.world_size != sp:
        raise ValueError(f"a sequence-parallel mesh (sp={sp}) must be bound to its rank with "
                         "its group of sp ranks: mesh.bind(rank, {'sp': group}), or "
                         "Mesh.form_groups")
    if group.rank != mesh.coords()["sp"]:
        raise ValueError(f"the sp group's rank {group.rank} is not the mesh's "
                         f"{mesh.coords()['sp']}")
    return group, group.rank, sp


def vocab_rows_lookup(embed: torch.Tensor, tokens: torch.Tensor, rank: int,
                      dtype) -> torch.Tensor:
    """Rank ``rank``'s term of an embedding split by vocabulary rows:
    ``embed`` is its block of rows, the tokens in it are looked up (in
    ``dtype``) and every other token gets zeros, so the sum over the ranks
    is the whole lookup."""
    rows = embed.shape[0]
    local = tokens - rank * rows
    mine = (local >= 0) & (local < rows)
    x = embed[local.clamp(0, rows - 1)].to(dtype)
    return x.masked_fill(~mine[..., None], 0)


def _allreduce(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (None: one rank)."""
    return x if group is None else group.allreduce_(x)


class Attention(nn.Module):
    """With a tensor-parallel ``plan``: the rank's KV heads
    (``plan.kv_heads_per_rank``) and their whole GQA groups of query heads,
    and the allreduce of wo's partial sums over ``group``. With a
    sequence-parallel ``mesh`` (:func:`sequence_parallel`): the full
    forward's x is the rank's shard of the sequence, and attention is the
    ring over the mesh's ``sp`` group.

    With ``tp_group`` (training under a mesh's ``tp`` axis: the Llama's and
    the MoE's blocks): the rank's n_heads / tp query and n_kv_heads / tp KV
    heads, the column blocks of wq/wk/wv and the row block of wo, as the
    reference's rule table splits them, and Megatron's differentiable pair
    around them: ``copy_to_group`` before the projections, ``sum_of_ranks``
    after wo (and a pair around the adapters' rank-r products,
    :meth:`LoRADense.column_split` / :meth:`LoRADense.row_split`). The
    serving plan's ``group`` keeps its in-place allreduce."""

    def __init__(self, config: LlamaConfig, mesh=None, plan=None, group=None, tp_group=None):
        super().__init__()
        self.sp_group, self.sp_rank, _ = sequence_parallel(mesh)
        self.config = config
        self.group = group
        self.tp_group = tp_group
        cfg = config
        hk = cfg.n_kv_heads if plan is None else plan.kv_heads_per_rank(cfg.n_kv_heads)
        if tp_group is not None:
            tp = tp_group.world_size
            if cfg.n_kv_heads % tp:
                raise ValueError(f"{cfg.n_kv_heads} KV heads do not split over tp={tp}")
            hk = cfg.n_kv_heads // tp
        h, d = hk * (cfg.n_heads // cfg.n_kv_heads), cfg.head_dim
        self.n_heads, self.n_kv_heads = h, hk

        def proj(n_in, n_out):
            return LoRADense(
                n_in, n_out, cfg.lora_rank, cfg.lora_alpha, cfg.param_dtype, cfg.dtype
            )

        self.wq = proj(cfg.dim, h * d)
        self.wk = proj(cfg.dim, hk * d)
        self.wv = proj(cfg.dim, hk * d)
        self.wo = proj(h * d, cfg.dim)

    def forward(self, x, cos, sin, cache: Optional[LayerCache] = None, adapters=None):
        """``adapters``: this layer's per-row factors by projection name
        (:func:`gather_adapters`, indexed at the layer), or None."""
        cfg = self.config
        b, s, _ = x.shape
        h, hk, d = self.n_heads, self.n_kv_heads, cfg.head_dim
        adapters = adapters or {}
        tp = self.tp_group
        if tp is not None:
            x_in = copy_to_group(x, tp)
            q, k, v = (proj.column_split(x_in, x, tp) for proj in (self.wq, self.wk, self.wv))
        else:
            q, k, v = (proj(x, adapters.get(name))
                       for name, proj in (("wq", self.wq), ("wk", self.wk), ("wv", self.wv)))
        q = q.reshape(b, s, h, d).transpose(1, 2)
        k = k.reshape(b, s, hk, d).transpose(1, 2)
        v = v.reshape(b, s, hk, d).transpose(1, 2)
        if cache is not None:
            out = self._decode_attention(q, k, v, cos, sin, cache)
        elif self.sp_group is not None:
            offset = self.sp_rank * s  # the shard's first global position
            q = apply_rope(q, cos, sin, offset=offset)
            k = apply_rope(k, cos, sin, offset=offset)
            out = ring_attention(q, k, v, group=self.sp_group)
        else:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            out = flash_attention(q, k, v, causal=True)
        out = out.transpose(1, 2).reshape(b, s, h * d)
        if tp is not None:
            return self.wo.row_split(out, tp)
        return _allreduce(self.group, self.wo(out, adapters.get("wo")))

    def _decode_attention(self, q, k, v, cos, sin, cache: LayerCache):
        """The reference's KV-cache path: write this call's K/V at each
        row's ``cache_index`` (in place), advance the index by ``s``, and
        attend over the whole cache with positions past the row's own
        masked."""
        cfg = self.config
        b, h, s, d = q.shape
        idx = cache.cache_index.clone()  # (b,) positions before this call
        q = apply_rope(q, cos, sin, offset=idx)
        k = apply_rope(k, cos, sin, offset=idx)
        # per-row insertion, with the start clamped to [0, max_seq_len - s]
        # as lax.dynamic_update_slice clamps it: never out of bounds
        start = idx.long().clamp(0, cfg.max_seq_len - s)
        pos = start[:, None] + torch.arange(s, device=q.device)  # (b, s)
        rows = torch.arange(b, device=q.device)[:, None]
        cache.cached_key.transpose(1, 2)[rows, pos] = k.to(cfg.dtype).transpose(1, 2)
        cache.cached_value.transpose(1, 2)[rows, pos] = v.to(cfg.dtype).transpose(1, 2)
        cache.cache_index.add_(s)
        k_all = cache.cached_key.repeat_interleave(h // self.n_kv_heads, dim=1)
        v_all = cache.cached_value.repeat_interleave(h // self.n_kv_heads, dim=1)
        # row r's query i sits at absolute position idx[r]+i; key j is
        # visible iff j <= idx[r]+i (and thus has been written)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_all.float()) / math.sqrt(d)
        q_pos = idx.long()[:, None, None] + torch.arange(s, device=q.device)[None, :, None]
        k_pos = torch.arange(cfg.max_seq_len, device=q.device)[None, None, :]
        scores = scores.masked_fill(~(k_pos <= q_pos)[:, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v_all.float()).to(cfg.dtype)


class MLP(nn.Module):
    """With ``tp`` > 1: intermediate/tp of the hidden units, and the sum of
    w_down's partial sums over the ranks: the serving plan's in-place
    allreduce over ``group``, or, in training over a mesh (``tp_group``),
    Megatron's pair, ``copy_to_group`` before w_gate/w_up and
    ``sum_of_ranks`` after w_down."""

    def __init__(self, config: LlamaConfig, tp: int = 1, group=None, tp_group=None):
        super().__init__()
        cfg = config
        self.group = group
        self.tp_group = tp_group
        if tp_group is not None:
            tp = tp_group.world_size
            if cfg.intermediate % tp:
                raise ValueError(f"{cfg.intermediate} hidden units do not split over tp={tp}")
        inter = cfg.intermediate // tp
        self.w_gate = Dense(cfg.dim, inter, cfg.param_dtype, cfg.dtype)
        self.w_up = Dense(cfg.dim, inter, cfg.param_dtype, cfg.dtype)
        self.w_down = Dense(inter, cfg.dim, cfg.param_dtype, cfg.dtype)

    def forward(self, x):
        if self.tp_group is not None:
            x = copy_to_group(x, self.tp_group)
            return sum_of_ranks(self.w_down(F.silu(self.w_gate(x)) * self.w_up(x)), self.tp_group)
        return _allreduce(self.group, self.w_down(F.silu(self.w_gate(x)) * self.w_up(x)))


class Block(nn.Module):
    def __init__(self, config: LlamaConfig, mesh=None, plan=None, group=None):
        super().__init__()
        self.config = config
        tp_group = None if mesh is None else mesh.group("tp")
        self.attn_norm = _param(config.dim, dtype=config.param_dtype)
        self.attn = Attention(config, mesh, plan, group, tp_group)
        self.mlp_norm = _param(config.dim, dtype=config.param_dtype)
        self.mlp = MLP(config, plan.tp if plan is not None else 1, group, tp_group)

    def forward(self, x, cos, sin, cache: Optional[LayerCache] = None, adapters=None):
        eps = self.config.norm_eps
        h = x + self.attn(
            rmsnorm(x, self.attn_norm.to(x.dtype), eps), cos, sin, cache, adapters
        )
        return h + self.mlp(rmsnorm(h, self.mlp_norm.to(h.dtype), eps))


class Llama(nn.Module):
    """Parameters are created empty: fill them with :func:`init_params` or
    load converted weights (:func:`build_llama`).

    With a ``plan`` (parallel/plan.py ``PartitionPlan``) of tp > 1 the
    modules have rank ``rank``'s widths and ``group`` (a collective group of
    the plan's tp ranks, one process each) carries the collectives. With a
    ``mesh`` (and no plan) the parameters have the shapes of this rank's
    blocks and the full forward runs the rank's part of the mesh's program;
    see the module docstring."""

    def __init__(self, config: LlamaConfig, mesh=None, plan=None, rank: int = 0,
                 group=None):
        super().__init__()
        if mesh is not None and plan is not None:
            raise ValueError("a Llama takes a serving plan or a training mesh, not both")
        if mesh is not None:
            check_model_mesh(mesh, "Llama over a mesh", sequence=True)
        self.sp_group, self.sp_rank, self.sp = sequence_parallel(mesh)
        tp = plan.tp if plan is not None else 1 if mesh is None else mesh.shape["tp"]
        if plan is not None and tp > 1 and group is None:
            raise ValueError(f"a tensor-parallel Llama (tp={tp}) needs the collective "
                             "group of its ranks")
        if config.vocab_size % tp:
            raise ValueError(
                f"vocab_size {config.vocab_size} is not divisible by tensor_parallel_size "
                f"{tp}: embed and lm_head split the vocabulary evenly or not at all"
            )
        self.config = config
        self.mesh = mesh
        self.rank = rank
        self.group = group if plan is not None and tp > 1 else None
        self.embed = _param(config.vocab_size // tp, config.dim, dtype=config.param_dtype)
        for i in range(config.n_layers):
            self.add_module(f"layer_{i}", Block(config, mesh, plan, self.group))
        self.final_norm = _param(config.dim, dtype=config.param_dtype)
        self.lm_head = _param(config.dim, config.vocab_size // tp, dtype=config.param_dtype)
        self._rope = None
        #: the rank's parallel.fsdp.FSDP layout over the mesh (None without one)
        self.fsdp = None
        if mesh is not None:
            from ..parallel.fsdp import FSDP
            from ..parallel.sharding import llama_logical_axes

            FSDP.for_model(mesh, param_shapes(config), llama_logical_axes).localize(self)

    def blocks(self) -> List[Block]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def _rope_table(self, device):
        if self._rope is None or self._rope[0].device != device:
            cfg = self.config
            self._rope = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, device)
        return self._rope

    def forward(
        self,
        tokens: torch.Tensor,
        cache: Optional[List[LayerCache]] = None,
        adapters=None,
        adapter_slots=None,
    ) -> torch.Tensor:
        """tokens (batch, seq) -> logits (batch, seq, vocab) in
        ``config.dtype``. With ``cache`` (one :class:`LayerCache` per layer)
        this is the decode-mode call, which updates the cache in place.
        With ``adapters`` (an adapter slot bank, see :func:`gather_adapters`)
        and ``adapter_slots`` (one slot per row on the host, -1 = base) each
        row's adapter is added to its q/k/v/o projections. Over a mesh the
        full forward takes the rank's rows (rows, S) and returns their
        (rows, S / sp, vocab) logits."""
        cfg = self.config
        if self.mesh is not None:
            if cache is None and adapters is None:
                return self._mesh_forward(tokens)
            split = {a: n for a, n in self.mesh.shape.items() if a != "sp" and n > 1}
            if adapters is not None or split:
                raise NotImplementedError(
                    f"a Llama over a mesh split over {split} runs the full-sequence forward "
                    "only (the decode-mode call runs where every parameter is whole: sp alone)")
        x = self.embed[tokens].to(cfg.dtype) if self.group is None else self._embed(tokens)
        cos, sin = self._rope_table(x.device)
        rows = None
        if adapters is not None and adapter_slots is not None:
            rows = gather_adapters(adapters, adapter_slots, cfg.dtype, x.device)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks()):
            layer = None if rows is None else {n: (a[i], b[i]) for n, (a, b) in rows.items()}
            if remat:
                # use_reentrant=False: with a frozen base the block's input
                # needs no grad, and the reentrant form would then drop the
                # adapters' gradients
                x = checkpoint(block, x, cos, sin, None, layer, use_reentrant=False)
            else:
                x = block(x, cos, sin, None if cache is None else cache[i], layer)
        x = rmsnorm(x, self.final_norm.to(x.dtype), cfg.norm_eps)
        logits = x @ self.lm_head.to(x.dtype)
        return logits if self.group is None else self.group.allgather_cat(logits, dim=-1)

    def _sequence_shard(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous S / sp of its (rows, S) tokens."""
        seq = tokens.shape[1]
        if seq % self.sp:
            raise ValueError(f"sequence length {seq} does not divide over sp={self.sp} ranks")
        if seq > self.config.max_seq_len:
            raise ValueError(f"sequence length {seq} exceeds max_seq_len "
                             f"{self.config.max_seq_len}: RoPE has no position past it")
        s = seq // self.sp
        return tokens[:, self.sp_rank * s:(self.sp_rank + 1) * s]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The serving plan's embedding lookup in ``config.dtype``: the
        rank's term (:func:`vocab_rows_lookup`), and the allreduce adds the
        one non-zero term of each token."""
        x = vocab_rows_lookup(self.embed, tokens, self.rank, self.config.dtype)
        return self.group.allreduce_(x)

    # -- over a mesh ---------------------------------------------------------

    def _gathered(self, name: str) -> torch.Tensor:
        return self.fsdp.gather(name, self.get_parameter(name))

    def _mesh_embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The rank's term of the lookup (its vocabulary rows, gathered
        over ``fsdp``) summed over ``tp`` with ``sum_of_ranks`` (one rank's
        term is non-zero: exact)."""
        embed = self._gathered("embed")
        tp = self.mesh.group("tp")
        if tp is None:
            return embed[tokens].to(self.config.dtype)
        return sum_of_ranks(vocab_rows_lookup(embed, tokens, tp.rank, self.config.dtype), tp)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.mesh.group("tp")
        if tp is None:
            return x @ self._gathered("lm_head").to(x.dtype)
        logits = copy_to_group(x, tp) @ self._gathered("lm_head").to(x.dtype)
        return gather_from_group(logits, tp, dim=-1)

    def _mesh_forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if self.sp_group is not None:
            tokens = self._sequence_shard(tokens)
        x = self._mesh_embed(tokens)
        cos, sin = self._rope_table(x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks()):
            if remat:
                x = checkpoint(self.fsdp.call_block, block, f"layer_{i}.", x, cos, sin,
                               use_reentrant=False)
            else:
                x = self.fsdp.call_block(block, f"layer_{i}.", x, cos, sin)
        x = rmsnorm(x, self._gathered("final_norm").to(x.dtype), cfg.norm_eps)
        if remat:  # the head's gathered columns are gathered again in the backward
            return checkpoint(self._head, x, use_reentrant=False)
        return self._head(x)


def _lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal on [-2, 2] scaled to variance
    1/fan_in, fan_in being every axis but the last: the input axis of an
    (in, out) kernel, and flax counts a leading axis, such as the MoE's
    experts, as receptive field (E·d for an (E, d, f) kernel)."""
    fan_in = t.numel() // t.shape[-1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.copy_(w * std)


@torch.no_grad()
def init_params(
    config: LlamaConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    shard: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Random parameters with the reference's initialisers, drawn from
    ``generator`` (default: seed 0 on ``device``): lecun-normal for dense
    kernels and ``lora_a``, normal(0.02) for ``embed`` and ``lm_head``, ones
    for the norms, zeros for ``lora_b``. JAX's PRNG bits cannot be
    reproduced, so these are not the reference's values. Returns the flat
    state dict, keyed by flax path with dots.

    ``shard(name, tensor)``, when given, is applied to each full tensor as
    soon as it is drawn, and its result is kept instead: a tensor-parallel
    rank draws every tensor in order from the same seed as every other rank
    and keeps its own slice, so no rank ever holds the whole model."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, params go to {device}")
    out: Dict[str, torch.Tensor] = {}
    for name, shape in param_shapes(config).items():
        p = torch.empty(shape, dtype=config.param_dtype, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if name in ("embed", "lm_head"):
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf in ("attn_norm", "mlp_norm", "final_norm"):
            p.fill_(1.0)
        elif leaf == "lora_b":
            p.zero_()
        else:  # dense kernels and lora_a
            _lecun_normal_(p, generator)
        out[name] = p if shard is None else shard(name, p)
        del p
    return out


def param_shapes(config: LlamaConfig, plan=None) -> Dict[str, torch.Size]:
    """Every parameter's name and shape, without allocating it; with a
    ``plan``, the shapes of one rank's slices."""
    with torch.device("meta"):
        model = Llama(config)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    return shapes if plan is None else plan.local_shapes(shapes)


def build_llama(config: LlamaConfig, params: Dict[str, torch.Tensor], mesh=None,
                plan=None) -> Llama:
    """A :class:`Llama` whose parameters ARE the given tensors (no copy), so
    several modules can share one set of weights. With a bound ``plan``
    (``PartitionPlan.bind``) the params are its rank's slices and the model
    runs that rank's part of the tensor-parallel forward. With a bound
    ``mesh`` each of ``params`` is this rank's block, or the whole tensor,
    whose block is then taken (a copy where it is split)."""
    with torch.device("meta"):
        if plan is None:
            model = Llama(config, mesh)
        else:
            model = Llama(config, mesh, plan, plan.rank, plan.group)
    if mesh is not None:
        params = model.fsdp.blocks_of(params, param_shapes(config))
    model.load_state_dict(params, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each position's NLL of its target, logsumexp(logits) -
    logits[target], in f32."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0].float()
    return lse - tgt


def nll_from_logits(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token NLL from full-sequence logits: pairs logits[:, :-1] with
    tokens[:, 1:], the mean of :func:`token_nll`."""
    return token_nll(logits[:, :-1], tokens[:, 1:]).mean()


def next_token_loss(
    config: LlamaConfig, model_or_params: Union[Llama, Mapping[str, torch.Tensor]],
    tokens: torch.Tensor,
) -> torch.Tensor:
    """Causal LM loss of the full-sequence forward (see
    :func:`nll_from_logits`). ``model_or_params`` is a :class:`Llama` built
    for ``config``, whose parameters that require grad receive gradients
    from ``loss.backward()``, or a flat state dict, which is run through
    :func:`build_llama` (every parameter frozen: a loss to read, not to
    differentiate).

    Over a mesh (see the module docstring) ``tokens`` are the rank's rows of
    the global batch, and every rank returns the loss over the global batch
    and whole sequences: the sum over the ranks (the data axes and ``sp``)
    of each rank's NLL sum over its positions that have a next token (a
    sequence shard's last one pairs with the next shard's first token)
    divided by the global batch x (S - 1). Its backward runs each rank's own
    term only, so the parameters' gradients summed over those ranks
    (``model.fsdp.sync_gradients``) are the loss's. Where the data axes and
    ``sp`` are all 1 this is the plain mean."""
    model = model_or_params
    if not isinstance(model, Llama):
        model = build_llama(config, dict(model_or_params))
    elif model.config != config:
        raise ValueError("the model was built for another config")
    logits = model(tokens)
    group = None if model.mesh is None else model.mesh.group(LOSS_AXES)
    if group is None:
        return nll_from_logits(logits, tokens)
    b, s, _ = logits.shape
    first = model.sp_rank * s + 1
    targets = tokens[:, first:first + s]  # the last sequence shard's has s - 1
    rows = b * model.mesh.axes_size(LOSS_AXES[:-1])
    local = token_nll(logits[:, :targets.shape[1]], targets).sum() / (rows * (tokens.shape[1] - 1))
    return sum_of_ranks(local, group)
