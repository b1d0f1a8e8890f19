"""Mixture-of-Experts transformer (Mixtral-style): the port of
ray_tpu/models/moe.py.

Llama attention blocks (the port's :class:`~.llama.Attention`: GQA through
the flash kernels, K2-K4, with RMSNorm's K1 before it) with the dense MLP
replaced by a top-k routed SwiGLU expert FFN. Module and parameter names
follow the flax tree, so ``state_dict()`` keys are the flax paths joined by
dots (``layer_0.moe.w_gate``, ``layer_0.attn.wq.base.kernel``, ...) and
models/convert.py carries the reference's weights in one to one.

Numerics follow the reference: the router is an f32 product of the tokens
and an f32 copy of its weight (nothing here enables TF32), gating runs in
f32 (parallel/expert.py), and the experts' three products run in the
activation dtype on (E, C, d) slabs. The reference dispatches and combines
with dense one-hot einsums in f32; :class:`MoEFFN` runs the indexed form of
the same function (:func:`~ray_tpu_torch.parallel.expert.moe_apply_indexed`).

Router aux losses: the reference sows ``router_aux_weight * aux`` into a
``losses`` collection for its loss to add. Here each block returns that
value beside its output, and :meth:`MoETransformer.forward` returns the
logits with the per-layer values, which :func:`next_token_loss` adds.

Training: with ``config.remat`` and autograd recording, each block runs
under ``torch.utils.checkpoint`` (the reference's save-nothing remat) and
is recomputed in the backward; routing is a deterministic function of the
block's input, so the recompute routes every token as the forward did.
The reference serves no MoE model (its replica fails on a ``MoEConfig``),
so there is no decode path here either.

Over a mesh (``MoETransformer(config, mesh)``, the mesh bound with its
sub-groups by ``Mesh.form_groups`` or ``train.collective.gang_mesh``) each
rank is one process holding its block of every parameter by the
reference's rule table (``MOE_LOGICAL_AXES``: the experts over ``ep``, the
experts' hidden units, the heads and the vocabulary over ``tp``, ``embed``
over ``fsdp``), its shard of the global batch (the data axes ``dcn``,
``dp``, ``fsdp``; the batch is replicated over ``ep``, ``tp`` and ``sp``)
and, under ``sp``, its contiguous S / sp of each sequence, as the Llama's
(``Llama._sequence_shard``). The forward gathers each block's ``fsdp``
dimension where the block starts (parallel/fsdp.py; again in the remat
recompute) and runs the same numbers as the reference's GSPMD program:

- the embedding: the rank's vocabulary rows, a masked lookup summed over
  ``tp`` (``sum_of_ranks``), as serving's;
- attention: the Llama's ``Attention`` built with the mesh, as the
  reference's ``MoEBlock`` builds the Llama's (``ray_tpu/models/moe.py:160``):
  the rank's heads (Megatron's f before the projections, g after wo),
  through K2-K4, and under ``sp`` RoPE at the tokens' global positions and
  the ring over the rank's ``sp`` sub-group (parallel/ring_attention.py);
- the experts: the router's weight gathered over ``ep`` (its gradient
  sliced back), the routing over the loss axes' group (the data axes and
  ``sp``; parallel/expert.py ``route(group=)``: the global batch's
  capacity, slots in the global ``(b, s)`` order and aux loss), the rank's
  E / ep experts at intermediate / tp on its tokens' slots, between f and
  g over ``ep`` and ``tp`` together (the ranks of one ``ep`` x ``tp``
  group share a data shard and an ``sp`` coordinate, so their tokens are
  one);
- the head: the rank's vocabulary columns, the logits gathered over ``tp``
  (``gather_from_group``);
- :func:`next_token_loss`: the global batch's loss on every rank
  (``sum_of_ranks`` over the loss axes' group of each rank's NLL sum over
  the global count; a sequence shard's last position pairs with the next
  shard's first token), its backward each rank's own share; the gradients
  are completed by ``model.fsdp.sync_gradients``.

``pp > 1`` raises: no model of the reference pipelines (ROADMAP kept item
33); a sequence that ``sp`` does not divide raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._internal.device import DeviceLike, resolve_device
from ..collective.functional import copy_to_group, gather_from_group, sum_of_ranks
from ..ops.rmsnorm import rmsnorm
from ..ops.rope import rope_table
from ..parallel.expert import Routing, expert_capacity, moe_apply_indexed, route
from ..parallel.mesh import EXPERT_AXES, LOSS_AXES, check_model_mesh
from .llama import (
    Attention,
    LlamaConfig,
    _lecun_normal_,
    _param,
    nll_from_logits,
    sequence_parallel,
    token_nll,
    vocab_rows_lookup,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    intermediate: int = 14336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02
    max_seq_len: int = 4096
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def attention_config(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size,
            dim=self.dim,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            intermediate=self.intermediate,
            max_seq_len=self.max_seq_len,
            rope_theta=self.rope_theta,
            norm_eps=self.norm_eps,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            remat=self.remat,
        )

    @staticmethod
    def mixtral_8x7b(**kw) -> "MoEConfig":
        return MoEConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "MoEConfig":
        defaults = dict(
            vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
            intermediate=256, n_experts=4, experts_per_token=2,
            max_seq_len=512, remat=False,
        )
        defaults.update(kw)
        return MoEConfig(**defaults)


class MoEFFN(nn.Module):
    """Top-k routed SwiGLU experts: ``router`` (d, E), ``w_gate`` and
    ``w_up`` (E, d, f), ``w_down`` (E, f, d). Returns the output and the
    weighted router aux loss. Over a mesh the tensors it computes with are
    the rank's blocks gathered over ``fsdp``: ``router`` (d, E / ep), the
    experts (E / ep, d, f / tp) and (E / ep, f / tp, d)."""

    def __init__(self, config: MoEConfig, mesh=None):
        super().__init__()
        cfg = self.config = config
        self.mesh = mesh
        ep, tp = (1, 1) if mesh is None else (mesh.shape["ep"], mesh.shape["tp"])
        if cfg.n_experts % ep or cfg.intermediate % tp:
            raise ValueError(f"{cfg.n_experts} experts of {cfg.intermediate} units do not "
                             f"split over ep={ep} x tp={tp}")
        e, d, f = cfg.n_experts // ep, cfg.dim, cfg.intermediate // tp
        self.router = _param(d, e, dtype=cfg.param_dtype)
        self.w_gate = _param(e, d, f, dtype=cfg.param_dtype)
        self.w_up = _param(e, d, f, dtype=cfg.param_dtype)
        self.w_down = _param(e, f, d, dtype=cfg.param_dtype)

    def route(self, tokens: torch.Tensor) -> Routing:
        """The routing of (t, d) tokens: f32 router logits, capacity from t."""
        cfg = self.config
        logits = tokens.float() @ self.router.float()
        capacity = expert_capacity(
            tokens.shape[0], cfg.n_experts, cfg.capacity_factor, cfg.experts_per_token
        )
        return route(logits, capacity, k=cfg.experts_per_token)

    def experts(self, inp: torch.Tensor) -> torch.Tensor:  # (E, C, d) -> (E, C, d)
        gate = torch.bmm(inp, self.w_gate.to(inp.dtype))
        up = torch.bmm(inp, self.w_up.to(inp.dtype))
        return torch.bmm(F.silu(gate) * up, self.w_down.to(inp.dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:  # (b, s, d)
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        if self.mesh is not None:
            return self._mesh_forward(tokens, (b, s, d))
        routing = self.route(tokens)
        out = moe_apply_indexed(tokens, routing, self.experts)
        return out.reshape(b, s, d), self.config.router_aux_weight * routing.aux_loss

    def mesh_route(self, tokens: torch.Tensor, rows: int = 1) -> Routing:
        """The routing of this rank's (t, d) tokens (``rows`` rows of its
        sequence shard) within the global batch: the router's expert
        columns gathered over ``ep``, f32 logits, the capacity of the
        global batch, slots and aux over the loss axes' group."""
        cfg, mesh = self.config, self.mesh
        router = self.router
        if mesh.group("ep") is not None:
            router = gather_from_group(router, mesh.group("ep"), dim=1)
        logits = tokens.float() @ router.float()
        capacity = expert_capacity(tokens.shape[0] * mesh.axes_size(LOSS_AXES),
                                   cfg.n_experts, cfg.capacity_factor, cfg.experts_per_token)
        return route(logits, capacity, k=cfg.experts_per_token, group=mesh.group(LOSS_AXES),
                     seq_shards=mesh.shape["sp"], rows=rows)

    def _mesh_forward(self, tokens, shape):
        cfg, mesh = self.config, self.mesh
        routing = self.mesh_route(tokens, rows=shape[0])
        group = mesh.group(EXPERT_AXES)
        e = self.w_gate.shape[0]
        e0 = mesh.coords()["ep"] * e
        weight = routing.weight
        if group is not None:
            tokens, weight = copy_to_group(tokens, group), copy_to_group(weight, group)
        out = moe_apply_indexed(tokens, routing, self.experts, experts=(e0, e0 + e),
                                weight=weight, dtype=torch.float32)
        if group is not None:
            out = sum_of_ranks(out, group)
        out = out.to(tokens.dtype).reshape(shape)
        return out, cfg.router_aux_weight * routing.aux_loss


class MoEBlock(nn.Module):
    def __init__(self, config: MoEConfig, mesh=None):
        super().__init__()
        self.config = config
        self.attn_norm = _param(config.dim, dtype=config.param_dtype)
        tp_group = None if mesh is None else mesh.group("tp")
        self.attn = Attention(config.attention_config(), mesh=mesh, tp_group=tp_group)
        self.ffn_norm = _param(config.dim, dtype=config.param_dtype)
        self.moe = MoEFFN(config, mesh)

    def forward(self, x, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
        eps = self.config.norm_eps
        h = x + self.attn(rmsnorm(x, self.attn_norm.to(x.dtype), eps), cos, sin)
        out, aux = self.moe(rmsnorm(h, self.ffn_norm.to(h.dtype), eps))
        return h + out, aux


class MoETransformer(nn.Module):
    """Parameters are created empty: fill them with :func:`init_params` or
    load converted weights (:func:`build_moe`). With a ``mesh`` they have
    the shapes of this rank's blocks (see the module docstring)."""

    def __init__(self, config: MoEConfig, mesh=None):
        super().__init__()
        tp = 1
        if mesh is not None:
            check_model_mesh(mesh, "MoETransformer over a mesh")
            tp = mesh.shape["tp"]
            if config.vocab_size % tp:
                raise ValueError(f"vocab_size {config.vocab_size} does not split over tp={tp}")
        self.sp_group, self.sp_rank, self.sp = sequence_parallel(mesh)
        self.config = config
        self.mesh = mesh
        self.embed = _param(config.vocab_size // tp, config.dim, dtype=config.param_dtype)
        for i in range(config.n_layers):
            self.add_module(f"layer_{i}", MoEBlock(config, mesh))
        self.final_norm = _param(config.dim, dtype=config.param_dtype)
        self.lm_head = _param(config.dim, config.vocab_size // tp, dtype=config.param_dtype)
        self._rope = None
        #: the rank's FSDP layout over the mesh (None without one)
        self.fsdp = None
        if mesh is not None:
            from ..parallel.fsdp import FSDP
            from ..parallel.sharding import moe_logical_axes

            FSDP.for_model(mesh, param_shapes(config), moe_logical_axes).localize(self)

    def blocks(self) -> List[MoEBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (batch, seq) -> (logits (batch, seq, vocab) in
        ``config.dtype``, the sown aux losses (n_layers,) f32: each layer's
        ``router_aux_weight * aux``)."""
        cfg = self.config
        if self.mesh is not None:
            return self._mesh_forward(tokens)
        x = self.embed[tokens].to(cfg.dtype)
        if self._rope is None or self._rope[0].device != x.device:
            self._rope = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, x.device)
        cos, sin = self._rope
        remat = cfg.remat and torch.is_grad_enabled()
        aux = []
        for block in self.blocks():
            if remat:
                x, a = checkpoint(block, x, cos, sin, use_reentrant=False)
            else:
                x, a = block(x, cos, sin)
            aux.append(a)
        x = rmsnorm(x, self.final_norm.to(x.dtype), cfg.norm_eps)
        return x @ self.lm_head.to(x.dtype), torch.stack(aux)

    # -- over a mesh ---------------------------------------------------------

    def _gathered(self, name: str) -> torch.Tensor:
        return self.fsdp.gather(name, self.get_parameter(name))

    def _head(self, x):
        tp = self.mesh.group("tp")
        if tp is None:
            return x @ self._gathered("lm_head").to(x.dtype)
        logits = copy_to_group(x, tp) @ self._gathered("lm_head").to(x.dtype)
        return gather_from_group(logits, tp, dim=-1)

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

    def _mesh_forward(self, tokens):
        """This rank's rows of the global batch -> the (rows, seq / sp,
        vocab) logits of its sequence shard and the per-layer aux losses of
        the global batch."""
        cfg, tp = self.config, self.mesh.group("tp")
        if self.sp_group is not None:
            tokens = self._sequence_shard(tokens)
        embed = self._gathered("embed")
        if tp is None:
            x = embed[tokens].to(cfg.dtype)
        else:
            x = sum_of_ranks(vocab_rows_lookup(embed, tokens, tp.rank, cfg.dtype), tp)
        if self._rope is None or self._rope[0].device != x.device:
            self._rope = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, x.device)
        cos, sin = self._rope
        remat = cfg.remat and torch.is_grad_enabled()
        aux = []
        for i, block in enumerate(self.blocks()):
            if remat:
                x, a = checkpoint(self.fsdp.call_block, block, f"layer_{i}.", x, cos, sin,
                                  use_reentrant=False)
            else:
                x, a = self.fsdp.call_block(block, f"layer_{i}.", x, cos, sin)
            aux.append(a)
        x = rmsnorm(x, self._gathered("final_norm").to(x.dtype), cfg.norm_eps)
        if remat:  # the head's gathered columns are gathered again in the backward
            return checkpoint(self._head, x, use_reentrant=False), torch.stack(aux)
        return self._head(x), torch.stack(aux)


@torch.no_grad()
def init_params(
    config: MoEConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    shard=None,
) -> Dict[str, torch.Tensor]:
    """Random parameters with the reference's initialisers, drawn from
    ``generator`` (default: seed 0 on ``device``): lecun-normal for the
    router, the experts and the attention kernels, normal(0.02) for
    ``embed`` and ``lm_head``, ones for the norms. JAX's PRNG bits cannot be
    reproduced, so these are not the reference's values. Returns the flat
    state dict, keyed by flax path with dots.

    ``shard(name, tensor)``, when given (``model.fsdp.shard`` of a model
    over a mesh), is applied to each full tensor as soon as it is drawn, and
    its result is kept: every rank draws every tensor in order from the same
    seed and keeps its block."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, params go to {device}")
    out: Dict[str, torch.Tensor] = {}
    for name, shape in param_shapes(config).items():
        p = torch.empty(shape, dtype=config.param_dtype, device=device)
        if name in ("embed", "lm_head"):
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith("norm"):
            p.fill_(1.0)
        else:
            _lecun_normal_(p, generator)
        out[name] = p if shard is None else shard(name, p)
        del p
    return out


def param_shapes(config: MoEConfig) -> Dict[str, torch.Size]:
    """Every parameter's name and shape, without allocating it."""
    with torch.device("meta"):
        model = MoETransformer(config)
    return {k: v.shape for k, v in model.state_dict().items()}


def build_moe(config: MoEConfig, params: Mapping[str, torch.Tensor],
              trainable: bool = False, mesh=None) -> MoETransformer:
    """A :class:`MoETransformer` whose parameters ARE the given tensors (no
    copy); every parameter trains if ``trainable`` (the reference's
    full-parameter step), else all are frozen. With a ``mesh``, each of
    ``params`` is this rank's block, or the whole tensor, whose block is
    then taken (a copy)."""
    with torch.device("meta"):
        model = MoETransformer(config, mesh)
    params = dict(params)
    if mesh is not None:
        params = model.fsdp.blocks_of(params, param_shapes(config))
    model.load_state_dict(params, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(trainable)
    return model


def next_token_loss(config: MoEConfig, *args) -> torch.Tensor:
    """Causal LM loss plus the router load-balance aux losses, one per
    layer, added in layer order as the reference adds its sown leaves.

    ``next_token_loss(config, mesh, model_or_params, tokens)`` (the
    reference's order) or ``next_token_loss(config, model_or_params,
    tokens)``. ``model_or_params`` is a :class:`MoETransformer` built for
    ``config`` (over ``mesh``, when one is given) or a flat state dict (run
    through :func:`build_moe`, frozen). Over a mesh, ``tokens`` are this
    rank's rows of the global batch (its shard over the data axes) and
    every rank returns the global batch's loss (see the module
    docstring)."""
    if len(args) == 3:
        mesh, model, tokens = args
    elif len(args) == 2:
        (model, tokens), mesh = args, None
    else:
        raise TypeError("next_token_loss(config, [mesh,] model_or_params, tokens)")
    if not isinstance(model, MoETransformer):
        model = build_moe(config, model, mesh=mesh)
    elif model.config != config:
        raise ValueError("the model was built for another config")
    elif mesh is not None and model.mesh is not mesh:
        raise ValueError("the model was built over another mesh")
    logits, aux = model(tokens)
    if model.mesh is None:
        loss = nll_from_logits(logits, tokens)
    else:
        mesh = model.mesh
        b, s, _ = logits.shape
        first = model.sp_rank * s + 1
        targets = tokens[:, first:first + s]  # the last sequence shard's has s - 1
        rows = b * mesh.axes_size(LOSS_AXES[:-1])
        loss = token_nll(logits[:, :targets.shape[1]], targets).sum() / (
            rows * (tokens.shape[1] - 1))
        group = mesh.group(LOSS_AXES)
        if group is not None:
            loss = sum_of_ranks(loss.reshape(1), group)[0]
    for a in aux:
        loss = loss + a
    return loss
