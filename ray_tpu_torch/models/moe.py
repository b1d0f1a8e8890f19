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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._internal.device import DeviceLike, resolve_device
from ..ops.rmsnorm import rmsnorm
from ..ops.rope import rope_table
from ..parallel.expert import Routing, expert_capacity, moe_apply_indexed, route
from .llama import Attention, LlamaConfig, _lecun_normal_, _param, nll_from_logits


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
    weighted router aux loss."""

    def __init__(self, config: MoEConfig):
        super().__init__()
        cfg = self.config = config
        e, d, f = cfg.n_experts, cfg.dim, cfg.intermediate
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
        routing = self.route(tokens)
        out = moe_apply_indexed(tokens, routing, self.experts)
        return out.reshape(b, s, d), self.config.router_aux_weight * routing.aux_loss


class MoEBlock(nn.Module):
    def __init__(self, config: MoEConfig):
        super().__init__()
        self.config = config
        self.attn_norm = _param(config.dim, dtype=config.param_dtype)
        self.attn = Attention(config.attention_config())
        self.ffn_norm = _param(config.dim, dtype=config.param_dtype)
        self.moe = MoEFFN(config)

    def forward(self, x, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
        eps = self.config.norm_eps
        h = x + self.attn(rmsnorm(x, self.attn_norm.to(x.dtype), eps), cos, sin)
        out, aux = self.moe(rmsnorm(h, self.ffn_norm.to(h.dtype), eps))
        return h + out, aux


class MoETransformer(nn.Module):
    """Parameters are created empty: fill them with :func:`init_params` or
    load converted weights (:func:`build_moe`)."""

    def __init__(self, config: MoEConfig, mesh=None):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(
                "a mesh (experts sharded over an expert-parallel axis, ring "
                "attention) comes with the port's parallel plans and ring "
                "attention, ROADMAP items A.5-A.6"
            )
        self.config = config
        self.embed = _param(config.vocab_size, config.dim, dtype=config.param_dtype)
        for i in range(config.n_layers):
            self.add_module(f"layer_{i}", MoEBlock(config))
        self.final_norm = _param(config.dim, dtype=config.param_dtype)
        self.lm_head = _param(config.dim, config.vocab_size, dtype=config.param_dtype)
        self._rope = None

    def blocks(self) -> List[MoEBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (batch, seq) -> (logits (batch, seq, vocab) in
        ``config.dtype``, the sown aux losses (n_layers,) f32: each layer's
        ``router_aux_weight * aux``)."""
        cfg = self.config
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


@torch.no_grad()
def init_params(
    config: MoEConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Random parameters with the reference's initialisers, drawn from
    ``generator`` (default: seed 0 on ``device``): lecun-normal for the
    router, the experts and the attention kernels, normal(0.02) for
    ``embed`` and ``lm_head``, ones for the norms. JAX's PRNG bits cannot be
    reproduced, so these are not the reference's values. Returns the flat
    state dict, keyed by flax path with dots."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, params go to {device}")
    with torch.device(device):
        model = MoETransformer(config)
    for name, p in model.named_parameters():
        if name in ("embed", "lm_head"):
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith("norm"):
            p.fill_(1.0)
        else:
            _lecun_normal_(p, generator)
    return {k: v.detach() for k, v in model.state_dict().items()}


def param_shapes(config: MoEConfig) -> Dict[str, torch.Size]:
    """Every parameter's name and shape, without allocating it."""
    with torch.device("meta"):
        model = MoETransformer(config)
    return {k: v.shape for k, v in model.state_dict().items()}


def build_moe(config: MoEConfig, params: Mapping[str, torch.Tensor],
              trainable: bool = False) -> MoETransformer:
    """A :class:`MoETransformer` whose parameters ARE the given tensors (no
    copy); every parameter trains if ``trainable`` (the reference's
    full-parameter step), else all are frozen."""
    with torch.device("meta"):
        model = MoETransformer(config)
    model.load_state_dict(dict(params), strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(trainable)
    return model


def next_token_loss(
    config: MoEConfig,
    model_or_params: Union[MoETransformer, Mapping[str, torch.Tensor]],
    tokens: torch.Tensor,
) -> torch.Tensor:
    """Causal LM loss plus the router load-balance aux losses, one per
    layer, added in layer order as the reference adds its sown leaves.
    ``model_or_params`` is a :class:`MoETransformer` built for ``config`` or
    a flat state dict (run through :func:`build_moe`, frozen)."""
    model = model_or_params
    if not isinstance(model, MoETransformer):
        model = build_moe(config, model_or_params)
    elif model.config != config:
        raise ValueError("the model was built for another config")
    logits, aux = model(tokens)
    loss = nll_from_logits(logits, tokens)
    for a in aux:
        loss = loss + a
    return loss
