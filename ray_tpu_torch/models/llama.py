"""LLaMA-family transformer: the port of ray_tpu/models/llama.py.

Module and parameter names follow the flax tree, so ``state_dict()`` keys
are the flax paths joined by dots (``layer_0.attn.wq.base.kernel``,
``embed``, ...) and converted weights load one to one (models/convert.py).
Dense kernels are stored as flax stores them, (in, out), and applied as
``x @ kernel``; ``embed`` (vocab, dim) and ``lm_head`` (dim, vocab) are
separate weights.

Numerics follow the reference: a dense layer casts its input and its kernel
to ``config.dtype`` (flax ``DenseGeneral(dtype=bf16, param_dtype=f32)``),
norm weights are cast to the activation dtype before the norm, RoPE tables
are f32, and the logits come out in ``config.dtype``.

``Llama.forward(tokens)`` is the full-sequence forward (flash attention,
the reference's ``decode=False``). ``Llama.forward(tokens, cache)`` is the
reference's ``decode=True`` path: attention over a dense per-layer KV cache
(see :class:`LayerCache`) as plain f32 einsum, as in the reference.

Training: with ``config.remat`` and autograd recording, each block of the
full-sequence forward runs under ``torch.utils.checkpoint`` and is
recomputed in the backward, the reference's save-nothing ``nn.remat``. The
reference's ``scan_layers`` (the layers stacked under ``lax.scan``) has no
counterpart field: PyTorch has no scan, and the loop over blocks with
per-block checkpointing takes its place (models/convert.py unstacks the
stacked weights).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._internal.device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.rmsnorm import rmsnorm
from ..ops.rope import apply_rope, rope_table


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


def new_cache(config: LlamaConfig, batch: int, device) -> List[LayerCache]:
    """An empty cache for ``batch`` rows: one :class:`LayerCache` per layer."""
    shape = (batch, config.n_kv_heads, config.max_seq_len, config.head_dim)
    return [
        LayerCache(
            torch.zeros(shape, dtype=config.dtype, device=device),
            torch.zeros(shape, dtype=config.dtype, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device),
        )
        for _ in range(config.n_layers)
    ]


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
    The multi-tenant slot-bank gather comes with the port's LoRA slice."""

    def __init__(self, in_features, out_features, rank, alpha, param_dtype, dtype):
        super().__init__()
        self.base = Dense(in_features, out_features, param_dtype, dtype)
        self.rank = rank
        self.scale = alpha / rank if rank > 0 else 0.0
        if rank > 0:
            self.lora_a = _param(in_features, rank, dtype=param_dtype)
            self.lora_b = _param(rank, out_features, dtype=param_dtype)

    def forward(self, x, adapter=None, adapter_slots=None):
        if adapter is not None or adapter_slots is not None:
            raise NotImplementedError(
                "multi-tenant adapter banks come with the port's LoRA slice"
            )
        y = self.base(x)
        if self.rank > 0:
            y = y + (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype) * self.scale
        return y


class Attention(nn.Module):
    def __init__(self, config: LlamaConfig, mesh=None):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(
                "ring attention over a mesh comes with the port's sequence-"
                "parallel slice"
            )
        self.config = config
        cfg = config
        h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

        def proj(n_in, n_out):
            return LoRADense(
                n_in, n_out, cfg.lora_rank, cfg.lora_alpha, cfg.param_dtype, cfg.dtype
            )

        self.wq = proj(cfg.dim, h * d)
        self.wk = proj(cfg.dim, hk * d)
        self.wv = proj(cfg.dim, hk * d)
        self.wo = proj(h * d, cfg.dim)

    def forward(self, x, cos, sin, cache: Optional[LayerCache] = None):
        cfg = self.config
        b, s, _ = x.shape
        h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = self.wq(x).reshape(b, s, h, d).transpose(1, 2)
        k = self.wk(x).reshape(b, s, hk, d).transpose(1, 2)
        v = self.wv(x).reshape(b, s, hk, d).transpose(1, 2)
        if cache is not None:
            out = self._decode_attention(q, k, v, cos, sin, cache)
        else:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            out = flash_attention(q, k, v, causal=True)
        out = out.transpose(1, 2).reshape(b, s, h * d)
        return self.wo(out)

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
        k_all = cache.cached_key.repeat_interleave(h // cfg.n_kv_heads, dim=1)
        v_all = cache.cached_value.repeat_interleave(h // cfg.n_kv_heads, dim=1)
        # row r's query i sits at absolute position idx[r]+i; key j is
        # visible iff j <= idx[r]+i (and thus has been written)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_all.float()) / math.sqrt(d)
        q_pos = idx.long()[:, None, None] + torch.arange(s, device=q.device)[None, :, None]
        k_pos = torch.arange(cfg.max_seq_len, device=q.device)[None, None, :]
        scores = scores.masked_fill(~(k_pos <= q_pos)[:, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v_all.float()).to(cfg.dtype)


class MLP(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        cfg = config
        self.w_gate = Dense(cfg.dim, cfg.intermediate, cfg.param_dtype, cfg.dtype)
        self.w_up = Dense(cfg.dim, cfg.intermediate, cfg.param_dtype, cfg.dtype)
        self.w_down = Dense(cfg.intermediate, cfg.dim, cfg.param_dtype, cfg.dtype)

    def forward(self, x):
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, config: LlamaConfig, mesh=None):
        super().__init__()
        self.config = config
        self.attn_norm = _param(config.dim, dtype=config.param_dtype)
        self.attn = Attention(config, mesh)
        self.mlp_norm = _param(config.dim, dtype=config.param_dtype)
        self.mlp = MLP(config)

    def forward(self, x, cos, sin, cache: Optional[LayerCache] = None):
        eps = self.config.norm_eps
        h = x + self.attn(rmsnorm(x, self.attn_norm.to(x.dtype), eps), cos, sin, cache)
        return h + self.mlp(rmsnorm(h, self.mlp_norm.to(h.dtype), eps))


class Llama(nn.Module):
    """Parameters are created empty: fill them with :func:`init_params` or
    load converted weights (:func:`build_llama`)."""

    def __init__(self, config: LlamaConfig, mesh=None):
        super().__init__()
        self.config = config
        self.embed = _param(config.vocab_size, config.dim, dtype=config.param_dtype)
        for i in range(config.n_layers):
            self.add_module(f"layer_{i}", Block(config, mesh))
        self.final_norm = _param(config.dim, dtype=config.param_dtype)
        self.lm_head = _param(config.dim, config.vocab_size, dtype=config.param_dtype)
        self._rope = None

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
        this is the decode-mode call, which updates the cache in place."""
        if adapters is not None or adapter_slots is not None:
            raise NotImplementedError(
                "multi-tenant adapter banks come with the port's LoRA slice"
            )
        cfg = self.config
        x = self.embed[tokens].to(cfg.dtype)
        cos, sin = self._rope_table(x.device)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks()):
            if remat:
                # use_reentrant=False: with a frozen base the block's input
                # needs no grad, and the reentrant form would then drop the
                # adapters' gradients
                x = checkpoint(block, x, cos, sin, use_reentrant=False)
            else:
                x = block(x, cos, sin, None if cache is None else cache[i])
        x = rmsnorm(x, self.final_norm.to(x.dtype), cfg.norm_eps)
        return x @ self.lm_head.to(x.dtype)


def _lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal on [-2, 2] scaled to variance
    1/fan_in, fan_in being the leading (input) axis of an (in, out) kernel."""
    fan_in = t.shape[0]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.copy_(w * std)


@torch.no_grad()
def init_params(
    config: LlamaConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Random parameters with the reference's initialisers, drawn from
    ``generator`` (default: seed 0 on ``device``): lecun-normal for dense
    kernels and ``lora_a``, normal(0.02) for ``embed`` and ``lm_head``, ones
    for the norms, zeros for ``lora_b``. JAX's PRNG bits cannot be
    reproduced, so these are not the reference's values. Returns the flat
    state dict, keyed by flax path with dots."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, params go to {device}")
    with torch.device(device):
        model = Llama(config)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in ("embed", "lm_head"):
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf in ("attn_norm", "mlp_norm", "final_norm"):
            p.fill_(1.0)
        elif leaf == "lora_b":
            p.zero_()
        else:  # dense kernels and lora_a
            _lecun_normal_(p, generator)
    return {k: v.detach() for k, v in model.state_dict().items()}


def param_shapes(config: LlamaConfig) -> Dict[str, torch.Size]:
    """Every parameter's name and shape, without allocating it."""
    with torch.device("meta"):
        model = Llama(config)
    return {k: v.shape for k, v in model.state_dict().items()}


def build_llama(config: LlamaConfig, params: Dict[str, torch.Tensor], mesh=None) -> Llama:
    """A :class:`Llama` whose parameters ARE the given tensors (no copy), so
    several modules can share one set of weights."""
    with torch.device("meta"):
        model = Llama(config, mesh)
    model.load_state_dict(params, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def nll_from_logits(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token NLL from full-sequence logits: pairs logits[:, :-1] with
    tokens[:, 1:]; nll = logsumexp(logits) - logits[target], in f32."""
    logits = logits[:, :-1]
    targets = tokens[:, 1:]
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0].float()
    return (lse - tgt).mean()


def next_token_loss(
    config: LlamaConfig, model_or_params: Union[Llama, Mapping[str, torch.Tensor]],
    tokens: torch.Tensor,
) -> torch.Tensor:
    """Causal LM loss of the full-sequence forward (see
    :func:`nll_from_logits`). ``model_or_params`` is a :class:`Llama` built
    for ``config``, whose parameters that require grad receive gradients
    from ``loss.backward()``, or a flat state dict, which is run through
    :func:`build_llama` (every parameter frozen: a loss to read, not to
    differentiate)."""
    model = model_or_params
    if not isinstance(model, Llama):
        model = build_llama(config, dict(model_or_params))
    elif model.config != config:
        raise ValueError("the model was built for another config")
    return nll_from_logits(model(tokens), tokens)
