"""Vision Transformer: the port of ray_tpu/models/vit.py.

Module and parameter names follow the flax tree (``patch_embed.kernel``,
``cls_token``, ``pos_embed``, ``layer_{i}.wq.kernel``, ``ln_final.scale``,
``head``), so converted weights load one to one (models/convert.py). Dense
kernels are stored as flax stores them, (in, out); the patch embedding's
conv kernel is OIHW.

Numerics follow flax: a dense layer or the patch conv casts its input,
kernel and bias to ``config.dtype`` and adds the bias after the product;
LayerNorm takes its statistics in f32 with eps 1e-6 and casts the result to
``config.dtype``; GELU is the tanh approximation (flax ``nn.gelu``); the
head is ``cls_out @ head.to(dtype)``, then f32.

Encoder attention is bidirectional and runs through
``ops.flash_attention.flash_attention(..., causal=False)``: the forward
kernel (K2), and in the backward the dQ (K3) and dK/dV (K4) kernels. The
CUDA kernels take head_dim 32, 64 or 128; ViT-B/16 and ViT-L/16 have 64,
``ViTConfig.tiny()`` 16, which runs only on the CPU (the plain versions).

``config.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``). Dropout draws its masks from an explicit
``torch.Generator``, before the checkpointed block, so the recompute reuses
them as the reference's ``nn.remat`` reuses its key.

Over a mesh (``ViT(config, mesh)``, bound with its sub-groups by
``Mesh.form_groups`` or ``train.collective.gang_mesh``) each rank is one
process holding its block of every parameter by the reference's rule table
(``VIT_LOGICAL_AXES``: kernels' ``embed`` over ``fsdp``, their heads, MLP
units and classes over ``tp``; biases and LayerNorms replicated) and its
shard of the global batch (the data axes; replicated over ``tp``). Each
parameter's ``fsdp`` dimension is gathered where it is read
(parallel/fsdp.py), :func:`~ray_tpu_torch.parallel.sharding.constrain`
stands where the reference calls it, and the blocks are Megatron's: f
(``copy_to_group``) before wq/wk/wv and fc1, which hold the rank's columns
and add the rank's slice of their replicated biases, g (``sum_of_ranks``)
after wo and fc2, which hold the rank's rows and add their biases once; the
head's classes are gathered over ``tp`` with their gradient sliced back
(``gather_from_group``). :func:`classification_loss` returns the global
batch's mean on every rank, each rank's backward its own share;
``model.fsdp.sync_gradients`` completes the gradients. Dropout under a mesh
needs generators seeded alike on the ranks of a ``tp`` group (their rows
are one). ``sp > 1`` raises (ROADMAP item A.12: the 197 patches do not split
evenly, and the reference leaves that to GSPMD's padding), as ``pp > 1``
does (A.5.4).
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
from ..collective.functional import copy_to_group, gather_from_group, sum_of_ranks
from ..ops.flash_attention import flash_attention
from ..parallel.mesh import BATCH_AXES, check_model_mesh

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def base(**kw) -> "ViTConfig":  # ViT-B/16
        return ViTConfig(**kw)

    @staticmethod
    def large(**kw) -> "ViTConfig":  # ViT-L/16
        return ViTConfig(dim=1024, n_layers=24, n_heads=16, mlp_dim=4096, **kw)

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        defaults = dict(
            image_size=32, patch_size=8, num_classes=10, dim=64,
            n_layers=2, n_heads=4, mlp_dim=128,
        )
        defaults.update(kw)
        return ViTConfig(**defaults)


def _param(*shape, dtype) -> nn.Parameter:
    # filled by init_params or by loading weights
    return nn.Parameter(torch.empty(shape, dtype=dtype))


class Dense(nn.Module):
    """flax ``DenseGeneral`` with bias: ``x @ kernel + bias``, all three
    cast to ``dtype``; ``kernel`` is (in, out)."""

    def __init__(self, in_features: int, out_features: int, param_dtype, dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(in_features, out_features, dtype=param_dtype)
        self.bias = _param(out_features, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)``: eps 1e-6, statistics and the
    affine map in f32 (f64 for f64 inputs), the result cast to ``dtype``."""

    def __init__(self, features: int, param_dtype, dtype):
        super().__init__()
        self.dtype = dtype
        self.scale = _param(features, dtype=param_dtype)
        self.bias = _param(features, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(x.dtype, torch.float32)  # at least f32, as flax
        y = F.layer_norm(x.to(acc), (x.shape[-1],), self.scale.to(acc), self.bias.to(acc), LN_EPS)
        return y.to(self.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


class EncoderBlock(nn.Module):
    """With ``tp_group``: the rank's n_heads / tp heads and mlp_dim / tp
    MLP units (column blocks of wq/wk/wv/fc1 with whole biases, row blocks
    of wo/fc2) between Megatron's f and g."""

    def __init__(self, config: ViTConfig, tp_group=None):
        super().__init__()
        self.config = config
        self.tp_group = tp_group
        cfg = config
        tp = 1 if tp_group is None else tp_group.world_size
        if cfg.n_heads % tp or cfg.mlp_dim % tp:
            raise ValueError(f"{cfg.n_heads} heads and {cfg.mlp_dim} MLP units do not split "
                             f"over tp={tp}")
        hd, dt, pdt = cfg.n_heads * cfg.head_dim, cfg.dtype, cfg.param_dtype
        self.ln1 = LayerNorm(cfg.dim, pdt, dt)
        self.wq = Dense(cfg.dim, hd // tp, pdt, dt)
        self.wk = Dense(cfg.dim, hd // tp, pdt, dt)
        self.wv = Dense(cfg.dim, hd // tp, pdt, dt)
        self.wo = Dense(hd // tp, cfg.dim, pdt, dt)
        self.ln2 = LayerNorm(cfg.dim, pdt, dt)
        self.fc1 = Dense(cfg.dim, cfg.mlp_dim // tp, pdt, dt)
        self.fc2 = Dense(cfg.mlp_dim // tp, cfg.dim, pdt, dt)
        if tp > 1:  # the column blocks' biases stay whole (replicated)
            for dense, width in ((self.wq, hd), (self.wk, hd), (self.wv, hd),
                                 (self.fc1, cfg.mlp_dim)):
                dense.bias = _param(width, dtype=pdt)

    def _columns(self, dense: Dense, x: torch.Tensor) -> torch.Tensor:
        """A column block: the rank's output columns, plus its slice of the
        whole bias (through f, so each rank's bias gradient is whole)."""
        tp = self.tp_group
        if tp is None:
            return dense(x)
        n = dense.kernel.shape[1]
        bias = copy_to_group(dense.bias, tp).narrow(0, tp.rank * n, n)
        return x.to(dense.dtype) @ dense.kernel.to(dense.dtype) + bias.to(dense.dtype)

    def _rows(self, dense: Dense, x: torch.Tensor) -> torch.Tensor:
        """A row block: the ranks' partial products summed (g), then the
        bias once."""
        tp = self.tp_group
        if tp is None:
            return dense(x)
        part = x.to(dense.dtype) @ dense.kernel.to(dense.dtype)
        return sum_of_ranks(part, tp) + dense.bias.to(dense.dtype)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: this block's dropout mask (b, s, dim), or None for
        none."""
        cfg = self.config
        b, s, _ = x.shape
        d = cfg.head_dim
        tp = self.tp_group
        y = self.ln1(x)
        if tp is not None:
            y = copy_to_group(y, tp)
        q = self._columns(self.wq, y).reshape(b, s, -1, d).transpose(1, 2)
        k = self._columns(self.wk, y).reshape(b, s, -1, d).transpose(1, 2)
        v = self._columns(self.wv, y).reshape(b, s, -1, d).transpose(1, 2)
        # bidirectional attention: every patch sees every patch
        attn = flash_attention(q, k, v, causal=False)
        x = x + self._rows(self.wo, attn.transpose(1, 2).reshape(b, s, -1))
        y = self.ln2(x)
        if tp is not None:
            y = copy_to_group(y, tp)
        y = self._rows(self.fc2, gelu(self._columns(self.fc1, y)))
        if keep is not None:  # flax nn.Dropout: kept entries scaled by 1 / (1 - rate)
            y = torch.where(keep, y / (1.0 - cfg.dropout), 0.0)
        return x + y


class ViT(nn.Module):
    """Parameters are created empty: fill them with :func:`init_params` or
    load converted weights (:func:`build_vit`). With a ``mesh`` they have
    the shapes of this rank's blocks (see the module docstring)."""

    def __init__(self, config: ViTConfig, mesh=None):
        super().__init__()
        tp_group = None
        if mesh is not None:
            check_model_mesh(mesh, "ViT over a mesh")
            tp_group = mesh.group("tp")
            if config.num_classes % mesh.shape["tp"]:
                raise ValueError(f"{config.num_classes} classes do not split over "
                                 f"tp={mesh.shape['tp']}")
        self.config = config
        self.mesh = mesh
        cfg = config
        tp = 1 if mesh is None else mesh.shape["tp"]
        p, pdt = cfg.patch_size, cfg.param_dtype
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = _param(cfg.dim, 3, p, p, dtype=pdt)  # OIHW
        self.patch_embed.bias = _param(cfg.dim, dtype=pdt)
        self.cls_token = _param(1, 1, cfg.dim, dtype=pdt)
        self.pos_embed = _param(1, cfg.num_patches + 1, cfg.dim, dtype=pdt)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderBlock(cfg, tp_group))
        self.ln_final = LayerNorm(cfg.dim, pdt, cfg.dtype)
        self.head = _param(cfg.dim, cfg.num_classes // tp, dtype=pdt)
        #: the rank's FSDP layout over the mesh (None without one)
        self.fsdp = None
        if mesh is not None:
            from ..parallel.fsdp import FSDP
            from ..parallel.sharding import vit_logical_axes

            FSDP.for_model(mesh, param_shapes(config), vit_logical_axes).localize(self)

    def blocks(self) -> List[EncoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    def forward(
        self,
        images: torch.Tensor,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """images (batch, H, W, C) float -> (batch, num_classes) f32 logits.
        With ``deterministic=False`` and ``config.dropout > 0`` each block
        drops entries of its MLP output with masks drawn from
        ``generator``, which is then required (the reference requires a
        dropout rng)."""
        cfg = self.config
        b, dt = images.shape[0], cfg.dtype
        w = self._weight
        # patchify as one strided conv, NHWC in -> (b, dim, gh, gw)
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), w("patch_embed.kernel").to(dt),
                     stride=cfg.patch_size)
        x = x + self.patch_embed.bias.to(dt)[:, None, None]
        x = x.flatten(2).transpose(1, 2)  # (b, patches, dim), row-major patches
        cls = w("cls_token").to(dt).expand(b, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1) + w("pos_embed").to(dt)
        if self.mesh is not None:
            from ..parallel.sharding import constrain

            # the reference's hint: batch over the data axes, patches over sp
            x = constrain(x, self.mesh, "batch", "seq", None)
        drop = not deterministic and cfg.dropout > 0
        if drop and generator is None:
            raise ValueError("dropout with deterministic=False needs a torch.Generator")
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks()):
            keep = None
            if drop:
                # drawn outside the checkpoint: the recompute reuses it
                keep = torch.rand(x.shape, generator=generator, device=x.device) >= cfg.dropout
            run, args = (block, (x, keep)) if self.fsdp is None else (
                self.fsdp.call_block, (block, f"layer_{i}.", x, keep))
            x = checkpoint(run, *args, use_reentrant=False) if remat else run(*args)
        cls_out = self.ln_final(x)[:, 0]  # classification token
        tp = None if self.mesh is None else self.mesh.group("tp")
        if tp is None:
            return (cls_out @ w("head").to(cls_out.dtype)).float()
        logits = copy_to_group(cls_out, tp) @ w("head").to(cls_out.dtype)
        return gather_from_group(logits, tp, dim=-1).float()

    def _weight(self, name: str) -> torch.Tensor:
        """The parameter ``name`` as the forward reads it: over a mesh, the
        rank's block gathered over ``fsdp``."""
        p = self.get_parameter(name)
        return p if self.fsdp is None else self.fsdp.gather(name, p)


def _xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int, generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    t.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def init_params(
    config: ViTConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Random parameters with the reference's initialisers, drawn from
    ``generator`` (default: seed 0 on ``device``): xavier-uniform dense
    kernels and patch kernel (its fans are in*p*p and dim*p*p), zero biases,
    LayerNorm scale 1, ``pos_embed`` normal(0.02), ``cls_token`` and
    ``head`` 0 (so every logit is 0 at init). JAX's PRNG bits cannot be
    reproduced, so these are not the reference's values. Returns the flat
    state dict, keyed by flax path with dots."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, params go to {device}")
    with torch.device(device):
        model = ViT(config)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "patch_embed.kernel":
            rf = p.shape[2] * p.shape[3]
            _xavier_uniform_(p, p.shape[1] * rf, p.shape[0] * rf, generator)
        elif leaf == "kernel":
            _xavier_uniform_(p, p.shape[0], p.shape[1], generator)
        elif name == "pos_embed":
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "scale":
            p.fill_(1.0)
        else:  # biases, cls_token, head
            p.zero_()
    return {k: v.detach() for k, v in model.state_dict().items()}


def param_shapes(config: ViTConfig) -> Dict[str, torch.Size]:
    """Every parameter's name and shape, without allocating it."""
    with torch.device("meta"):
        model = ViT(config)
    return {k: v.shape for k, v in model.state_dict().items()}


def build_vit(config: ViTConfig, params: Dict[str, torch.Tensor], mesh=None) -> ViT:
    """A :class:`ViT` whose parameters ARE the given tensors (no copy), as
    trainable leaves. With a ``mesh``, each of ``params`` is this rank's
    block, or the whole tensor, whose block is then taken (a copy)."""
    with torch.device("meta"):
        model = ViT(config, mesh)
    if mesh is not None:
        params = model.fsdp.blocks_of(params, param_shapes(config))
    model.load_state_dict(params, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def classification_loss(
    config: ViTConfig,
    mesh,
    model_or_params: Union[ViT, Mapping[str, torch.Tensor]],
    images: torch.Tensor,
    labels: torch.Tensor,
) -> torch.Tensor:
    """Softmax cross-entropy via the logsumexp form, deterministic (no
    dropout), as the reference's. ``model_or_params`` is a :class:`ViT`
    built for ``config`` (over ``mesh``) or a flat state dict (run through
    :func:`build_vit` with ``mesh``). Over a mesh, ``images`` and ``labels``
    are this rank's rows of the global batch, and every rank returns the
    global batch's mean (its backward the rank's own share: see the module
    docstring)."""
    model = model_or_params
    if not isinstance(model, ViT):
        model = build_vit(config, dict(model_or_params), mesh)
    elif model.config != config:
        raise ValueError("the model was built for another config")
    elif model.mesh is not mesh:
        raise ValueError("the model was built over another mesh")
    logits = model(images)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    if mesh is None:
        return (lse - tgt).mean()
    loss = (lse - tgt).sum() / (logits.shape[0] * mesh.axes_size(BATCH_AXES))
    data = mesh.group(BATCH_AXES)
    return loss if data is None else sum_of_ranks(loss.reshape(1), data)[0]
