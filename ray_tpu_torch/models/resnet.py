"""ResNet family (v1.5 bottleneck): the port of ray_tpu/models/resnet.py.

BASELINE.json configs[1], "ResNet-50 ImageNet via DataParallelTrainer";
train it through ``ray_tpu_torch.train.examples.resnet``.

Module and parameter names follow the flax tree, so ``state_dict()`` keys
are the flax paths joined by dots: ``stage0_block0.conv2.kernel``,
``stage0_block0.bn1.scale``, ``head.kernel``. Each BatchNorm's running
statistics are buffers, ``<path>.mean`` and ``<path>.var``: the reference's
``batch_stats`` collection, one to one (:meth:`ResNet.batch_stats`).

Layout: images come in as the reference's NHWC ``(batch, H, W, 3)`` and are
permuted to an NCHW view, which is ``channels_last`` in memory (no copy);
conv kernels are OIHW tensors stored ``channels_last`` (OHWI in memory), so
cuDNN runs every convolution in its NHWC tensor-core layout.

Numerics follow flax, not ``nn.Conv2d``/``nn.BatchNorm2d``:

- a convolution casts its input and kernel to ``config.dtype`` and pads as
  XLA's ``SAME`` does, which at stride 2 over an even size is (0, 1), not
  (1, 1) (:func:`same_pads`);
- BatchNorm takes the statistics over (N, H, W) in f32 (f64 stays f64:
  flax promotes to at least f32) from the ``dtype`` input, var = max(0,
  E[x^2] - E[x]^2) (biased, for normalising and for the running var
  alike), normalises in that precision as
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` and casts to
  ``dtype``; training updates running = 0.9 running + 0.1 batch in place;
- the head is f32 (``nn.Dense(dtype=float32)``).

Sync-BN (``ResNet(config, group=)``): the reference shards the batch over a
data-parallel mesh and XLA makes BatchNorm's plain means global. Given a
collective group of the data-parallel ranks (one process each), every
BatchNorm in train mode all-reduces one f32 tensor of its local means of x
and x^2 (2C values) through ``collective.functional.all_reduce_sum``, whose
backward all-reduces the cotangent, and divides by the world size: with
equal local batches, the global batch's means, from which the variance and
the running statistics follow as at one rank (the same on every rank).
ResNet-50's 53 norms make 53 all-reduces in the forward and 53 in the
backward. Without a group the module computes what it always did.

No kernel of the port runs here: convolutions, BatchNorm and pooling are
plain XLA in the reference, and cuDNN and plain PyTorch here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .._internal.device import DeviceLike, resolve_device
from ..collective.functional import all_reduce_sum
from .llama import _lecun_normal_

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    num_classes: int = 1000
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @staticmethod
    def resnet50(**kw) -> "ResNetConfig":
        return ResNetConfig(**kw)

    @staticmethod
    def resnet101(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 23, 3), **kw)

    @staticmethod
    def resnet152(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 8, 36, 3), **kw)

    @staticmethod
    def tiny(**kw) -> "ResNetConfig":
        """Test-scale: 2 stages, 8-wide, runs on the CPU in seconds."""
        defaults = dict(stage_sizes=(1, 1), width=8, num_classes=10)
        defaults.update(kw)
        return ResNetConfig(**defaults)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis: the output has
    ceil(size / stride) positions and the extra row goes after, so a
    stride-2 3x3 pads (0, 1) over an even size and (1, 1) over an odd one."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _param(*shape, dtype) -> nn.Parameter:
    # filled by init_train_state or by loading weights
    return nn.Parameter(torch.empty(shape, dtype=dtype))


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: input and kernel cast to ``dtype``,
    ``SAME`` padding unless ``padding`` is given. ``kernel`` is OIHW."""

    def __init__(self, in_ch, out_ch, size, stride, dtype, param_dtype, padding=None):
        super().__init__()
        self.size, self.stride, self.padding, self.dtype = size, stride, padding, dtype
        self.kernel = _param(out_ch, in_ch, size, size, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding is None:
            top, bottom = same_pads(x.shape[2], self.size, self.stride)
            left, right = same_pads(x.shape[3], self.size, self.stride)
        else:
            (top, bottom), (left, right) = self.padding
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        return F.conv2d(x.to(self.dtype), self.kernel.to(self.dtype), stride=self.stride,
                        padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels of
    an NCHW tensor (see the module docstring for the arithmetic); with a
    ``group``, its statistics in train mode are the ranks' (sync-BN)."""

    def __init__(self, features, dtype, param_dtype, group=None):
        super().__init__()
        self.dtype = dtype
        self.group = group
        self.scale = _param(features, dtype=param_dtype)
        self.bias = _param(features, dtype=param_dtype)
        self.register_buffer("mean", torch.zeros(features, dtype=torch.float32))
        self.register_buffer("var", torch.ones(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        # flax promotes to at least f32 (force_float32_reductions)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            mean_sq = (xf * xf).mean(dim=(0, 2, 3))
            if self.group is not None:
                both = all_reduce_sum(torch.stack([mean, mean_sq]), self.group)
                mean, mean_sq = (both / self.group.world_size).unbind()
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.to(xf.dtype)[:, None, None]
        return y.to(self.dtype)


class Bottleneck(nn.Module):
    def __init__(self, config: ResNetConfig, in_ch: int, features: int, strides: int = 1,
                 group=None):
        super().__init__()
        cfg = config
        dt, pdt = cfg.dtype, cfg.param_dtype
        self.conv1 = Conv(in_ch, features, 1, 1, dt, pdt)
        self.bn1 = BatchNorm(features, dt, pdt, group)
        self.conv2 = Conv(features, features, 3, strides, dt, pdt)
        self.bn2 = BatchNorm(features, dt, pdt, group)
        self.conv3 = Conv(features, features * 4, 1, 1, dt, pdt)
        self.bn3 = BatchNorm(features * 4, dt, pdt, group)  # scale starts at zero
        # the reference projects where the residual's shape differs from
        # the output's: another width or a stride
        self.project = in_ch != features * 4 or strides != 1
        if self.project:
            self.proj_conv = Conv(in_ch, features * 4, 1, strides, dt, pdt)
            self.proj_bn = BatchNorm(features * 4, dt, pdt, group)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = self.proj_bn(self.proj_conv(x), train) if self.project else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Parameters are created empty: fill them with
    :func:`init_train_state` or load converted weights
    (:func:`build_resnet`). ``group``: the data-parallel ranks' collective
    group, for sync-BN (see the module docstring)."""

    def __init__(self, config: ResNetConfig, group=None):
        super().__init__()
        self.config = config
        cfg = config
        self.stem_conv = Conv(3, cfg.width, 7, 2, cfg.dtype, cfg.param_dtype,
                              padding=((3, 3), (3, 3)))
        self.stem_bn = BatchNorm(cfg.width, cfg.dtype, cfg.param_dtype, group)
        in_ch = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            features = cfg.width * 2 ** stage
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"stage{stage}_block{block}",
                                Bottleneck(cfg, in_ch, features, strides, group))
                in_ch = features * 4
        self.head = nn.Module()
        self.head.kernel = _param(in_ch, cfg.num_classes, dtype=cfg.param_dtype)
        self.head.bias = _param(cfg.num_classes, dtype=cfg.param_dtype)

    def blocks(self):
        cfg = self.config
        return [getattr(self, f"stage{s}_block{b}")
                for s, n in enumerate(cfg.stage_sizes) for b in range(n)]

    def forward(self, images: torch.Tensor, train: bool = True) -> torch.Tensor:
        """images (batch, H, W, 3) NHWC float -> logits (batch, classes) f32.
        ``train`` normalises with the batch's statistics and updates the
        running ones in place; ``train=False`` normalises with the running
        statistics."""
        x = images.to(self.config.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf, as the reference
        for block in self.blocks():
            x = block(x, train)
        x = x.mean(dim=(2, 3))  # global average pool, accumulated in f32
        return x.float() @ self.head.kernel.float() + self.head.bias.float()

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The running statistics by flax path (``<bn>.mean``/``<bn>.var``):
        the buffers themselves, which training updates in place."""
        return dict(self.named_buffers())


def _to_channels_last(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.contiguous(memory_format=torch.channels_last) if v.dim() == 4 else v
            for k, v in params.items()}


@torch.no_grad()
def init_train_state(
    config: ResNetConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(params, batch_stats)``, flat dicts keyed by flax path, with the
    reference's initialisers drawn from ``generator`` (default: seed 0 on
    ``device``): lecun-normal conv kernels (fan-in kh*kw*in) and head
    kernel, BatchNorm scale 1 (``bn3``: 0, so each block starts as the
    identity) and bias 0, running mean 0 and var 1, head bias 0. JAX's PRNG
    bits cannot be reproduced, so these are not the reference's values."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, params go to {device}")
    with torch.device(device):
        model = ResNet(config)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "head.kernel":
            _lecun_normal_(p, generator)
        elif leaf == "kernel":  # OIHW: fan-in is I*H*W
            w = torch.empty(p.shape[1:] + p.shape[:1], dtype=p.dtype, device=device)
            _lecun_normal_(w.view(-1, p.shape[0]), generator)
            p.copy_(w.permute(3, 0, 1, 2))
        elif leaf == "scale":
            p.fill_(0.0 if name.endswith("bn3.scale") else 1.0)
        else:  # BatchNorm and head biases
            p.zero_()
    params = {k: v.detach() for k, v in model.named_parameters()}
    return _to_channels_last(params), {k: v.clone() for k, v in model.batch_stats().items()}


def shapes(config: ResNetConfig) -> Tuple[Dict[str, torch.Size], Dict[str, torch.Size]]:
    """Every parameter's and every running statistic's name and shape,
    without allocating them."""
    with torch.device("meta"):
        model = ResNet(config)
    return ({k: v.shape for k, v in model.named_parameters()},
            {k: v.shape for k, v in model.named_buffers()})


def build_resnet(
    config: ResNetConfig, params: Dict[str, torch.Tensor], batch_stats: Dict[str, torch.Tensor],
    group=None,
) -> ResNet:
    """A :class:`ResNet` whose parameters and running statistics ARE the
    given tensors (no copy): training updates them in place. Parameters
    are trainable leaves. ``group``: sync-BN over its ranks."""
    with torch.device("meta"):
        model = ResNet(config, group)
    model.load_state_dict({**params, **batch_stats}, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def apply_train(
    config: ResNetConfig,
    params: Dict[str, torch.Tensor],
    batch_stats: Dict[str, torch.Tensor],
    images: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward in train mode; returns ``(logits, new_batch_stats)``. The
    given running statistics are left as they were; gradients of the logits
    flow to the tensors of ``params``."""
    new_stats = {k: v.clone() for k, v in batch_stats.items()}
    with torch.device("meta"):
        model = ResNet(config)
    logits = functional_call(model, (params, new_stats), (images,), {"train": True},
                             strict=True)
    return logits, new_stats


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long()).mean()

