"""Carry ray_tpu's flax weights (Llama, the MoE transformer, ResNet, ViT,
RLlib's ActorCritic, QNetwork, TwinQ, squashed Gaussian actor and
DreamerV3's networks) into the port.

The input is the reference's unboxed parameter tree
(``ray_tpu.parallel.sharding.unbox_params`` of ``init_params``) with every
leaf turned into a numpy array: nested dicts keyed by flax module names.
Each leaf's flax path joined by dots is the port's ``state_dict`` key, and
dense kernels keep the flax layout, (in, out): the port applies them as
``x @ kernel`` and does not transpose to ``nn.Linear``'s (out, in).

The reference's ``scan_layers`` tree stacks every block's parameters under
``layers/block/...`` with a leading ``n_layers`` axis. PyTorch has no scan:
the port loops over blocks (with per-block checkpointing in training), so
the stacked leaves are unstacked into ``layer_{i}.<path>`` here.

Vision models: flax conv kernels are HWIO and become the port's OIHW
(stored ``channels_last``); ResNet's ``batch_stats`` collection (``mean``,
``var`` of every BatchNorm) becomes its running-statistics buffers.

:func:`cache_from_jax` carries the reference's decode cache (its flax
``cache`` collection) into the port's :class:`~.llama.DecodeCache`, so that
both sides can start from the same K/V.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .._internal.device import DeviceLike, resolve_device
from ..rllib.dreamer import DreamerNets
from ..rllib.models import MLP_HIDDEN, ActorCritic, QNetwork, SquashedGaussianActor, TwinQ
from .llama import DecodeCache, LlamaConfig, param_shapes
from .moe import MoEConfig
from .moe import param_shapes as moe_param_shapes
from .resnet import ResNetConfig
from .resnet import shapes as resnet_shapes
from .vit import ViTConfig
from .vit import param_shapes as vit_param_shapes


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def _to_tensor(arr) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy that torch may share
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unstack(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``layers.block.<path>`` leaves of shape (n_layers, ...) become
    ``layer_{i}.<path>``; other keys pass through."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        if not key.startswith("layers."):
            out[key] = val
            continue
        if not key.startswith("layers.block."):
            raise KeyError(f"parameters the port does not know: {[key]}")
        path = key[len("layers.block."):]
        for i, layer in enumerate(np.asarray(val)):
            name = f"layer_{i}.{path}"
            if name in out or name in flat:
                raise KeyError(f"{name} is given both stacked and per layer")
            out[name] = layer
    return out


def params_from_jax(
    flax_params: Mapping[str, Any], config: LlamaConfig, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``config`` from the reference's parameter
    tree, per-layer or stacked (``scan_layers``), cast to
    ``config.param_dtype`` on ``device``. Raises on a key the port does not
    know, on a shape mismatch and on a missing parameter, all checked after
    unstacking."""
    flat = _unstack(_flatten(flax_params))
    return _load(flat, param_shapes(config), config.param_dtype, resolve_device(device))


def moe_params_from_jax(
    flax_params: Mapping[str, Any], config: MoEConfig, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``config`` from the reference's MoE
    parameter tree (``embed``, ``final_norm``, ``lm_head``;
    ``layer_{i}/attn/{wq,wk,wv,wo}/base/kernel``, ``layer_{i}/{attn_norm,
    ffn_norm}``, ``layer_{i}/moe/{router, w_gate, w_up, w_down}``), cast to
    ``config.param_dtype`` on ``device``. Raises on a key the port does not
    know, on a shape mismatch and on a missing parameter."""
    return _load(_flatten(flax_params), moe_param_shapes(config), config.param_dtype,
                 resolve_device(device))


def _load(flat, expected, dtype, device, what="parameters"):
    """``flat`` (flax path -> numpy leaf) as the port's tensors named in
    ``expected``, cast to ``dtype`` on ``device``. A 4-D leaf is a flax conv
    kernel, HWIO: it becomes OIHW, stored ``channels_last``. Raises on a
    key the port does not know, on a missing one and on a shape mismatch."""
    unknown = sorted(set(flat) - set(expected))
    if unknown:
        raise KeyError(f"{what} the port does not know: {unknown}")
    missing = sorted(set(expected) - set(flat))
    if missing:
        raise KeyError(f"{what} missing from the tree: {missing}")
    out: Dict[str, torch.Tensor] = {}
    for name, shape in expected.items():
        t = _to_tensor(flat[name])
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        if t.shape != shape:
            raise ValueError(
                f"{name}: shape {tuple(t.shape)} does not match the port's "
                f"{tuple(shape)}"
            )
        t = t.to(device=device, dtype=dtype)
        out[name] = t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t
    return out


def resnet_params_from_jax(
    flax_params: Mapping[str, Any],
    flax_batch_stats: Mapping[str, Any],
    config: ResNetConfig,
    device: DeviceLike = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The port's ``(params, batch_stats)`` for ``config`` from the
    reference's ``init_train_state`` trees: parameters in
    ``config.param_dtype``, running statistics in f32, on ``device``."""
    device = resolve_device(device)
    param_want, stat_want = resnet_shapes(config)
    params = _load(_flatten(flax_params), param_want, config.param_dtype, device)
    stats = _load(_flatten(flax_batch_stats), stat_want, torch.float32, device,
                  what="batch statistics")
    return params, stats


def vit_params_from_jax(
    flax_params: Mapping[str, Any], config: ViTConfig, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``config`` from the reference's ViT
    parameter tree (unboxed), in ``config.param_dtype`` on ``device``."""
    return _load(_flatten(flax_params), vit_param_shapes(config), config.param_dtype,
                 resolve_device(device))


def _module_params(flax_params, module, device) -> Dict[str, torch.Tensor]:
    """``module``'s state dict from a flax tree, in f32 on ``device``,
    leaves matched by name (a missing, extra or misshapen leaf raises)."""
    want = {k: v.shape for k, v in module.state_dict().items()}
    return _load(_flatten(flax_params), want, torch.float32, resolve_device(device))


def actor_critic_params_from_jax(
    flax_params: Mapping[str, Any],
    obs_dim: int,
    action_dim: int,
    discrete: bool,
    hidden: Tuple[int, ...] = MLP_HIDDEN,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """The state dict of ``rllib.models.ActorCritic(obs_dim, action_dim,
    discrete, hidden)`` from the reference's ActorCritic parameter tree
    (``Dense_0`` .. ``Dense_{h+1}``, ``log_std`` for a continuous head), in
    f32 on ``device``. Leaves are matched by name, never by order; a
    missing or extra leaf, or a shape that is not the module's, raises."""
    return _module_params(flax_params, ActorCritic(obs_dim, action_dim, discrete, hidden),
                          device)


def q_network_params_from_jax(
    flax_params: Mapping[str, Any],
    obs_dim: int,
    action_dim: int,
    hidden: Tuple[int, ...] = MLP_HIDDEN,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """The state dict of ``rllib.models.QNetwork(obs_dim, action_dim,
    hidden)`` from the reference's QNetwork tree (``Dense_0`` ..
    ``Dense_h``), in f32 on ``device``."""
    return _module_params(flax_params, QNetwork(obs_dim, action_dim, hidden), device)


def twin_q_params_from_jax(
    flax_params: Mapping[str, Any],
    obs_dim: int,
    action_dim: int,
    hidden: Tuple[int, ...] = (256, 256),
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """The state dict of ``rllib.models.TwinQ(obs_dim, action_dim, hidden)``
    from the reference's TwinQ tree (``q1_d{i}``, ``q1_out``, ``q2_d{i}``,
    ``q2_out``), in f32 on ``device``."""
    return _module_params(flax_params, TwinQ(obs_dim, action_dim, hidden), device)


def squashed_actor_params_from_jax(
    flax_params: Mapping[str, Any],
    obs_dim: int,
    action_dim: int,
    hidden: Tuple[int, ...] = (256, 256),
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """The state dict of ``rllib.models.SquashedGaussianActor(obs_dim,
    action_dim, hidden)`` from the reference's tree (``Dense_0`` ..
    ``Dense_{h+1}``: hidden, mean, log std), in f32 on ``device``."""
    return _module_params(flax_params, SquashedGaussianActor(obs_dim, action_dim, hidden),
                          device)


# flax nn.GRUCell's leaves -> the port's GRUCell (rllib/dreamer.py): the
# gates' kernels and input biases side by side in r, z, n order
_GRU_LEAVES = {
    "kernel_i": ("ir.kernel", "iz.kernel", "in.kernel"),
    "kernel_h": ("hr.kernel", "hz.kernel", "hn.kernel"),
    "bias_i": ("ir.bias", "iz.bias", "in.bias"),
    "bias_hn": ("hn.bias",),
}


def dreamer_params_from_jax(
    flax_params: Mapping[str, Any],
    config,
    obs_dim: int,
    action_dim: int,
    discrete: bool,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """The state dict of ``rllib.dreamer.DreamerNets(config, obs_dim,
    action_dim, discrete)`` from the reference's ``DreamerNets.init_params``
    tree (``wm`` with ``encoder``, ``inp_proj``, ``gru``, ``prior``,
    ``post``, ``decoder``, ``reward``, ``cont``; ``actor``, ``critic``,
    ``slow_critic``), in f32 on ``device``. The GRU's six flax gates become
    the port's fused ``kernel_i``, ``kernel_h``, ``bias_i`` and ``bias_hn``;
    every other leaf keeps its flax path. A missing, extra or misshapen
    leaf raises."""
    flat = dict(_flatten(flax_params))
    for name, leaves in _GRU_LEAVES.items():
        keys = [f"wm.gru.{leaf}" for leaf in leaves]
        present = [k for k in keys if k in flat]
        if present and len(present) < len(keys):
            raise KeyError(f"parameters missing from the tree: {sorted(set(keys) - set(present))}")
        if present:
            flat[f"wm.gru.{name}"] = np.concatenate([np.asarray(flat.pop(k)) for k in keys], -1)
    nets = DreamerNets(config, obs_dim, action_dim, discrete)
    want = {k: v.shape for k, v in nets.state_dict().items()}
    return _load(flat, want, torch.float32, resolve_device(device))


def cache_from_jax(
    flax_cache: Mapping[str, Any], config: LlamaConfig, device: DeviceLike = None
) -> DecodeCache:
    """The port's decode cache from the reference's decode-cache collection
    (``layer_{i}/attn/{cached_key,cached_value,cache_index}``, leaves as
    numpy): K/V cast to ``config.dtype``, the index to int32, on ``device``.
    Layers are found by name, never by leaf order (flax flattens
    ``layer_10`` before ``layer_2``). Raises on a missing or unknown layer
    and on a shape that is not the config's."""
    device = resolve_device(device)
    names = [f"layer_{i}" for i in range(config.n_layers)]
    if sorted(flax_cache) != sorted(names):
        raise KeyError(
            f"cache layers {sorted(flax_cache)} are not the config's {names}"
        )
    parts = {"cached_key": [], "cached_value": [], "cache_index": []}
    for name in names:
        attn = flax_cache[name]["attn"]
        for leaf, out in parts.items():
            out.append(_to_tensor(attn[leaf]))
    key, value, index = (torch.stack(parts[leaf]) for leaf in parts)
    rows = key.shape[1]
    want = (config.n_layers, rows, config.n_kv_heads, config.max_seq_len,
            config.head_dim)
    if key.shape != want or value.shape != want or index.shape != want[:2]:
        raise ValueError(
            f"cache K/V {tuple(key.shape)}, {tuple(value.shape)} and index "
            f"{tuple(index.shape)}: want K/V {want} and index {want[:2]}"
        )
    return DecodeCache(
        key.to(device=device, dtype=config.dtype),
        value.to(device=device, dtype=config.dtype),
        index.to(device=device, dtype=torch.int32),
    )
