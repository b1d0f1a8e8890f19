"""Carry ray_tpu's flax Llama weights into the port.

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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .._internal.device import DeviceLike, resolve_device
from .llama import LlamaConfig, param_shapes


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
    device = resolve_device(device)
    flat = _unstack(_flatten(flax_params))
    expected = param_shapes(config)
    unknown = sorted(set(flat) - set(expected))
    if unknown:
        raise KeyError(f"parameters the port does not know: {unknown}")
    missing = sorted(set(expected) - set(flat))
    if missing:
        raise KeyError(f"parameters missing from the tree: {missing}")
    out: Dict[str, torch.Tensor] = {}
    for name, shape in expected.items():
        t = _to_tensor(flat[name])
        if t.shape != shape:
            raise ValueError(
                f"{name}: shape {tuple(t.shape)} does not match the port's "
                f"{tuple(shape)}"
            )
        out[name] = t.to(device=device, dtype=config.param_dtype)
    return out
