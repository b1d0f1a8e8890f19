"""Carry ray_tpu's flax Llama weights into the port.

The input is the reference's unboxed parameter tree
(``ray_tpu.parallel.sharding.unbox_params`` of ``init_params``) with every
leaf turned into a numpy array: nested dicts keyed by flax module names.
Each leaf's flax path joined by dots is the port's ``state_dict`` key, and
dense kernels keep the flax layout, (in, out): the port applies them as
``x @ kernel`` and does not transpose to ``nn.Linear``'s (out, in).
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


def params_from_jax(
    flax_params: Mapping[str, Any], config: LlamaConfig, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``config`` from the reference's parameter
    tree, cast to ``config.param_dtype`` on ``device``. Raises on a key the
    port does not know, on a shape mismatch and on a missing parameter."""
    device = resolve_device(device)
    flat = _flatten(flax_params)
    if any(k == "layers" or k.startswith("layers.") for k in flat):
        raise NotImplementedError(
            "the stacked scan_layers layout (layers/block/...) comes with the "
            "port's training slice"
        )
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
