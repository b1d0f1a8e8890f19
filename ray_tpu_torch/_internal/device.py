"""Device resolution: the port's counterpart of ray_tpu._internal.platform.

``ray_tpu`` asks "is the JAX backend a TPU?" to choose between a compiled
Pallas kernel and interpret mode. The port asks no such question: an entry
point runs on the card unless its caller names another device, and a
missing card is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]

#: the mesh tag of a serving metric and stats() dict of one device; under a
#: tensor-parallel plan the engines and the KV manager tag with
#: ``plan.describe()`` (``"tp=2"``), as the reference does
MESH_TAG = "tp=1"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raises if CUDA is asked for and absent. A
    CUDA device comes back with its index (``cuda`` -> ``cuda:<current>``),
    so that it compares equal to the ``.device`` of tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
