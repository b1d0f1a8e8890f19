"""Accelerator managers: the port of ray_tpu/_internal/accelerators.py.

The plugin layer is the reference's: the ``AcceleratorManager`` ABC, its
registry, and ``detect_node_accelerators``, which folds every registered
plugin into the node's resources and labels at ``init()``, each plugin
fault-isolated. The node's accelerator is the NVIDIA card, behind
``GpuAcceleratorManager``: the card is the node's ``GPU`` resource, whose
instances are its device ids.

Two things differ from the reference.

- **Detection finds a card the container hides.** ``CUDA_VISIBLE_DEVICES``
  wins when set, as in the reference. Otherwise the reference counts
  ``/proc/driver/nvidia/gpus/*``, which a container may not show; where
  that gives 0, the port asks ``torch.cuda.device_count()`` (torch is
  imported only here, inside detection) and then ``nvidia-smi -L``. So a
  card that is present is never reported as 0, and a count always comes
  from detection, never from the caller alone.
- **A leased worker is bound to its lease's card** (:func:`cuda_index`;
  the core worker calls ``torch.cuda.set_device`` with it). The reference
  drops the lease's device ids.

The reference's ``TpuAcceleratorManager``, its pod-type tables and
``util/tpu.py`` have no counterpart: there is no TPU on this card's host.
"""

from __future__ import annotations

import abc
import glob
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple, Type

#: where the last GPU count came from: "CUDA_VISIBLE_DEVICES", "/proc",
#: "torch", "nvidia-smi" or "" (no card); printed by the chip script
last_gpu_source = ""


class AcceleratorManager(abc.ABC):
    """Plugin interface for one accelerator family (reference:
    _private/accelerators/accelerator.py:18).

    Register implementations with ``register_accelerator_manager``:
    ``detect_node_accelerators()`` folds every registered plugin into the
    node's resources/labels at startup, so heterogeneous clusters (CPU-only
    nodes next to GPU nodes) fall out of per-node detection rather than
    hardcoding."""

    @staticmethod
    @abc.abstractmethod
    def get_resource_name() -> str:
        """e.g. "GPU"."""

    @staticmethod
    @abc.abstractmethod
    def get_current_node_num_accelerators() -> int:
        """Units detected on this node (0 = plugin contributes nothing)."""

    @staticmethod
    def get_current_node_labels() -> Dict[str, str]:
        return {}

    @staticmethod
    def get_current_node_additional_resources() -> Dict[str, float]:
        """Extra resources beyond <name>: count."""
        return {}

    @staticmethod
    def get_visibility_env(instance_ids) -> Dict[str, str]:
        """Env vars restricting a worker process to specific units."""
        return {}


_ACCELERATOR_MANAGERS: List[Type[AcceleratorManager]] = []


def register_accelerator_manager(cls: Type[AcceleratorManager]) -> Type:
    if cls not in _ACCELERATOR_MANAGERS:
        _ACCELERATOR_MANAGERS.append(cls)
    return cls


def all_accelerator_managers() -> List[Type[AcceleratorManager]]:
    return list(_ACCELERATOR_MANAGERS)


def detect_node_accelerators(
    exclude: Optional[set] = None,
) -> Tuple[Dict[str, float], Dict[str, str]]:
    """Fold every registered plugin into (resources, labels) for this node.
    ``exclude`` suppresses plugins by resource name entirely (count,
    additional resources and labels): ``init(num_gpus=0)`` opts out of
    being a GPU node."""
    resources: Dict[str, float] = {}
    labels: Dict[str, str] = {}
    for manager in _ACCELERATOR_MANAGERS:
        name = manager.get_resource_name()
        if exclude and name in exclude:
            continue
        # the whole plugin is fault-isolated: a misbehaving third-party
        # detection (count, extras, OR labels) must not abort init()
        try:
            count = manager.get_current_node_num_accelerators()
            if count <= 0:
                continue
            # stage all three contributions; merge only once the whole
            # plugin succeeded
            extra = dict(manager.get_current_node_additional_resources())
            plugin_labels = dict(manager.get_current_node_labels())
        except Exception:
            continue
        resources[name] = float(count)
        resources.update(extra)
        labels.update(plugin_labels)
    return resources, labels


def _visible_tokens(mask: str) -> List[str]:
    # "-1" is the standard disable-GPUs convention; count only non-negative
    # device tokens
    return [d.strip() for d in mask.split(",") if d.strip() and not d.strip().startswith("-")]


def _torch_device_count() -> int:
    try:
        import torch
    except ImportError:
        return 0
    return int(torch.cuda.device_count())


def _nvidia_smi_count() -> int:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return 0
    try:
        out = subprocess.run([smi, "-L"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


@register_accelerator_manager
class GpuAcceleratorManager(AcceleratorManager):
    """The NVIDIA card (reference: nvidia_gpu.py behind the same ABC)."""

    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        global last_gpu_source
        env = os.environ.get("CUDA_VISIBLE_DEVICES")
        if env is not None:
            last_gpu_source = "CUDA_VISIBLE_DEVICES"
            return len(_visible_tokens(env))
        for source, count in (("/proc", lambda: len(glob.glob("/proc/driver/nvidia/gpus/*"))),
                              ("torch", _torch_device_count),
                              ("nvidia-smi", _nvidia_smi_count)):
            n = count()
            if n > 0:
                last_gpu_source = source
                return n
        last_gpu_source = ""
        return 0

    @staticmethod
    def get_visibility_env(instance_ids) -> Dict[str, str]:
        # logical instance ids remap through a pre-existing parent mask:
        # with CUDA_VISIBLE_DEVICES="2,3" the node's logical GPUs 0,1 ARE
        # physical 2,3
        return {"CUDA_VISIBLE_DEVICES": ",".join(physical_gpu_ids(instance_ids))}


def physical_gpu_ids(instance_ids: Sequence[int]) -> List[str]:
    """The physical device ids of the node's logical GPU instances: through
    the parent ``CUDA_VISIBLE_DEVICES`` mask where one is set (an id past
    the mask is dropped rather than widen the mask to a device the parent
    excluded), else the ids themselves."""
    parent = os.environ.get("CUDA_VISIBLE_DEVICES")
    if parent:
        physical = _visible_tokens(parent)
        return [physical[int(i)] for i in instance_ids if int(i) < len(physical)]
    return [str(i) for i in instance_ids]


def cuda_index(instance_id: int) -> int:
    """The ``torch.cuda`` device index of the node's logical GPU
    ``instance_id`` in a worker process.

    A worker inherits its node's environment, parent mask included, and
    CUDA numbers the devices of a mask by their position in it, as
    detection counted them: so logical id i is ``cuda:i``, the physical
    device ``physical_gpu_ids([i])[0]``. Raises for an id past the mask."""
    parent = os.environ.get("CUDA_VISIBLE_DEVICES")
    i = int(instance_id)
    if parent is not None and i >= len(_visible_tokens(parent)):
        raise ValueError(
            f"GPU instance {i} is past this process's CUDA_VISIBLE_DEVICES={parent!r}")
    return i
