"""Device objects: tensors stay on the producing worker's card.

The port of ray_tpu/experimental/device_objects.py, with torch tensors in
place of jax arrays (reference role: RDT / GPU objects,
python/ray/experimental/gpu_object_manager/gpu_object_manager.py:85 and
``@ray.method(tensor_transport="nccl")``). An actor method tagged with
``tensor_transport="device"`` keeps the tensors it returns (in any nesting
of lists, tuples and dicts, walked with ``torch.utils._pytree``) resident
in the producing process's device object store; what travels through the
object plane is a small ``DeviceObjectRef`` descriptor. A consumer actor
tagged the same way gets refs in its arguments resolved automatically: a
local hit is the very tensor (same ``data_ptr``, still on the card); a
remote fetch brings host tensors worker to worker over the RPC plane (one
device-to-host copy on the owner, raw bytes on the wire), bypassing the
raylet object store, as the reference brings host numpy. A fetched tensor
lands on the getter's own card: ``device_get(to_device=True)`` raises where
the getter has none, and an actor resolving its arguments moves them to
the card of its lease, or leaves them on the host where its lease names no
card.

Between cards the reference's NCCL point-to-point is not ported: a remote
fetch goes through both hosts' memory.

This module imports torch only inside its functions, which run in a
``tensor_transport="device"`` method's worker: a worker that never runs
one never imports torch.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, Optional, Tuple

from .. import _worker_api

_lock = threading.Lock()
_store: Dict[str, Any] = {}


class DeviceObjectRef:
    """Descriptor for a device-resident pytree. Serializable; the payload
    stays with the owner worker."""

    __slots__ = ("id", "owner_address", "spec")

    def __init__(self, id: str, owner_address: Tuple[str, int], spec: str):
        self.id = id
        self.owner_address = owner_address
        self.spec = spec  # human-readable shape/dtype summary

    def __repr__(self):
        return (
            f"DeviceObjectRef({self.id[:8]}, owner={self.owner_address}, "
            f"{self.spec})"
        )

    def __reduce__(self):
        return (DeviceObjectRef, (self.id, self.owner_address, self.spec))


def _is_tensor(x) -> bool:
    import torch

    return isinstance(x, torch.Tensor)


def _summarize(value: Any) -> str:
    from torch.utils import _pytree as pytree

    arrs = [x for x in pytree.tree_leaves(value) if _is_tensor(x)]
    n = sum(x.numel() for x in arrs)
    return f"{len(arrs)} arrays, {n} elements"


def device_put_object(value: Any) -> DeviceObjectRef:
    """Store a pytree of tensors in this worker's device object store and
    return a descriptor (reference: GPUObjectStore.put)."""
    worker = _worker_api.get_core_worker()
    obj_id = uuid.uuid4().hex
    with _lock:
        _store[obj_id] = value
    return DeviceObjectRef(obj_id, worker.address, _summarize(value))


def device_get(ref: DeviceObjectRef, *, to_device: bool = True) -> Any:
    """Resolve a DeviceObjectRef. Local hit: the stored pytree itself (zero
    copy, still on the card). Remote: fetch host tensors from the owner over
    RPC; ``to_device`` moves them to this process's current card and raises
    where it has none."""
    worker = _worker_api.get_core_worker()
    with _lock:
        if ref.id in _store:
            return _store[ref.id]
    if tuple(ref.owner_address) == tuple(worker.address):
        raise KeyError(f"device object {ref.id} was freed on its owner")
    device = None
    if to_device:
        from .._internal.device import resolve_device

        device = resolve_device(None)  # raises without a card, before the fetch
    payload = _worker_api.run_on_worker_loop(
        worker.client_pool.get(*ref.owner_address).call(
            "fetch_device_object", ref.id
        )
    )
    if payload is None:
        raise KeyError(f"device object {ref.id} not found on owner")
    if device is not None:
        from torch.utils import _pytree as pytree

        payload = pytree.tree_map(
            lambda x: x.to(device) if _is_tensor(x) else x, payload)
    return payload


def free_device_object(ref: DeviceObjectRef) -> bool:
    """Drop the owner's copy (reference: GPU object freeing on ref removal;
    explicit here — descriptors are plain values with no distributed
    refcount)."""
    worker = _worker_api.get_core_worker()
    with _lock:
        if ref.id in _store:
            del _store[ref.id]
            return True
    if tuple(ref.owner_address) == tuple(worker.address):
        return False  # we are the owner and it is already gone
    try:
        return _worker_api.run_on_worker_loop(
            worker.client_pool.get(*ref.owner_address).call(
                "free_device_object", ref.id
            )
        )
    except Exception:
        return False


# -- owner-side RPC handlers (registered by CoreWorker) ---------------------


async def handle_fetch(obj_id: str):
    """The stored pytree with every tensor copied to the host, for the wire.
    The device-to-host copies run on a thread: they can take a while for a
    large pytree and the owner's event loop must keep servicing RPCs."""
    import asyncio

    with _lock:
        value = _store.get(obj_id)
    if value is None:
        return None
    from torch.utils import _pytree as pytree

    return await asyncio.get_running_loop().run_in_executor(
        None,
        lambda: pytree.tree_map(
            lambda x: x.detach().to("cpu") if _is_tensor(x) else x, value
        ),
    )


async def handle_free(obj_id: str) -> bool:
    with _lock:
        return _store.pop(obj_id, None) is not None


# -- tensor_transport="device" method integration ---------------------------


def resolve_args(args, kwargs, to_device: bool):
    """Replace DeviceObjectRef arguments (refs nested inside lists, dicts and
    tuples included) with their pytrees (reference: the implicit resolution
    GPUObjectManager does for tensor_transport methods); a remote fetch
    lands on this process's card where ``to_device``."""
    from torch.utils import _pytree as pytree

    def r(x):
        return device_get(x, to_device=to_device) if isinstance(x, DeviceObjectRef) else x

    resolve = lambda tree: pytree.tree_map(  # noqa: E731
        r, tree, is_leaf=lambda x: isinstance(x, DeviceObjectRef)
    )
    return [resolve(a) for a in args], {
        k: resolve(v) for k, v in kwargs.items()
    }


def wrap_result(result: Any) -> Any:
    """Park a result holding tensors in the device store, returning the
    descriptor instead (None and scalars pass through)."""
    from torch.utils import _pytree as pytree

    if any(_is_tensor(x) and x.ndim > 0 for x in pytree.tree_leaves(result)):
        return device_put_object(result)
    return result
