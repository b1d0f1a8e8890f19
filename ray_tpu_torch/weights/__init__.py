"""ray_tpu_torch.weights: the cluster weight plane, the port of ray_tpu.weights.

A GCS-backed registry of named models with monotonic versions, and a
broadcast path aware of the topology: a publisher chunks its weights into
the object store once, subscriber nodes relay chunks to each other along a
binomial tree (the publisher's upload does not grow with the number of
subscriber nodes), subscribers on one node share its store, and a
superseded version is tombstoned and freed only after its last pinned
reader lets go.

    pub = weights.WeightPublisher("policy/ppo")
    v = pub.publish(params)                      # one upload, any fan-out

    sub = weights.WeightSubscriber("policy/ppo")
    version, params = sub.get(device="cuda")     # pinned until the next get()
    sub.staleness()                              # versions behind head

The helpers cache one publisher and one subscriber per model per process:
``publish(name, tree)``, ``fetch(name)`` and ``resolve(obj)`` (which turns a
:class:`WeightHandle` task argument back into the tree, pulled over the
broadcast tree instead of the task's call). Leaves are torch tensors: see
:mod:`.manifest` for where the bytes live.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from .manifest import (
    CODEC_INT8,
    CODEC_RAW,
    ChunkInfo,
    Manifest,
    assemble_pytree,
    chunk_logical_bytes,
    chunk_pytree,
    decode_leaf,
    leaf_logical_nbytes,
    leaf_wire_nbytes,
    reshard,
)
from .publisher import WeightPublisher
from .subscriber import WeightSubscriber

__all__ = [
    "CODEC_INT8",
    "CODEC_RAW",
    "ChunkInfo",
    "Manifest",
    "WeightHandle",
    "WeightPublisher",
    "WeightSubscriber",
    "assemble_pytree",
    "chunk_logical_bytes",
    "chunk_pytree",
    "decode_leaf",
    "fetch",
    "leaf_logical_nbytes",
    "leaf_wire_nbytes",
    "list_models",
    "publish",
    "reshard",
    "resolve",
]

_lock = threading.Lock()
_publishers: Dict[str, WeightPublisher] = {}
_subscribers: Dict[str, WeightSubscriber] = {}


@dataclass(frozen=True)
class WeightHandle:
    """A pointer by name to one published version, small enough for any
    task argument or config; consumers resolve it through the broadcast
    tree with :func:`resolve`."""

    name: str
    version: Optional[int] = None  # None = head at resolve time


def _publisher(name: str) -> WeightPublisher:
    with _lock:
        pub = _publishers.get(name)
        if pub is None:
            pub = _publishers[name] = WeightPublisher(name)
        return pub


def _subscriber(name: str) -> WeightSubscriber:
    with _lock:
        sub = _subscribers.get(name)
        if sub is None:
            sub = _subscribers[name] = WeightSubscriber(name)
        return sub


def publish(
    name: str,
    tree: Any,
    meta: Optional[dict] = None,
    quantized: Optional[bool] = None,
) -> WeightHandle:
    """Publish one version through this process's cached publisher; returns
    a handle to the assigned version. ``quantized=True`` stores it with the
    int8 chunk codec (about 2x fewer bytes than bf16 and 4x fewer than f32
    in the store and on every hop; subscribers decode at assembly); None
    keeps the publisher's default."""
    version = _publisher(name).publish(tree, meta, quantized=quantized)
    return WeightHandle(name, version)


def fetch(
    name: str,
    version: Optional[int] = None,
    device: Any = None,
    timeout: Optional[float] = None,
    fallback_to_head: bool = False,
) -> Tuple[int, Any]:
    """(version, tree) through this process's cached subscriber, the tree's
    leaves on ``device`` (None: the host)."""
    return _subscriber(name).get(
        version, device=device, timeout=timeout, fallback_to_head=fallback_to_head,
    )


def resolve(obj: Any, device: Any = None) -> Any:
    """The identity for plain values; a :class:`WeightHandle` fetches its
    version over the weight plane. A handle whose exact version was
    collected (every other reader moved on) resolves head instead: the
    handle holds no registry pin, and for the sync flows that mint handles
    one version of staleness beats failing the task."""
    if isinstance(obj, WeightHandle):
        _, value = fetch(obj.name, obj.version, device=device, timeout=30.0,
                         fallback_to_head=True)
        return value
    return obj


def list_models():
    """The registry's rows for every published model: head version, live
    and pinned versions, tombstones, the broadcast tree's shape."""
    from .. import _worker_api

    worker = _worker_api.get_core_worker()
    return _worker_api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call("weights_list", timeout=10.0)
    )


def _reset_for_shutdown():
    """Drop the cached publishers and subscribers (``shutdown()`` calls it).
    Local only, no calls: the registry's and the stores' pins die with the
    cluster, and an unpin during teardown would race the loop's stop. No
    cached instance may leak into the next ``init()``."""
    with _lock:
        for sub in _subscribers.values():
            sub._current = None
            sub._prefetched.clear()
        _subscribers.clear()
        for pub in _publishers.values():
            pub._held.clear()
            pub._held_ids.clear()
        _publishers.clear()
