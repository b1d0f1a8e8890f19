"""WeightPublisher: push a model's state into the weight plane. The port of
ray_tpu/weights/publisher.py.

``publish(tree)`` chunks the weights into the local object store (each leaf
copied to the host once, and each chunk serialized once with its tensors'
bytes out of band: one store object per chunk), registers a versioned
manifest with the GCS registry, and holds the chunks' ObjectRefs until the
registry reports the version collectible; dropping them frees the chunks
across the cluster through the ownership layer. The publisher's upload is
one model's bytes: subscriber nodes relay chunks to each other along the
broadcast tree.

Leaves are torch tensors on any device. A tensor on the card crosses as its
raw bytes with its dtype (bf16 included, ROADMAP kept item 36): one
device-to-host copy per leaf (``manifest.chunk_pytree``), and with
``quantized=True`` the int8 codes are made on the card first, so only the
codes and scales cross.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

from .. import _worker_api
from .._internal import transfer
from ..object_ref import ObjectRef
from ..util import metrics
from .manifest import (
    CODEC_INT8,
    CODEC_RAW,
    ChunkInfo,
    Manifest,
    chunk_logical_bytes,
    chunk_pytree,
)

logger = logging.getLogger(__name__)


class WeightPublisher:
    def __init__(self, name: str, chunk_size: Optional[int] = None,
                 quantized: bool = False):
        self.name = name
        worker = _worker_api.get_core_worker()
        self._chunk_size = chunk_size or worker.config.weights_chunk_size
        # the int8 codec by default for this publisher's versions; one
        # publish overrides it with publish(quantized=...)
        self._quantized = quantized
        # version -> chunk refs held until the registry releases the version
        self._held: Dict[int, List[ObjectRef]] = {}
        self._held_ids: Dict[int, list] = {}

    # -- publish -----------------------------------------------------------

    def publish(self, tree: Any, meta: Optional[dict] = None,
                quantized: Optional[bool] = None) -> int:
        """Store and register one new version; returns the version the
        registry assigned. ``quantized=True`` encodes float leaves as int8
        per block (the store, and every hop of the tree, carries the
        compressed form); None takes the publisher's default."""
        worker = _worker_api.get_core_worker()
        t0 = time.perf_counter()
        use_quant = self._quantized if quantized is None else quantized
        codec = CODEC_INT8 if use_quant else CODEC_RAW
        treedef_blob, chunk_values, total_bytes = chunk_pytree(
            tree, self._chunk_size, codec=codec
        )

        async def _store():
            # pin=True: a chunk of a live version stays resident at its
            # source, exempt from eviction and spill
            stored = await transfer.put_chunks(worker, chunk_values, pin=True)
            infos, refs = [], []
            for value, (oid, size) in zip(chunk_values, stored):
                refs.append(ObjectRef(oid, worker.address))
                infos.append(ChunkInfo(
                    object_id=oid,
                    owner_address=tuple(worker.address),
                    size=size,
                    num_leaves=len(value),
                    codec=codec,
                    logical_size=chunk_logical_bytes(value),
                ))
            return infos, refs

        infos, refs = _worker_api.run_on_worker_loop(_store())
        del chunk_values  # the host copies: the store holds the bytes now
        wire_bytes = sum(c.size for c in infos)
        manifest = Manifest(
            name=self.name,
            version=None,
            treedef_blob=treedef_blob,
            chunks=infos,
            total_bytes=total_bytes,
            publisher_node=tuple(worker.raylet_address),
            created_at=time.time(),
            codec=codec,
            wire_bytes=wire_bytes,
        )
        reply = _worker_api.run_on_worker_loop(
            worker.client_pool.get(*worker.gcs_address).call(
                "weights_publish",
                self.name,
                manifest.to_blob(),
                {
                    "total_bytes": total_bytes,
                    "wire_bytes": wire_bytes,
                    "codec": codec,
                    "num_chunks": len(infos),
                    **(meta or {}),
                },
            )
        )
        version = reply["version"]
        self._held[version] = refs
        self._held_ids[version] = [c.object_id for c in infos]
        # a subscriber's unpin queues a release but never consumes it: every
        # publish drains the queue and reconciles against the registry's
        # live set, so versions tombstoned between publishes are freed here
        self._reconcile(reply)
        metrics.record_weights_publish(
            self.name, time.perf_counter() - t0, total_bytes,
            wire_nbytes=wire_bytes, codec=codec,
        )
        return version

    # -- GC ----------------------------------------------------------------

    def collect(self):
        """Drop the chunk refs of every version the registry has tombstoned
        (and reconcile against its live set, which covers release lists
        lost to a GCS restart)."""
        worker = _worker_api.get_core_worker()
        reply = _worker_api.run_on_worker_loop(
            worker.client_pool.get(*worker.gcs_address).call(
                "weights_collect", self.name
            )
        )
        self._reconcile(reply)

    def _reconcile(self, reply: dict):
        """Free everything the registry released, and any held version the
        registry no longer lists as live."""
        released = set(reply.get("released", ()))
        live = reply.get("live")
        if live is not None:
            live_set = set(live)
            released |= {v for v in self._held if v not in live_set}
        self._release(released)

    def _release(self, versions):
        if not versions:
            return
        worker = _worker_api.maybe_get_core_worker()
        for version in versions:
            refs = self._held.pop(version, None)
            oids = self._held_ids.pop(version, None)
            if refs:
                logger.debug("weights %s: releasing version %s (%d chunks)",
                             self.name, version, len(refs))
            if oids and worker is not None:
                _worker_api.run_on_worker_loop(transfer.unpin_chunks(worker, oids))
            # dropping the refs is the free: the ownership layer frees every
            # node's copy once no borrower (a subscriber) holds the chunk

    def close(self):
        """Release every held version (the registry may still list them; a
        version whose publisher let go fails at fetch time, the lifetime
        contract of any object whose owner is gone)."""
        self._release(list(self._held))
