"""The shared chunk transfer layer: the port of ray_tpu/_internal/transfer.py.

Both planes that move bulk tensor bytes between processes, the weight
plane's versioned broadcast and the KV tier's prefill->decode shipments, go
through these primitives:

- ``put_chunks``: serialize values into the local object store (forced into
  the shared store, so that the out-of-band tensor buffers are peer
  pullable), weight-pin each object at its source (exempt from eviction and
  spill while in flight), and return ``(object_id, size)`` pairs for the
  caller's manifest or registry entry.
- ``fetch_chunk``: pull one chunk into the local store and deserialize it,
  steered by ``prefer_source`` (a broadcast-tree parent, a KV holder), with
  a bounded wait for that source to hold the object and a reachability
  probe of the source, bounded at :data:`HOLDER_PROBE_S`, before the pull
  commits to it: a killed holder costs the probe, not the connect window.
- ``pin_chunks`` / ``unpin_chunks``: the eviction and spill exemption for a
  lease's lifetime (a weight subscription, a KV tier hold).

A chunk record is anything with ``object_id``, ``owner_address`` and
``size`` (the weight plane's ``ChunkInfo``, the KV tier's shipment chunks).
Every coroutine runs on the worker's event loop.

Chunks hold torch tensors, which cross as raw bytes with their dtype (bf16
included, ROADMAP kept item 36): a tensor on the card is copied to the host
once, by the caller (``weights.manifest.chunk_pytree``), and the host bytes
go out of band straight into the store's arena.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional, Sequence, Tuple

from ..exceptions import ObjectLostError
from ..object_ref import ObjectRef
from . import serialization

# Bound on probing a preferred source's transport before a pull commits to
# it: long enough for a live but busy peer to accept, far below the connect
# timeout a dead peer burns.
HOLDER_PROBE_S = 2.0


class DeadHolderError(Exception):
    """The designated holder of a chunk is gone: it failed its reachability
    probe, or no longer holds the bytes. Raised where the caller asked for
    ``require_source=True`` (the KV tier's pulls, where the right fallback
    is a recompute, not an unconstrained pull into the same dead owner)."""


async def probe_reachable(worker, address: Tuple[str, int],
                          timeout_s: float = HOLDER_PROBE_S) -> bool:
    """True iff a transport to ``address`` connects within ``timeout_s``."""
    try:
        client = worker.client_pool.get(*address)
        await asyncio.wait_for(client._ensure_connected(), timeout_s)
        return True
    except Exception:
        return False


async def put_chunks(worker, values: Sequence, *, pin: bool = True) -> List[Tuple[bytes, int]]:
    """Store each value as one object in the shared store; return (object
    id, size) pairs. The caller owns the objects (it wraps them in
    ``ObjectRef`` to keep them alive); ``pin=True`` also weight-pins each at
    the source, so that a chunk in flight is neither evicted nor spilled."""
    raylet = worker.client_pool.get(*worker.raylet_address)
    out = []
    for value in values:
        meta_b, bufs = serialization.serialize(value)
        oid, size = await worker.put_serialized(meta_b, bufs, force_plasma=True)
        if pin:
            await raylet.call("store_pin_weight", oid)
        out.append((oid, size))
    return out


async def fetch_chunk(
    worker,
    chunk,
    source: Optional[Tuple[str, int]],
    *,
    wait_s: float = 0.0,
    fellback: Optional[list] = None,
    probe_source: bool = False,
    require_source: bool = False,
):
    """Fetch one chunk into the local store and return its deserialized
    value. ``source`` is the preferred holder. When the object is not
    already local:

    - ``probe_source=True`` first probes ``source``, bounded at
      :data:`HOLDER_PROBE_S`; an unreachable source either degrades to a
      pull directed by the owner (default) or raises
      :class:`DeadHolderError` (``require_source=True``, the KV tier's
      contract, where a recompute beats a doomed pull);
    - ``wait_s > 0`` polls the source until it holds the object (tree
      order), and falls back past the deadline; ``fellback`` is a
      one-element flag list set True when that wait was abandoned.
    """
    raylet = worker.client_pool.get(*worker.raylet_address)
    ref = ObjectRef(chunk.object_id, tuple(chunk.owner_address))
    prefer = None
    local = await raylet.call("store_contains", chunk.object_id)
    if not local and source is not None \
            and tuple(source) != tuple(worker.raylet_address):
        if probe_source and not await probe_reachable(worker, tuple(source)):
            if require_source:
                raise DeadHolderError(
                    f"chunk holder {tuple(source)} unreachable within "
                    f"{HOLDER_PROBE_S:g}s"
                )
            if fellback is not None:
                fellback[0] = True
            source = None
        if source is not None:
            if wait_s > 0:
                prefer = await wait_for_holder(worker, chunk.object_id,
                                               tuple(source), wait_s)
                if prefer is None and fellback is not None:
                    fellback[0] = True
            else:
                prefer = tuple(source)
    if not local and require_source and prefer is None and source is not None:
        # the holder answered the probe but no longer has the bytes (evicted
        # between resolve and pull): the same contract, a recompute wins
        raise DeadHolderError(
            f"chunk holder {tuple(source)} no longer holds {chunk.object_id!r}"
        )
    try:
        return await worker._read_plasma(ref, chunk.size, prefer_source=prefer)
    except ObjectLostError as e:
        if not require_source:
            raise
        # every copy is gone (the owner died with its chunks): a recompute
        raise DeadHolderError(f"chunk {chunk.object_id!r} is lost: {e}") from e


async def wait_for_holder(worker, object_id, holder: Tuple[str, int],
                          wait_s: float) -> Optional[Tuple[str, int]]:
    """Poll ``holder`` until it reports the object local; None past the
    deadline or for an unreachable holder (the caller falls back to any
    source)."""
    deadline = time.monotonic() + wait_s
    client = worker.client_pool.get(*holder)
    delay = 0.01
    while True:
        try:
            if await client.call("store_contains", object_id):
                return tuple(holder)
        except Exception:
            return None  # holder unreachable: fall back to any source
        if time.monotonic() >= deadline:
            return None
        await asyncio.sleep(delay)
        delay = min(delay * 2, 0.25)


async def pin_chunks(worker, object_ids: Sequence) -> List:
    """Weight-pin the local copies (the eviction and spill exemption for a
    lease's lifetime); returns the object ids actually pinned (a chunk that
    is not local is not pinned)."""
    raylet = worker.client_pool.get(*worker.raylet_address)
    pinned = []
    for oid in object_ids:
        if await raylet.call("store_pin_weight", oid):
            pinned.append(oid)
    return pinned


async def unpin_chunks(worker, object_ids: Sequence):
    """Drop the pins of :func:`pin_chunks` (one-way calls: a raylet that is
    gone has dropped them with its store)."""
    raylet = worker.client_pool.get(*worker.raylet_address)
    for oid in object_ids:
        try:
            await raylet.call_oneway("store_unpin_weight", oid)
        except Exception:  # noqa: BLE001 - the raylet and its pins are gone
            pass
