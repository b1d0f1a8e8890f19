"""Chunk movement along the weight plane's broadcast tree: the port of
ray_tpu/weights/broadcast.py.

The GCS registry gives every subscriber node a position in a binomial
broadcast tree per model (``weight_registry.plan``): position 0, the seed,
pulls from the publisher's node; every other position pulls from the node
whose position clears its highest set bit. A child waits (bounded by
``weights_prefer_wait_s``) until its parent holds a chunk, then pulls with
``prefer_source`` at the parent, so:

- each chunk leaves the publisher's node once, whatever the number of
  subscriber nodes;
- subscribers on one node share its object store: the second finds every
  chunk local and moves nothing;
- a dead parent degrades to a pull directed by the owner after the wait,
  and the child reports it to the registry (``weights_report_fallback``),
  which prunes a parent reported twice, so later waves stop waiting on it.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional, Tuple

from .._internal import transfer
from .manifest import ChunkInfo


async def fetch_version_chunks(
    worker,
    name: str,
    chunks: List[ChunkInfo],
    parent: Optional[Tuple[str, int]],
    prefer_wait_s: float,
) -> List:
    """Fetch every chunk of a version concurrently and return their values
    (the raylet serializes pulls of one object; distinct chunks stream in
    parallel down the tree): each from the tree parent, with the bounded
    wait for it to hold the chunk, or from the owner at a seed position
    (``parent`` None). One fallback report per version fetch when the
    parent never delivered: the registry prunes a parent after repeated
    reports."""
    fellback = [False]
    values = list(await asyncio.gather(*[
        transfer.fetch_chunk(worker, chunk, parent, wait_s=prefer_wait_s, fellback=fellback)
        for chunk in chunks
    ]))
    if fellback[0] and parent is not None:
        await worker.client_pool.get(*worker.gcs_address).call_oneway(
            "weights_report_fallback", name, tuple(parent)
        )
    return values


def version_wire_bytes(chunks: List[ChunkInfo]) -> int:
    """Encoded bytes one full-version pull moves down the tree (the packed
    chunk sizes: with the int8 codec the compressed total, not the logical
    leaf bytes of ``Manifest.total_bytes``)."""
    return sum(c.size for c in chunks)


def version_logical_bytes(chunks: List[ChunkInfo]) -> int:
    """Raw leaf bytes the same pull stands for (a chunk without
    ``logical_size`` counts its packed size)."""
    return sum(getattr(c, "logical_size", 0) or c.size for c in chunks)
