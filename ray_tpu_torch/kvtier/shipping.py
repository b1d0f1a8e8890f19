"""KV shipment encoding: committed prefix blocks as transferable chunks. The
port of ray_tpu/kvtier/shipping.py.

A shipment's payload is a plain pytree, ``{"blocks": [...], "tail": [...] or
None}`` (the layout is the KV manager's, ``kvcache/manager.py``
``extract_row_payload``), encoded with the weight plane's chunk machinery
(``weights/manifest.chunk_pytree``): greedy wire-byte packing, the int8
per-block codec with dequantize-on-assemble, and logical-vs-wire byte
accounting. So ``codec="int8"`` halves the prefill->decode bytes of a bf16
cache as it halves a weight broadcast.

The :class:`KVShipment` descriptor is what crosses the control plane (the
tier registry's blob, or the prefill->decode handoff): token coverage,
block geometry, the first sampled token (what lets a decode replica start
with **zero** prefill-computed tokens), and the chunk records that point at
the holder's chunks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from .._internal import serialization
from .._internal.device import DeviceLike
from ..weights.manifest import (
    CODEC_INT8,
    CODEC_RAW,
    ChunkInfo,
    assemble_pytree,
    chunk_pytree,
    leaf_wire_nbytes,
)
from .fingerprint import block_fingerprints

#: default target size of one shipment chunk (small prefixes ship as one)
DEFAULT_CHUNK_SIZE = 4 * 1024 * 1024


@dataclasses.dataclass
class KVShipment:
    """Descriptor of one shipped prefix: geometry and chunk pointers.

    ``token_ids`` are the tokens whose K/V the payload covers:
    ``nblocks * block_size`` full-block tokens plus the tail fragment.
    ``first_token`` is the token sampled from the prefill logits (present on
    directed and full shipments; ``None`` on blocks-only tier entries), so
    an exact-prompt consumer skips prefill entirely.
    """

    model: str
    token_ids: List[int]
    block_size: int
    nblocks: int
    codec: str
    treedef_blob: bytes
    chunks: List[ChunkInfo]
    first_token: Optional[int] = None
    logical_bytes: int = 0
    wire_bytes: int = 0

    @property
    def ntokens(self) -> int:
        return len(self.token_ids)

    @property
    def tail_len(self) -> int:
        return self.ntokens - self.nblocks * self.block_size

    def fingerprints(self) -> List[str]:
        """Fingerprint chain of the covered full blocks (what the holder
        registers: every prefix length points at this shipment)."""
        return block_fingerprints(
            self.token_ids[: self.nblocks * self.block_size], self.block_size
        )

    def to_blob(self) -> bytes:
        return serialization.dumps(self)

    @staticmethod
    def from_blob(blob: bytes) -> "KVShipment":
        return serialization.loads(blob)


def encode_payload(payload: Any, codec: str = CODEC_RAW,
                   chunk_size: int = DEFAULT_CHUNK_SIZE):
    """Chunk a shipment payload for transfer. Returns ``(treedef_blob,
    chunk_values, logical_bytes, wire_bytes)``, the weight publish's
    contract, so the int8 codec and the greedy packing ride along."""
    if codec not in (CODEC_RAW, CODEC_INT8):
        raise ValueError(f"unknown KV ship codec {codec!r}")
    treedef_blob, chunk_values, logical = chunk_pytree(payload, chunk_size, codec=codec)
    wire = sum(leaf_wire_nbytes(v) for chunk in chunk_values for v in chunk)
    return treedef_blob, chunk_values, logical, wire


def decode_payload(treedef_blob: bytes, chunk_values: List[list],
                   device: DeviceLike = None) -> Any:
    """Inverse of :func:`encode_payload`: each leaf moved to ``device`` (None:
    left on the host) and dequantized there, back into the ``{"blocks",
    "tail"}`` pytree."""
    return assemble_pytree(treedef_blob, chunk_values, device)
