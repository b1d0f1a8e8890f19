"""ray_tpu_torch.weights: the chunk manifest of the weight plane.

So far only :mod:`.manifest`'s chunking and codec, which the KV tier's
shipments ride on. The weight plane itself (publisher, subscriber,
broadcast, ``Manifest`` and its registry) waits for the runtime.
"""

from .manifest import (
    CODEC_INT8,
    CODEC_RAW,
    ChunkInfo,
    assemble_pytree,
    chunk_logical_bytes,
    chunk_pytree,
    decode_leaf,
    leaf_logical_nbytes,
    leaf_wire_nbytes,
)

__all__ = [
    "CODEC_INT8",
    "CODEC_RAW",
    "ChunkInfo",
    "assemble_pytree",
    "chunk_logical_bytes",
    "chunk_pytree",
    "decode_leaf",
    "leaf_logical_nbytes",
    "leaf_wire_nbytes",
]
