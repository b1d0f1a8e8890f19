"""Cluster-wide KV prefix tier: ship committed KV blocks between replicas.
The port of ray_tpu.kvtier.

The per-replica radix index (``kvcache.PrefixIndex``) makes repeated
prefixes cheap on one replica; this package makes them cheap on every
replica. A replica that commits a cacheable prefix exports its blocks and
registers a fingerprint chain with the tier registry; any replica, a fresh
scale-up that has computed nothing included, resolves a warm prefix
**local-hit -> peer-pull -> recompute**, in that order. The same shipment
machinery carries the directed prefill->decode handoff of disaggregated
serving, where the decode replica adopts the shipped blocks (plus the tail
fragment and the first sampled token) and starts decoding with zero
prefill-computed tokens.
"""

from .fingerprint import block_fingerprints
from .shipping import KVShipment, decode_payload, encode_payload
from .tier import (
    GcsTierBackend,
    KVTierClient,
    LocalTierBackend,
    PulledPrefix,
)

__all__ = [
    "KVShipment",
    "KVTierClient",
    "GcsTierBackend",
    "LocalTierBackend",
    "PulledPrefix",
    "block_fingerprints",
    "encode_payload",
    "decode_payload",
]
