"""Prefix-block fingerprints: the tier's lookup keys. The port of
ray_tpu/kvtier/fingerprint.py, the same strings for the same tokens.

A prompt's cacheable identity is its sequence of *full* KV blocks, so the
fingerprint chain is a running hash over block-sized token groups:
``fps[i]`` commits blocks ``0..i`` inclusive. Chaining means equality of
``fps[i]`` implies equality of the entire leading ``(i+1)`` blocks: one
string compare replaces a token-by-token prefix walk, and the registry can
index every prefix length of an entry under its own fingerprint without
storing any tokens.

Fingerprints are content-only (no model name): the registry scopes every
lookup by model id.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

#: hex characters kept per fingerprint: 128 bits
_FP_HEX = 32


def block_fingerprints(token_ids: Sequence[int], block_size: int) -> List[str]:
    """Running fingerprint per full block of ``token_ids``; ``fps[i]``
    covers tokens ``[0, (i+1) * block_size)``. A trailing partial block
    contributes nothing (only full blocks are committed and shipped)."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    h = hashlib.sha256()
    fps: List[str] = []
    for i in range(len(token_ids) // block_size):
        block = token_ids[i * block_size : (i + 1) * block_size]
        h.update(b"|".join(str(int(t)).encode() for t in block))
        h.update(b";")
        fps.append(h.hexdigest()[:_FP_HEX])
    return fps
