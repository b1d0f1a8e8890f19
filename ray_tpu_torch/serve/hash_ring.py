"""Rendezvous (highest-random-weight) hashing over a replica set: the port
of ray_tpu/serve/hash_ring.py, copied without departure, so that a prefix's
key picks the same replica in both packages.

Every process that sees the same replica-id set maps a key to the same
winner with no coordination, and adding or removing one replica only moves
the keys whose winner was that replica (about 1/n of them). For key ``k``
and replica ``r`` the weight is ``crc32(key_bytes, seed=crc32(r))``; the
replica with the highest weight wins. crc32, not ``hash()``:
PYTHONHASHSEED randomizes str/bytes hashing per process, and
cross-process agreement is the point.
"""

from __future__ import annotations

import zlib
from typing import Iterable, Tuple


class ReplicaRing:
    """Immutable rendezvous ring over a replica-id set.

    Built once per routing-table generation; ``lookup_index(key)`` is
    O(n) crc32s with no allocation beyond the 8-byte key encoding —
    cheap for realistic replica counts, and the O(1)-update properties
    of a virtual-node ring buy nothing for n < a few hundred.
    """

    __slots__ = ("ids", "_salts")

    def __init__(self, replica_ids: Iterable[str]):
        # sorted for deterministic iteration order; agreement itself only
        # needs the same *set* (HRW is order-independent)
        self.ids: Tuple[str, ...] = tuple(sorted(str(r) for r in replica_ids))
        self._salts: Tuple[int, ...] = tuple(
            zlib.crc32(rid.encode()) for rid in self.ids
        )

    def __len__(self) -> int:
        return len(self.ids)

    def lookup_index(self, key: int) -> int:
        """Index (into ``ids``) of the key's preferred replica."""
        kb = (key & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
        salts = self._salts
        best_i = 0
        best_w = -1
        for i in range(len(salts)):
            w = zlib.crc32(kb, salts[i])
            if w > best_w:
                best_w = w
                best_i = i
        return best_i

    def lookup(self, key: int) -> str:
        """Replica id preferred for ``key`` (empty ring raises IndexError)."""
        return self.ids[self.lookup_index(key)]

    def lookup_excluding(self, key: int, exclude) -> int:
        """Preferred index skipping replicas in ``exclude`` (a set of ids);
        falls back to the unfiltered winner when exclusion would leave
        nothing (a 1-replica deployment's restart is still worth a try)."""
        kb = (key & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
        ids = self.ids
        salts = self._salts
        best_i = -1
        best_w = -1
        for i in range(len(salts)):
            if ids[i] in exclude:
                continue
            w = zlib.crc32(kb, salts[i])
            if w > best_w:
                best_w = w
                best_i = i
        if best_i < 0:
            return self.lookup_index(key)
        return best_i
