"""Gradient bucketizer: the port of ray_tpu/collective/bucketizer.py.

The scheduler (``collective/scheduler.py``) reduces gradients bucket by
bucket, so the first buckets' allreduce runs while later ones are packed.
Two contracts, as in the reference:

1. **Deterministic across ranks.** Every rank packs the same leaves into
   the same bucket in the same order. The assignment depends only on the
   sorted leaf names, shapes and dtypes, never on insertion order or rank.
2. **Size-targeted.** Leaves are packed greedily in sorted-name order until
   a bucket reaches ``bucket_bytes``; a leaf at or above the target gets a
   bucket of its own. Buckets are dtype-homogeneous, so each packs into one
   flat tensor with no cast.

The port's trees are flat ``name -> tensor`` dicts (``named_parameters()``
keys), so a leaf's path string is its name; a nested reference tree with
path strings ``a/b`` gives the buckets of the dict keyed ``"a/b"``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from .._internal.quantization import _dtype_name

#: the default size target: large enough to amortise an op's dispatch, small
#: enough that early buckets reduce while later ones are still being packed
DEFAULT_BUCKET_BYTES = 4 << 20


@dataclass(frozen=True)
class BucketSpec:
    """One bucket's assignment, identical on every rank."""

    index: int
    #: leaf names, in pack order
    paths: Tuple[str, ...]
    #: per-leaf shapes, in pack order (unpack splits by these)
    shapes: Tuple[Tuple[int, ...], ...]
    dtype: str
    nbytes: int


class GradientBucketizer:
    """Assign a flat dict's tensors to size-targeted buckets; pack a dict of
    the same structure into one flat tensor per bucket and unpack it back."""

    def __init__(self, tree: Mapping[str, torch.Tensor],
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        if bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
        self.bucket_bytes = int(bucket_bytes)
        #: the names in the order of the tree it was built from (unpack's order)
        self._names: List[str] = list(tree)
        infos = sorted(
            (name, tuple(int(d) for d in t.shape), _dtype_name(t.dtype),
             t.numel() * t.element_size())
            for name, t in tree.items()
        )
        self.buckets: List[BucketSpec] = []
        current: List[tuple] = []
        for info in infos:
            if current and (info[2] != current[0][2]
                            or self._nbytes(current) >= self.bucket_bytes):
                self._close(current)
            current.append(info)
            if self._nbytes(current) >= self.bucket_bytes:
                self._close(current)
        self._close(current)

    @staticmethod
    def _nbytes(infos) -> int:
        return sum(i[3] for i in infos)

    def _close(self, current: List[tuple]):
        if current:
            self.buckets.append(BucketSpec(
                index=len(self.buckets),
                paths=tuple(i[0] for i in current),
                shapes=tuple(i[1] for i in current),
                dtype=current[0][2],
                nbytes=self._nbytes(current),
            ))
            current.clear()

    def signature(self) -> tuple:
        """Two trees with equal signatures get the same buckets."""
        return tuple((b.paths, b.shapes, b.dtype) for b in self.buckets) + (
            self.bucket_bytes,)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def pack(self, tree: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
        """One flat 1-D tensor per bucket, its leaves concatenated in
        assignment order, on the leaves' device."""
        if len(tree) != len(self._names) or set(tree) != set(self._names):
            raise ValueError(
                f"tree has {len(tree)} leaves, not the {len(self._names)} leaves "
                "this bucketizer was built for"
            )
        return [torch.cat([tree[name].reshape(-1) for name in spec.paths])
                for spec in self.buckets]

    def unpack(self, bucket_tensors: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Invert :meth:`pack`: each leaf is a view of its bucket, of the
        leaf's shape."""
        if len(bucket_tensors) != len(self.buckets):
            raise ValueError(
                f"got {len(bucket_tensors)} bucket arrays for {len(self.buckets)} buckets"
            )
        flat: Dict[str, torch.Tensor] = {}
        for spec, t in zip(self.buckets, bucket_tensors):
            offset = 0
            for name, shape in zip(spec.paths, spec.shapes):
                size = math.prod(shape)
                flat[name] = t[offset:offset + size].view(shape)
                offset += size
        return {name: flat[name] for name in self._names}
