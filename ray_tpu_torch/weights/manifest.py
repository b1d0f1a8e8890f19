"""Weight-plane manifests: how a pytree of tensors becomes transferable
chunks. The port of ray_tpu/weights/manifest.py.

A published model version is described by a :class:`Manifest`: the
pytree's structure plus an ordered list of :class:`ChunkInfo` entries, each
one object-store object holding a contiguous run of leaves.

The pytree (``torch.utils._pytree``, for the reference's
``jax.tree_util``) is flattened; its structure is serialized once (torch's
``treespec_dumps``), and its
leaves are packed greedily, in flatten order, into chunks of at most
``chunk_size`` wire bytes (an oversized leaf is a chunk of its own; a leaf
is never split). Assembly is the inverse: the chunks' leaf lists in order,
unflattened with the structure.

Codecs: with ``codec="int8"`` every quantizable float leaf is encoded as
per-block int8 codes and f32 scales (``_internal/quantization.py``) before
packing, so packing budgets *wire* bytes and the chunks carry the
compressed form; small and non-float leaves stay raw. Bytes are counted
twice: logical (the raw leaves) and wire (what moves).

Where the bytes live: leaves are torch tensors. :func:`chunk_pytree` codes
each leaf on its own device (a tensor on the card is quantized on the card)
and moves the wire form to pinned host memory, once, as the reference's
``np.asarray`` does: a chunk is a host object. :func:`assemble_pytree`
moves each leaf to ``device`` (the reference's ``sharding``) and decodes it
there, so an int8 leaf crosses the host link as codes and is dequantized on
the card. :func:`reshard` moves an assembled tree to another device; it
takes a device, or a callable that gives the devices for the assembled
tree, where the reference takes a sharding.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from .._internal import serialization
from .._internal.device import DeviceLike
from .._internal.quantization import (
    QuantizedArray,
    dequantize_torch,
    is_quantizable,
    quantize_torch,
)

#: chunk codec tags (ChunkInfo.codec / Manifest.codec)
CODEC_RAW = "raw"
CODEC_INT8 = "int8"


@dataclass(frozen=True)
class ChunkInfo:
    object_id: Any
    owner_address: Tuple[str, int]
    size: int          # packed (wire) size in the store
    num_leaves: int    # leaves carried by this chunk, in flatten order
    # codec the chunk's leaves were encoded with and their raw (logical)
    # byte total
    codec: str = CODEC_RAW
    logical_size: int = 0


@dataclass
class Manifest:
    name: str
    version: Optional[int]          # assigned by the registry at publish
    treedef_blob: bytes
    chunks: List[ChunkInfo] = field(default_factory=list)
    total_bytes: int = 0            # sum of raw leaf bytes (pre-framing)
    publisher_node: Optional[Tuple[str, int]] = None  # raylet address
    created_at: float = 0.0
    codec: str = CODEC_RAW          # chunk codec of this version
    wire_bytes: int = 0             # sum of packed chunk sizes in the store

    def to_blob(self) -> bytes:
        return serialization.dumps(self)

    @staticmethod
    def from_blob(blob: bytes) -> "Manifest":
        return serialization.loads(blob)


def _tensor_nbytes(t: Any) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return int(getattr(t, "nbytes", 0))


def leaf_logical_nbytes(leaf: Any) -> int:
    """Raw (pre-codec) byte size of a chunk leaf."""
    if isinstance(leaf, QuantizedArray):
        return leaf.logical_nbytes
    return _tensor_nbytes(leaf)


def leaf_wire_nbytes(leaf: Any) -> int:
    """Encoded byte size of a chunk leaf: what packing budgets against."""
    if isinstance(leaf, QuantizedArray):
        return leaf.wire_nbytes
    return _tensor_nbytes(leaf)


def chunk_logical_bytes(values: List[Any]) -> int:
    """Raw leaf-byte total of one chunk's leaf list (``ChunkInfo.
    logical_size``, the denominator of the wire/logical split)."""
    return sum(leaf_logical_nbytes(v) for v in values)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A device tensor's copy in pinned host memory (queued on the current
    stream); a host tensor as it is."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _to_device(t: Any, device: Optional[torch.device]) -> Any:
    if device is None or not isinstance(t, torch.Tensor):
        return t
    return t.to(device, non_blocking=True)


def decode_leaf(leaf: Any, device: DeviceLike = None):
    """Inverse of the chunk codec: a quantized leaf is moved to ``device``
    (None: where it is) and densified there to its dtype and shape; a raw
    leaf is moved."""
    device = torch.device(device) if device is not None else None
    if isinstance(leaf, QuantizedArray):
        return dequantize_torch(_to_device(torch.as_tensor(leaf.q), device),
                                _to_device(torch.as_tensor(leaf.scales), device),
                                leaf.shape, leaf.dtype)
    return _to_device(leaf, device)


def chunk_pytree(tree: Any, chunk_size: int, codec: str = CODEC_RAW):
    """Flatten ``tree`` (leaves: torch tensors) and group its leaves into
    chunk-sized runs. Returns ``(treedef_blob, chunk_values, total_bytes)``:
    each element of ``chunk_values`` is one chunk's list of leaf payloads in
    host memory, and ``total_bytes`` the logical (raw leaf) total. With
    ``codec="int8"`` quantizable float leaves are encoded here, on their
    own device, before they move to the host, so packing budgets wire bytes.
    Returns when every byte is on the host."""
    if codec not in (CODEC_RAW, CODEC_INT8):
        raise ValueError(f"unknown weights chunk codec {codec!r}")
    leaves, treedef = pytree.tree_flatten(tree)
    # None is an empty subtree to jax.tree_util and a leaf to torch's
    # pytree: it travels in the structure, not as a leaf
    nones = [i for i, leaf in enumerate(leaves) if leaf is None]
    host_leaves: List[Any] = []
    devices = set()
    for leaf in leaves:
        if leaf is None:
            continue
        leaf = torch.as_tensor(leaf)
        if leaf.device.type == "cuda":
            devices.add(leaf.device)
        if codec == CODEC_INT8 and is_quantizable(leaf):
            q, scales = quantize_torch(leaf)
            host_leaves.append(QuantizedArray(
                q=_to_host(q), scales=_to_host(scales), shape=tuple(leaf.shape),
                dtype=str(leaf.dtype).replace("torch.", ""),
            ))
        else:
            host_leaves.append(_to_host(leaf))
    for device in devices:  # the pinned copies are complete
        torch.cuda.current_stream(device).synchronize()
    chunk_values: List[list] = []
    current: list = []
    current_bytes = 0
    total = 0
    for leaf in host_leaves:
        nbytes = leaf_wire_nbytes(leaf)
        total += leaf_logical_nbytes(leaf)
        if current and current_bytes + nbytes > chunk_size:
            chunk_values.append(current)
            current, current_bytes = [], 0
        current.append(leaf)
        current_bytes += nbytes
    if current or not chunk_values:
        chunk_values.append(current)
    return serialization.dumps((pytree.treespec_dumps(treedef), nones)), chunk_values, total


def assemble_pytree(treedef_blob: bytes, chunk_values: List[list],
                    device: DeviceLike = None):
    """Unflatten fetched chunk leaf lists back into the pytree, each leaf
    moved to ``device`` (None: left where it is) and decoded there."""
    spec, nones = serialization.loads(treedef_blob)
    treedef = pytree.treespec_loads(spec)
    leaves: list = []
    for chunk in chunk_values:
        leaves.extend(decode_leaf(v, device) for v in chunk)
    for i in nones:
        leaves.insert(i, None)
    return pytree.tree_unflatten(leaves, treedef)


def reshard(value: Any, device: Any):
    """Move every tensor leaf of ``value`` to ``device``: one device for the
    whole tree, a matching pytree of per-leaf devices, or a callable
    ``value -> device or pytree of devices`` (resolved here, against the
    assembled tree). None is a no-op."""
    if device is None:
        return value
    if callable(device):
        device = device(value)
        if device is None:
            return value

    def move(leaf, d):
        if d is None or not isinstance(leaf, torch.Tensor):
            return leaf
        return leaf.to(torch.device(d))

    if isinstance(device, (str, torch.device, int)):
        return pytree.tree_map(lambda leaf: move(leaf, device), value)
    return pytree.tree_map(move, value, device)
