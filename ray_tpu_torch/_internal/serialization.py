"""Serialization: the port of ray_tpu/_internal/serialization.py.

Two planes use it:

- the control plane (``dumps`` / ``loads``): function and class
  definitions for the GCS function table, shipment descriptors, a
  pytree's structure;
- the object plane (``serialize`` / ``pack`` / ``pack_into`` / ``unpack``
  / ``unpack_with_release``): task arguments, returns and ``put`` values,
  in the reference's wire format
  ``[u32 meta_len][u64 nbuf][meta pickle][u64 len_i ...][buffer bytes ...]``,
  with large contiguous buffers out of band (pickle protocol 5) so that
  they are copied once, straight into the store.

The reference pickles with cloudpickle. The card's machine has none, and
the port needs none: it pickles with the standard library, through
:class:`Pickler`, which differs from a plain pickler in two ways.

- **Callables travel by reference.** A function or a class is pickled as
  its module and qualified name, and the receiving worker imports it. A
  name bound at module level to a ``@remote`` wrapper of the object (the
  decorated function or actor class itself), or to a
  ``@serve.deployment`` of it, resolves to the object the wrapper holds. A callable defined in ``__main__``, inside a function, or
  as a lambda cannot be imported by a worker, so it is refused with a
  ``ValueError`` that names it (the reference pickles such callables by
  value).
- **A torch.Tensor crosses as raw bytes.** Its bytes go out of band as one
  contiguous buffer, with its dtype and shape, never through
  ``torch.save``: one device-to-host copy for a CUDA tensor, none for a
  contiguous CPU tensor. It arrives as a CPU tensor that owns its memory
  (bf16 included: numpy has no bf16, so the bytes are carried as they
  are); the getter moves it to a device itself, as the reference's jax
  array arrives as host numpy. ``requires_grad`` and the autograd graph do
  not travel.

Only bytes this program wrote are unpickled: unpickling can run code.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import pickle
import struct
import sys
import threading as _threading
import types
from typing import Any, List, Tuple

# Buffers smaller than this are kept inline in the pickle stream; splitting
# tiny buffers out-of-band costs more than it saves.
_OOB_THRESHOLD = 1 * 1024


# -- callables by reference ---------------------------------------------------


def _unwrap(obj: Any) -> Any:
    """The function or class a ``@remote`` wrapper or a
    ``@serve.deployment`` holds (``obj`` itself for anything else)."""
    for attr in ("__remote_wrapped__", "__deployment_target__"):
        if isinstance(getattr(type(obj), attr, None), property):
            return getattr(obj, attr)
    return obj


def _import_by_reference(module: str, qualname: str) -> Any:
    """Unpickle a callable: import its module, walk its qualified name, and
    unwrap a ``@remote`` wrapper."""
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return _unwrap(obj)


def _callable_reduce(obj: Any):
    """How a function or class pickles: ``NotImplemented`` (the standard
    global reference) where its name imports as itself, a reference that
    unwraps where its name imports as its ``@remote`` wrapper, and a
    ValueError naming a callable no worker can import."""
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None) or getattr(obj, "__name__", "")
    name = f"{module}.{qualname}"
    if "<lambda>" in qualname:
        raise ValueError(
            f"{name} is a lambda: a worker imports callables by their module and "
            "name, so define it with def at the top level of an importable module")
    if "<locals>" in qualname:
        raise ValueError(
            f"{name} is defined inside a function: a worker imports callables by "
            "their module and name, so define it at the top level of an importable "
            "module")
    if module in ("__main__", "__mp_main__"):
        raise ValueError(
            f"{name} is defined in __main__: a worker imports callables by their "
            "module and name and cannot import the driver's script, so move it into "
            "an importable module")
    try:
        found = importlib.import_module(module)
        for part in qualname.split("."):
            found = getattr(found, part)
    except Exception:  # noqa: BLE001 - the standard pickler says why
        return NotImplemented
    if found is not obj and _unwrap(found) is obj:
        return _import_by_reference, (module, qualname)
    return NotImplemented


# -- tensors as raw bytes -----------------------------------------------------


def _tensor_reduce(t):
    """Reduce a torch.Tensor to (dtype, shape, one contiguous byte buffer)."""
    import torch

    t = t.detach()
    if t.device.type != "cpu":
        t = t.to("cpu")  # the one device-to-host copy
    t = t.contiguous()
    dtype = str(t.dtype).removeprefix("torch.")
    shape = tuple(t.shape)
    if t.numel() == 0:
        return _rebuild_tensor, (b"", dtype, shape)
    raw = t.reshape(-1).view(torch.uint8).numpy()
    return _rebuild_tensor, (pickle.PickleBuffer(raw), dtype, shape)


def _rebuild_tensor(buf, dtype: str, shape: Tuple[int, ...]):
    """A CPU tensor of ``dtype`` and ``shape`` that owns a copy of ``buf``."""
    import torch

    dt = getattr(torch, dtype)
    mv = memoryview(buf).cast("B")
    if mv.nbytes == 0:
        return torch.empty(shape, dtype=dt)
    flat = torch.frombuffer(bytearray(mv), dtype=torch.uint8)
    return flat.view(dt).reshape(shape)


def _is_tensor(obj: Any) -> bool:
    torch = sys.modules.get("torch")  # never imported here: no tensor without it
    return torch is not None and isinstance(obj, torch.Tensor)


class Pickler(pickle.Pickler):
    """The standard pickler with callables by reference and tensors as raw
    bytes (see the module docstring)."""

    def reducer_override(self, obj):
        if isinstance(obj, (types.FunctionType, type)):
            if obj.__module__ == "builtins":
                return NotImplemented
            return _callable_reduce(obj)
        if _is_tensor(obj):
            return _tensor_reduce(obj)
        return NotImplemented


def pickle_dumps(value: Any, buffer_callback=None) -> bytes:
    """Pickle (protocol 5) through :class:`Pickler`."""
    f = io.BytesIO()
    Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(value)
    return f.getvalue()


# -- the object plane -----------------------------------------------------------


def serialize(value: Any) -> Tuple[bytes, List[memoryview]]:
    """Serialize to (meta, out-of-band buffers)."""
    buffers: List[pickle.PickleBuffer] = []

    def cb(buf: pickle.PickleBuffer):
        raw = buf.raw()
        if raw.nbytes >= _OOB_THRESHOLD:
            buffers.append(buf)
            return False  # out-of-band
        return True  # keep inline

    meta = pickle_dumps(value, buffer_callback=cb)
    return meta, [b.raw() for b in buffers]


def deserialize(meta: bytes, buffers: List[memoryview]) -> Any:
    return pickle.loads(meta, buffers=buffers)


def pack(value: Any) -> bytes:
    """One-shot serialize into a single contiguous byte string."""
    meta, bufs = serialize(value)
    parts = [struct.pack("<IQ", len(meta), len(bufs)), meta]
    for b in bufs:
        parts.append(struct.pack("<Q", b.nbytes))
    for b in bufs:
        parts.append(b.tobytes() if not b.contiguous else b)
    return b"".join(bytes(p) if isinstance(p, memoryview) else p for p in parts)


def packed_size(meta: bytes, bufs: List[memoryview]) -> int:
    return 12 + len(meta) + 8 * len(bufs) + sum(b.nbytes for b in bufs)


def pack_into(meta: bytes, bufs: List[memoryview], dest: memoryview) -> int:
    """Pack directly into a destination buffer (e.g. shared memory). Returns
    bytes written. Array and tensor data is copied exactly once, from user
    memory into the store arena."""
    struct.pack_into("<IQ", dest, 0, len(meta), len(bufs))
    off = 12
    dest[off : off + len(meta)] = meta
    off += len(meta)
    for b in bufs:
        struct.pack_into("<Q", dest, off, b.nbytes)
        off += 8
    for b in bufs:
        n = b.nbytes
        # buffers from serialize() are PickleBuffer.raw() views: 1-d,
        # C-contiguous, uint8; direct slice assignment is a single memcpy.
        dest[off : off + n] = b
        off += n
    return off


def _split(mv: memoryview):
    meta_len, nbuf = struct.unpack_from("<IQ", mv, 0)
    off = 12
    meta = bytes(mv[off : off + meta_len])
    off += meta_len
    sizes = []
    for _ in range(nbuf):
        (n,) = struct.unpack_from("<Q", mv, off)
        sizes.append(n)
        off += 8
    return meta, sizes, off


def unpack(data: memoryview | bytes) -> Any:
    """Deserialize from a packed buffer. When ``data`` is a memoryview over
    shared memory, numpy array buffers alias the store arena (zero-copy
    get); a tensor copies its bytes out."""
    mv = memoryview(data)
    meta, sizes, off = _split(mv)
    bufs = []
    for n in sizes:
        bufs.append(mv[off : off + n])
        off += n
    return deserialize(meta, bufs)


def unpack_with_release(data: memoryview | bytes, release_cb) -> Any:
    """Zero-copy deserialize from a store mapping, calling ``release_cb``
    once no deserialized value aliases the mapping anymore.

    Out-of-band buffers are wrapped in uint8 numpy arrays with GC
    finalizers; arrays reconstructed from them keep the wrapper in their
    ``.base`` chain, so the store pin is released exactly when the last
    aliasing array dies (a tensor copies its bytes out, so it releases its
    wrapper at once)."""
    import weakref

    import numpy as np

    mv = memoryview(data)
    meta, sizes, off = _split(mv)
    if not sizes:
        value = deserialize(meta, [])
        release_cb()
        return value
    remaining = [len(sizes)]

    def _one_dead():
        remaining[0] -= 1
        if remaining[0] == 0:
            release_cb()

    bufs = []
    for n in sizes:
        arr = np.frombuffer(mv[off : off + n], dtype=np.uint8)
        weakref.finalize(arr, _one_dead)
        bufs.append(arr)
        off += n
    return deserialize(meta, bufs)


# -- the control plane ----------------------------------------------------------


def dumps(value: Any) -> bytes:
    """Pickle (protocol 5, through :class:`Pickler`) for control-plane
    payloads: function definitions, specs, shipment descriptors."""
    return pickle_dumps(value)


def loads(raw: bytes) -> Any:
    return pickle.loads(raw)


# -- nested-ref collection ----------------------------------------------------
# While active (per thread), ObjectRef.__reduce__ records every ref being
# serialized, so arg flattening can pin refs nested inside containers for the
# task's flight time (reference: reference_counter.h:44 contained-in refs).

_ref_collector = _threading.local()


@contextlib.contextmanager
def collect_refs():
    """Context manager yielding a list that accumulates each ObjectRef
    serialized (at any nesting depth) within the with-block."""
    prev = getattr(_ref_collector, "refs", None)
    _ref_collector.refs = collected = []
    try:
        yield collected
    finally:
        _ref_collector.refs = prev


def record_serialized_ref(ref) -> None:
    """Called from ObjectRef.__reduce__."""
    refs = getattr(_ref_collector, "refs", None)
    if refs is not None:
        refs.append(ref)
