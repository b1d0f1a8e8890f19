"""ObjectRef: a distributed future.

Role-equivalent of the reference's ObjectRef (includes/object_ref.pxi): wraps
an ObjectID plus the owner's address. The process that created the ref (via
``put`` or task submission) owns the object's metadata and lifetime; when the
last Python reference in the owning process drops, the owner releases the
object (reference: reference_counter.h local-ref accounting via __dealloc__).

A copy of ``ray_tpu/object_ref.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ._internal.ids import ObjectID


class ObjectRef:
    __slots__ = ("id", "owner_address", "_registered", "__weakref__")

    def __init__(
        self,
        object_id: ObjectID,
        owner_address: Optional[Tuple[str, int]] = None,
        *,
        _register: bool = True,
    ):
        self.id = object_id
        self.owner_address = owner_address
        self._registered = False
        if _register:
            from . import _worker_api

            worker = _worker_api.maybe_get_core_worker()
            if worker is not None:
                worker.register_ref(self)
                self._registered = True

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def task_id(self):
        return self.id.task_id()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __del__(self):
        if self._registered:
            try:
                from . import _worker_api
            except Exception:  # noqa: BLE001 - ImportError or TypeError
                return  # interpreter shutdown
            worker = _worker_api.maybe_get_core_worker()
            if worker is not None:
                try:
                    worker.unregister_ref(self)
                except Exception:
                    pass

    def __reduce__(self):
        # Serializing a ref (into task args or object values) makes the
        # receiver a borrower; the owner address travels with the ref. An
        # active arg-flattening collector records the ref so nested refs get
        # pinned for the task's flight (serialization.collect_refs).
        from ._internal import serialization

        serialization.record_serialized_ref(self)
        return (_deserialize_ref, (self.id, self.owner_address))

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        from . import _worker_api

        return _worker_api.get_core_worker().as_future(self)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()


def _deserialize_ref(object_id, owner_address):
    return ObjectRef(object_id, owner_address)


class ObjectRefGenerator:
    """Iterator over a streaming-generator task's yielded objects.

    Role-equivalent of the reference's ObjectRefGenerator
    (_private/object_ref_generator.py:32 backed by TryReadObjectRefStream,
    core_worker.h:306): ``next()`` blocks until the executor reports the
    next yielded item (items stream while the task still runs) and returns
    its ObjectRef; StopIteration at end-of-stream; a mid-stream task error
    raises after the already-yielded items are consumed.
    """

    def __init__(self, task_id):
        self._task_id = task_id

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        from . import _worker_api

        worker = _worker_api.get_core_worker()
        ref = _worker_api.run_on_worker_loop(
            worker.next_stream_item(self._task_id)
        )
        if ref is None:
            raise StopIteration
        return ref

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()})"

    def close(self):
        """Eagerly release the owner's stream bookkeeping (don't wait for
        GC): the next item the executor reports finds no stream state and
        learns the consumer is gone, so the replica-side generator is
        closed instead of producing into the void."""
        from . import _worker_api

        worker = _worker_api.maybe_get_core_worker()
        if worker is None:
            return
        try:
            worker.loop.call_soon_threadsafe(
                worker.drop_stream, self._task_id
            )
        except RuntimeError:
            pass

    def __del__(self):
        # abandoning the generator releases the owner's stream bookkeeping
        # (a failed or half-consumed stream must not pin state forever)
        try:
            from . import _worker_api
        except ImportError:
            return  # interpreter shutdown
        worker = _worker_api.maybe_get_core_worker()
        if worker is None:
            return
        try:
            worker.loop.call_soon_threadsafe(
                worker.drop_stream, self._task_id
            )
        except RuntimeError:
            pass
