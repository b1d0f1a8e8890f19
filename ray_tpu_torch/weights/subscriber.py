"""WeightSubscriber: pinned, prefetchable reads from the weight plane. The
port of ray_tpu/weights/subscriber.py.

A subscriber resolves a model version (head by default), pins it in the
registry BEFORE it fetches (a pinned version cannot be tombstoned under an
in-flight read), pulls the chunks from its position in the broadcast tree,
weight-pins the local copies (exempt from eviction and spill), assembles
the tree on the consumer's ``device`` and keeps a staleness gauge (versions
behind head). ``prefetch`` pulls the next head in the background, so a
learner's publish overlaps the runners' previous rollout.

Registry pins are leases (``weights_pin_lease_s``): every get() and
staleness() re-pins the held versions once half the lease has passed, so a
live but idle reader keeps its version while a crashed one stops blocking
GC. The pin state (``_current`` / ``_prefetched``) is guarded by ``_lock``:
a prefetch completes on a background thread, and one that lost the race to
a newer adoption releases its pins rather than parking them.

Where the bytes go: a chunk arrives in this node's arena (one copy per
node), is deserialized into host tensors, and each leaf takes one
host-to-device copy to ``device`` in ``assemble_pytree``, where an int8
leaf is decoded on the device.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Any, Dict, Optional

from .. import _worker_api
from .._internal import transfer
from ..util import metrics
from . import broadcast
from .manifest import Manifest, assemble_pytree, reshard

logger = logging.getLogger(__name__)


class _PinnedVersion:
    __slots__ = ("version", "value", "manifest", "local_pins", "pinned_at")

    def __init__(self, version, value, manifest, local_pins):
        self.version = version
        self.value = value
        self.manifest = manifest
        self.local_pins = local_pins
        self.pinned_at = time.time()


class WeightSubscriber:
    def __init__(
        self,
        name: str,
        reader_id: Optional[str] = None,
        prefer_wait_s: Optional[float] = None,
    ):
        self.name = name
        worker = _worker_api.get_core_worker()
        self.reader_id = reader_id or f"{worker.worker_id.hex()[:8]}-{uuid.uuid4().hex[:6]}"
        self._prefer_wait_s = (
            prefer_wait_s if prefer_wait_s is not None
            else worker.config.weights_prefer_wait_s
        )
        self._pin_lease_s = worker.config.weights_pin_lease_s
        # guards _current / _prefetched: get() and release() on the caller's
        # thread race prefetch(block=False) completing on its own thread
        self._lock = threading.Lock()
        self._current: Optional[_PinnedVersion] = None
        # version -> prefetched (pinned, assembled) result awaiting adoption
        self._prefetched: Dict[int, _PinnedVersion] = {}
        # transfer accounting: chunks pulled and their byte totals; a repeat
        # get() of the pinned version pulls nothing. ``bytes_pulled`` is the
        # logical (raw leaf) total, ``wire_bytes_pulled`` what crossed
        self.chunk_pulls = 0
        self.bytes_pulled = 0
        self.wire_bytes_pulled = 0

    # -- resolution --------------------------------------------------------

    def _gcs_call(self, method: str, *args):
        worker = _worker_api.get_core_worker()
        return _worker_api.run_on_worker_loop(
            worker.client_pool.get(*worker.gcs_address).call(method, *args)
        )

    def head(self) -> Optional[int]:
        return self._gcs_call("weights_head", self.name)

    def staleness(self) -> Optional[int]:
        """Versions behind head (0 = current); also sets the gauge and
        heartbeats this reader's pin leases."""
        head = self.head()
        if head is None:
            return None
        self._heartbeat_pins()
        behind = head - (self._current.version if self._current else 0)
        metrics.set_weights_staleness(self.name, behind)
        return behind

    @property
    def version(self) -> Optional[int]:
        return self._current.version if self._current else None

    @property
    def current_codec(self) -> Optional[str]:
        """The chunk codec of the adopted version ("raw" | "int8"), None
        before the first get()."""
        if self._current is None:
            return None
        return self._current.manifest.codec

    # -- fetch -------------------------------------------------------------

    def get(
        self,
        version: Optional[int] = None,
        device: Any = None,
        timeout: Optional[float] = None,
        fallback_to_head: bool = False,
    ):
        """Return (version, tree) for ``version`` (head when None). The
        version stays pinned, excluded from registry GC and local eviction,
        until a later get() adopts a newer one or release(). ``device``
        places the leaves (a device, or a callable giving the devices for
        the tree: :func:`~.manifest.reshard`; None leaves them on the host).
        ``fallback_to_head`` resolves head when the asked version is gone
        (collected after every other reader moved on): a handle minted at
        publish time holds no pin, and one version of staleness beats
        failing the consumer."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            resolved = self._gcs_call("weights_get", self.name, version)
            if resolved is not None:
                break
            if version is not None:
                # an explicit version the registry no longer lists while a
                # head exists is gone for good: fall back or fail now
                head = self._gcs_call("weights_get", self.name, None)
                if head is not None:
                    if fallback_to_head:
                        logger.warning(
                            "weights %s: v%d no longer resolvable; "
                            "falling back to head v%d",
                            self.name, version, head["version"],
                        )
                        resolved = head
                        break
                    raise KeyError(f"weights {self.name!r} v{version} was garbage-collected")
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"weights {self.name!r}"
                    + (f" v{version}" if version else "")
                    + " not resolvable"
                )
            if deadline is None:
                raise KeyError(
                    f"weights {self.name!r}"
                    + (f" v{version}" if version else "")
                    + " not found"
                )
            time.sleep(0.05)
        v = resolved["version"]
        head_version = resolved.get("head", v)
        with self._lock:
            current = self._current
            if current is not None and current.version == v:
                pinned = current
            else:
                pinned = self._prefetched.pop(v, None)
        if pinned is current and current is not None:
            self._heartbeat_pins()
            metrics.set_weights_staleness(self.name, head_version - v)
            return v, reshard(current.value, device)
        if pinned is None:
            pinned = self._fetch_version(v, resolved["manifest"], device)
            self._adopt(pinned)
            metrics.set_weights_staleness(self.name, head_version - v)
            return v, pinned.value
        self._adopt(pinned)
        metrics.set_weights_staleness(self.name, head_version - v)
        return v, reshard(pinned.value, device)

    def _fetch_version(self, version: int, manifest_blob: bytes,
                       device: Any = None) -> _PinnedVersion:
        worker = _worker_api.get_core_worker()
        t0 = time.perf_counter()
        # pin FIRST: a pinned version cannot be tombstoned mid-fetch
        if not self._gcs_call("weights_pin", self.name, version, self.reader_id):
            raise KeyError(f"weights {self.name!r} v{version} was garbage-collected")
        try:
            manifest = Manifest.from_blob(manifest_blob)
            plan = self._gcs_call("weights_plan", self.name, tuple(worker.raylet_address))
            metrics.set_weights_tree_depth(self.name, plan["depth"])
            # parent None = the seed position: pull from the publisher's node
            # through the owner's location table
            chunk_values = _worker_api.run_on_worker_loop(
                broadcast.fetch_version_chunks(
                    worker, self.name, manifest.chunks, plan["parent"],
                    self._prefer_wait_s,
                ),
                timeout=None,
            )
            local_pins = _worker_api.run_on_worker_loop(
                transfer.pin_chunks(worker, [c.object_id for c in manifest.chunks])
            )
            # each host leaf takes one copy to its device, where an int8 leaf
            # is decoded: no dense staging copy of a quantized version
            if callable(device):
                value = reshard(assemble_pytree(manifest.treedef_blob, chunk_values),
                                device)
            else:
                value = assemble_pytree(manifest.treedef_blob, chunk_values, device)
            del chunk_values
            wire_bytes = sum(c.size for c in manifest.chunks)
            self.chunk_pulls += len(manifest.chunks)
            self.bytes_pulled += manifest.total_bytes
            self.wire_bytes_pulled += wire_bytes
            metrics.record_weights_fetch(
                self.name, time.perf_counter() - t0, manifest.total_bytes,
                wire_nbytes=wire_bytes,
            )
            return _PinnedVersion(version, value, manifest, local_pins)
        except BaseException:
            # never leak a registry pin on a failed fetch; the fetch's own
            # error is the one that propagates
            try:
                self._gcs_call("weights_unpin", self.name, version, self.reader_id)
            except Exception:  # noqa: BLE001
                logger.exception("weights %s: unpin of v%d after a failed fetch",
                                 self.name, version)
            raise

    # -- prefetch ----------------------------------------------------------

    def prefetch(self, block: bool = True) -> Optional[int]:
        """Pull the current head into the local store (pinned and assembled
        on the host) without adopting it: the next get() returns it at once,
        moved to its ``device``. Returns the prefetched version, or None if
        already current. ``block=False`` fetches on a background thread."""
        resolved = self._gcs_call("weights_get", self.name, None)
        if resolved is None:
            return None
        v = resolved["version"]
        with self._lock:
            if ((self._current is not None and self._current.version >= v)
                    or v in self._prefetched):
                return None
        if block:
            self._offer_prefetched(v, self._fetch_version(v, resolved["manifest"]))
            return v

        def _bg():
            try:
                result = self._fetch_version(v, resolved["manifest"])
            except Exception:
                logger.exception("weights %s: prefetch of v%d failed", self.name, v)
                return
            self._offer_prefetched(v, result)

        threading.Thread(target=_bg, daemon=True, name="weights-prefetch").start()
        return v

    def _offer_prefetched(self, version: int, pinned: _PinnedVersion) -> bool:
        """Park a fetched version for the next get(), unless an adoption won
        the race (get() already moved to this version or a newer one, or a
        duplicate prefetch landed first): then the result is released at
        once, since an orphan entry would hold pins nothing pops."""
        with self._lock:
            stale = ((self._current is not None and self._current.version >= version)
                     or version in self._prefetched)
            if not stale:
                self._prefetched[version] = pinned
        if stale:
            self._release_pinned(pinned)
            return False
        return True

    # -- pin lifecycle -----------------------------------------------------

    def _heartbeat_pins(self):
        """Re-pin held versions once half the lease has passed, so that the
        registry's lease reaper fires only on readers that died."""
        if not self._pin_lease_s or self._pin_lease_s <= 0:
            return
        now = time.time()
        with self._lock:
            due = [p for p in [self._current, *self._prefetched.values()]
                   if p is not None and now - p.pinned_at > self._pin_lease_s / 2]
        for pinned in due:
            if self._gcs_call("weights_pin", self.name, pinned.version, self.reader_id):
                pinned.pinned_at = now

    def _adopt(self, pinned: _PinnedVersion):
        with self._lock:
            prev, self._current = self._current, pinned
            # drop prefetched versions the adopted one supersedes
            superseded = [self._prefetched.pop(v)
                          for v in [v for v in self._prefetched if v <= pinned.version]]
        for old in ([prev] if prev is not None else []) + superseded:
            # two threads adopting one version share one registry pin (keyed
            # by reader_id): releasing the loser's must not strip it
            self._release_pinned(old, skip_registry=old.version == pinned.version)

    def _release_pinned(self, pinned: _PinnedVersion, skip_registry=False):
        """Drop one held version's registry pin and local store pins, and
        its value: the subscriber holds no copy of a version it released."""
        if not skip_registry:
            self._gcs_call("weights_unpin", self.name, pinned.version, self.reader_id)
        worker = _worker_api.maybe_get_core_worker()
        if worker is not None and pinned.local_pins:
            _worker_api.run_on_worker_loop(transfer.unpin_chunks(worker, pinned.local_pins))
        pinned.value = None

    def release(self):
        """Unpin everything this subscriber holds (registry and local
        store)."""
        with self._lock:
            to_release = []
            if self._current is not None:
                to_release.append(self._current)
                self._current = None
            for v in list(self._prefetched):
                to_release.append(self._prefetched.pop(v))
        for pinned in to_release:
            self._release_pinned(pinned)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
