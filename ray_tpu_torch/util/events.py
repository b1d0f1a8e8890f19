"""Flight recorder: the port of ray_tpu/util/events.py.

Every process keeps a bounded ring of cheap structured events (admission
blocks, adapter attaches and evictions, ...). Recording is unconditional
(unlike spans, which are trace-gated): one dict append under a lock per
event.

Event names are the taxonomy: every name is an :class:`EventName` constant
declared here, exactly once, the reference's names all, so that the two
packages share one vocabulary.

The reference streams the ring's suffix to its GCS event store from a
background thread. The port's runtime does not push it yet (ROADMAP A item
21), so no thread is started, and :func:`flush_events` / :func:`dump_events` return without
pushing, as the reference does in a process without a core worker.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from . import metrics as _metrics

_lock = threading.Lock()
_events: List[dict] = []
_events_cap = int(os.environ.get("RAY_TPU_EVENTS_CAP", "4096"))

# -- event-name registry -----------------------------------------------------

_registry: Dict[str, "EventName"] = {}
_registry_lock = threading.Lock()


class EventName(str):
    """A registered flight-recorder event name. Constructing one registers
    it process-wide."""

    def __new__(cls, name: str) -> "EventName":
        obj = super().__new__(cls, name)
        with _registry_lock:
            _registry[name] = obj
        return obj


def registered_event_names() -> List[str]:
    """The sorted taxonomy."""
    with _registry_lock:
        return sorted(_registry)


# The taxonomy, the reference's in full (most are recorded by planes the
# port has not reached yet).
REPLICA_STATE = EventName("replica_state")
REPLICA_START = EventName("replica_start")
REPLICA_STOP = EventName("replica_stop")
AUTOSCALE_DECISION = EventName("autoscale_decision")
COLLECTIVE_EPOCH = EventName("collective_epoch")
ADMISSION_BLOCKED = EventName("admission_blocked")
DRAIN_REJECTED = EventName("drain_rejected")
REQUEST_RETRY = EventName("request_retry")
REQUEST_SHED = EventName("request_shed")
ENGINE_ADMISSION_BLOCKED = EventName("engine_admission_blocked")
WORKER_DEATH = EventName("worker_death")
WATCHDOG_STUCK = EventName("watchdog_stuck")
WATCHDOG_RECOVERED = EventName("watchdog_recovered")
NODE_SUSPECT = EventName("node_suspect")
NODE_FENCED = EventName("node_fenced")
NODE_UNFENCED = EventName("node_unfenced")
CIRCUIT_OPEN = EventName("circuit_open")
CIRCUIT_CLOSE = EventName("circuit_close")
PROXY_START = EventName("proxy_start")
PROXY_STOP = EventName("proxy_stop")
PROXY_DRAIN = EventName("proxy_drain")
KV_SHIPPED = EventName("kv_shipped")
KVTIER_EVICT = EventName("kvtier_evict")
ADAPTER_COLD_ATTACH = EventName("adapter_cold_attach")
ADAPTER_EVICT = EventName("adapter_evict")
STRAGGLER_DETECTED = EventName("straggler_detected")
STRAGGLER_RESOLVED = EventName("straggler_resolved")
ALERT_FIRING = EventName("alert_firing")
ALERT_RESOLVED = EventName("alert_resolved")


# -- recording ----------------------------------------------------------------


def record_event(name: str, **fields) -> None:
    """Append one structured event to the ring, dropping the oldest past
    the cap (counted in ``events_dropped_total``). ``fields`` must be
    JSON-serializable, as the reference's travel through an RPC."""
    ev = {"ts": time.time(), "pid": os.getpid(), "name": str(name)}
    ev.update(fields)
    dropped = 0
    with _lock:
        _events.append(ev)
        if len(_events) > _events_cap:
            dropped = len(_events) - _events_cap
            del _events[:dropped]
    if dropped:
        _metrics.record_events_dropped(dropped)


def get_events(name: Optional[str] = None) -> List[dict]:
    with _lock:
        out = list(_events)
    if name is not None:
        out = [e for e in out if e.get("name") == name]
    return out


def clear_events() -> None:
    with _lock:
        _events.clear()


def flush_events() -> None:
    """Push the events recorded since the last flush to the cluster's event
    store: there is none yet, so nothing is pushed."""


def dump_events(reason: str = "") -> None:
    """The graceful-crash path: record a marker, then flush."""
    if reason:
        record_event(WORKER_DEATH, reason=reason, synthetic=False)
    flush_events()
