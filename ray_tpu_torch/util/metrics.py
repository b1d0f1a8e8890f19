"""Metrics: the port of ray_tpu/util/metrics.py's serving families.

Counters, gauges and histograms record into one process registry, with the
reference's names, tags and histogram boundaries, and snapshot into the
reference's dicts, so that its rollups and Prometheus exposition read the
port's payloads and the other way round.

Ported families: the KV cache (prefix hits, computed prefill tokens,
evictions, blocked admissions, block gauges, TTFT by cache outcome and
tier), the KV tier (resolution outcomes, logical and wire bytes moved), the
LLM decode (inter-token latency, speculative proposed / accepted tokens and
acceptance), the adapters (hits, cold attaches and their latency,
evictions, live slots), the step breakdown (``StepBreakdown``, the
``step_time_seconds`` and ``scaling_efficiency_ratio`` gauges) with the
collective and overlap clocks it reads (recorded by every op of
``ray_tpu_torch.collective``, with ``collective_summary`` and
``collective_overlap_summary``, and the abort counter), the flight
recorder's drop counter, device memory, read from the CUDA caching
allocator, and the serve control plane's (retries, sheds, DOA rejections
and drains; TTFT and replica warmup by deployment; the proxies' requests,
inflight and latency; the SLO autoscaler's decisions).

The reference pushes every process's registry to its GCS from a background
thread and renders the cluster's payloads. The port's runtime does not push
it yet (ROADMAP A item 21): :func:`local_payload` returns the payload the pusher builds, from this
process's registry, and the summaries and :func:`render_prometheus` run on
it. No thread is started, so :func:`fetch_metric_payloads` finds no port
payload in the GCS KV. The other families of the reference (rpc, weights,
train fault tolerance, partitions, watchdog) wait for their planes.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}


class Metric:
    def __init__(
        self,
        name: str,
        description: str = "",
        tag_keys: Tuple[str, ...] = (),
    ):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry[name] = self

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _tag_tuple(self, tags: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        merged = {**self._default_tags, **(tags or {})}
        return tuple(merged.get(k, "") for k in self._tag_keys)

    def _snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self._name,
                "type": type(self).__name__.lower(),
                "description": self._description,
                "tag_keys": self._tag_keys,
                "values": {json.dumps(k): v for k, v in self._values.items()},
            }


class _BoundCounter:
    """A counter bound to one tag combination: the tag merge happens once,
    at bind time. Obtain via ``Counter.bind(**tags)``."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Counter", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, value: float = 1.0):
        m = self._metric
        with m._lock:
            m._values[self._key] = m._values.get(self._key, 0.0) + value


class _BoundGauge:
    """See _BoundCounter; obtain via ``Gauge.bind(**tags)``."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Gauge", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def set(self, value: float):
        m = self._metric
        with m._lock:
            m._values[self._key] = float(value)


class _BoundHistogram:
    """See _BoundCounter; obtain via ``Histogram.bind(**tags)``. No
    exemplars: those belong to traced paths."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Histogram", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def observe(self, value: float):
        m = self._metric
        with m._lock:
            counts = m._counts.get(self._key)
            if counts is None:
                counts = m._counts[self._key] = \
                    [0] * (len(m._boundaries) + 1)
            counts[bisect.bisect_left(m._boundaries, value)] += 1
            total = m._sums.get(self._key, 0.0) + value
            m._sums[self._key] = total
            m._values[self._key] = total


class Counter(Metric):
    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        key = self._tag_tuple(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def bind(self, **tags: str) -> _BoundCounter:
        return _BoundCounter(self, self._tag_tuple(tags))


class Gauge(Metric):
    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._tag_tuple(tags)] = float(value)

    def bind(self, **tags: str) -> _BoundGauge:
        return _BoundGauge(self, self._tag_tuple(tags))


class Histogram(Metric):
    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Optional[List[float]] = None,
        tag_keys: Tuple[str, ...] = (),
    ):
        super().__init__(name, description, tag_keys)
        self._boundaries = sorted(boundaries or [0.1, 1, 10, 100, 1000])
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        # per-bucket exemplars: the last trace_id (and its value) observed
        # in each bucket, so that a bad bucket links to a concrete trace
        self._exemplars: Dict[Tuple[str, ...], Dict[int, dict]] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None,
                exemplar: Optional[str] = None):
        key = self._tag_tuple(tags)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self._boundaries) + 1)
            )
            bucket = bisect.bisect_left(self._boundaries, value)
            counts[bucket] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._values[key] = self._sums[key]
            if exemplar:
                self._exemplars.setdefault(key, {})[bucket] = {
                    "trace_id": exemplar, "value": value, "ts": time.time(),
                }

    def bind(self, **tags: str) -> _BoundHistogram:
        return _BoundHistogram(self, self._tag_tuple(tags))

    def _snapshot(self) -> dict:
        snap = super()._snapshot()
        with self._lock:
            snap["boundaries"] = self._boundaries
            snap["counts"] = {
                json.dumps(k): v for k, v in self._counts.items()
            }
            if self._exemplars:
                snap["exemplars"] = {
                    json.dumps(k): dict(v)
                    for k, v in self._exemplars.items()
                }
        return snap


# Each family registers its metrics on first use, as the reference's do, so
# that a payload holds only the families this process recorded.
_families: Dict[str, dict] = {}
_families_lock = threading.Lock()


def _family(key: str, build: Callable[[], dict]) -> dict:
    fam = _families.get(key)
    if fam is None:
        with _families_lock:
            fam = _families.get(key)
            if fam is None:
                fam = _families[key] = build()
    return fam


def _total(metric: Metric) -> float:
    with metric._lock:
        return float(sum(metric._values.values()))


# -- flight-recorder health ---------------------------------------------------


def _ensure_events_dropped() -> Counter:
    return _family("events", lambda: {"dropped": Counter(
        "events_dropped_total",
        "Flight-recorder ring overflows: oldest events dropped "
        "when the cap was hit, truncating the post-mortem window",
    )})["dropped"]


def record_events_dropped(n: float = 1.0):
    """Called from util/events.py when the ring drops its oldest events."""
    _ensure_events_dropped().inc(float(n))


def events_dropped_total() -> float:
    return _total(_ensure_events_dropped())


# -- collective and overlap clocks --------------------------------------------
# Every out-of-graph collective op records bytes and wall latency; the step
# breakdown diffs the latency clock across a step to split compute from
# collective time. The groups of ray_tpu_torch.collective call
# record_collective on every op, and the gradient scheduler calls
# record_collective_overlap on every reduction.

_COLLECTIVE_LATENCY_BOUNDARIES_MS = [
    0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 1000, 5000,
]


def _ensure_collective_metrics() -> dict:
    tags = ("op", "backend", "group")
    return _family("collective", lambda: {
        "latency": Histogram(
            "collective_op_latency_ms",
            "Out-of-graph collective op wall time (ms)",
            boundaries=_COLLECTIVE_LATENCY_BOUNDARIES_MS, tag_keys=tags,
        ),
        "bytes": Counter(
            "collective_bytes_total",
            "Logical bytes moved through collective ops "
            "(operand bytes, pre-codec)",
            tag_keys=tags,
        ),
        "wire_bytes": Counter(
            "collective_wire_bytes_total",
            "Encoded on-the-wire bytes of collective ops "
            "(== logical when transport is full-width)",
            tag_keys=tags,
        ),
        "bandwidth": Gauge(
            "collective_bandwidth_gb_s",
            "Achieved wire bandwidth of the last collective "
            "op (GB/s, encoded bytes / wall time)",
            tag_keys=tags,
        ),
    })


def record_collective(
    op: str, backend: str, group: str, nbytes: int, latency_s: float,
    wire_nbytes: Optional[int] = None,
):
    """One collective op: ``nbytes`` is the logical operand size,
    ``wire_nbytes`` the encoded size when the transport compresses (None:
    wire == logical). The bandwidth gauge is on the wire basis."""
    m = _ensure_collective_metrics()
    tags = {"op": op, "backend": backend, "group": group}
    wire = wire_nbytes if wire_nbytes is not None else nbytes
    m["latency"].observe(latency_s * 1000.0, tags)
    m["bytes"].inc(float(nbytes), tags)
    m["wire_bytes"].inc(float(wire), tags)
    if latency_s > 0:
        m["bandwidth"].set(wire / latency_s / 1e9, tags)


def collective_seconds_total() -> float:
    """Cumulative wall time of this process's collective ops."""
    hist = _ensure_collective_metrics()["latency"]
    with hist._lock:
        return sum(hist._sums.values()) / 1000.0


def collective_summary() -> Dict[str, Dict[str, float]]:
    """This process's collective ops by op name: {count, mean_ms, bytes,
    wire_bytes}, summed over backends and groups."""
    m = _ensure_collective_metrics()
    out: Dict[str, Dict[str, float]] = {}
    hist = m["latency"]
    with hist._lock:
        for key, counts in hist._counts.items():
            total = sum(counts)
            if total:
                entry = out.setdefault(key[0], {"count": 0.0, "sum_ms": 0.0})
                entry["count"] += float(total)
                entry["sum_ms"] += hist._sums.get(key, 0.0)
    for entry in out.values():
        entry["mean_ms"] = entry.pop("sum_ms") / entry["count"]
    for label in ("bytes", "wire_bytes"):
        with m[label]._lock:
            for key, v in m[label]._values.items():
                entry = out.setdefault(key[0], {})
                entry[label] = entry.get(label, 0.0) + v
    return out


def _ensure_overlap_metrics() -> dict:
    return _family("overlap", lambda: {
        "exposed": Counter(
            "collective_exposed_seconds_total",
            "Async collective time the caller actually "
            "blocked on (critical-path cost)",
            tag_keys=("group",),
        ),
        "overlapped": Counter(
            "collective_overlapped_seconds_total",
            "Async collective time hidden under the "
            "caller's compute",
            tag_keys=("group",),
        ),
        "fraction": Gauge(
            "collective_overlap_fraction",
            "Hidden fraction of the last gradient "
            "reduction's collective time (1.0 = fully "
            "overlapped, 0.0 = fully exposed)",
            tag_keys=("group",),
        ),
    })


def record_collective_overlap(group: str, exposed_s: float,
                              overlapped_s: float):
    """One gradient reduction's split of its collective time into exposed
    (the caller waited) and overlapped (it ran under compute)."""
    m = _ensure_overlap_metrics()
    tags = {"group": group}
    exposed_s = max(exposed_s, 0.0)
    overlapped_s = max(overlapped_s, 0.0)
    m["exposed"].inc(exposed_s, tags)
    m["overlapped"].inc(overlapped_s, tags)
    total = exposed_s + overlapped_s
    if total > 0:
        m["fraction"].set(overlapped_s / total, tags)


def collective_exposed_seconds_total() -> float:
    return _total(_ensure_overlap_metrics()["exposed"])


def collective_overlapped_seconds_total() -> float:
    return _total(_ensure_overlap_metrics()["overlapped"])


def collective_overlap_summary() -> Dict[str, Dict[str, float]]:
    """This process's gradient reductions by group: {exposed_s,
    overlapped_s, overlap_fraction}."""
    m = _ensure_overlap_metrics()
    out: Dict[str, Dict[str, float]] = {}
    for label in ("exposed", "overlapped"):
        metric = m[label]
        with metric._lock:
            for key, v in metric._values.items():
                out.setdefault(key[0], {})[f"{label}_s"] = v
    for entry in out.values():
        total = entry.get("exposed_s", 0.0) + entry.get("overlapped_s", 0.0)
        entry["overlap_fraction"] = (
            entry.get("overlapped_s", 0.0) / total if total > 0 else 0.0
        )
    return out


def record_collective_abort(group: str):
    """One collective op refused because its group was aborted."""
    _family("collective_abort", lambda: {"abort": Counter(
        "collective_abort_total",
        "In-flight collective ops aborted by member death or explicit abort",
        tag_keys=("group",),
    )})["abort"].inc(1.0, {"group": group})


# -- step breakdown -----------------------------------------------------------


def _ensure_step_metrics() -> dict:
    return _family("step", lambda: {
        "seconds": Gauge(
            "step_time_seconds",
            "Last train-step wall time by component "
            "(compute | collective | idle | total)",
            tag_keys=("role", "component"),
        ),
        "efficiency": Gauge(
            "scaling_efficiency_ratio",
            "Useful-compute fraction of the last step "
            "(1.0 = linear-scaling ideal: zero collective/idle)",
            tag_keys=("role",),
        ),
    })


def record_step_breakdown(
    role: str, compute_s: float, collective_s: float, idle_s: float,
    exposed_s: Optional[float] = None, overlapped_s: Optional[float] = None,
):
    """``collective_s`` is the full-latency collective clock delta; under
    the overlapped scheduler ``exposed_s`` / ``overlapped_s`` split it into
    critical-path and hidden time."""
    m = _ensure_step_metrics()
    compute_s = max(compute_s, 0.0)
    collective_s = max(collective_s, 0.0)
    idle_s = max(idle_s, 0.0)
    total = compute_s + collective_s + idle_s
    components = [
        ("compute", compute_s),
        ("collective", collective_s),
        ("idle", idle_s),
        ("total", total),
    ]
    if exposed_s is not None:
        components.append(("collective_exposed", max(exposed_s, 0.0)))
    if overlapped_s is not None:
        components.append(("collective_overlapped", max(overlapped_s, 0.0)))
    for component, value in components:
        m["seconds"].set(value, {"role": role, "component": component})
    if total > 0:
        m["efficiency"].set(compute_s / total, {"role": role})


def scaling_efficiency(role: str) -> Optional[float]:
    """Read back the efficiency gauge of ``role``."""
    gauge = _ensure_step_metrics()["efficiency"]
    with gauge._lock:
        return gauge._values.get(gauge._tag_tuple({"role": role}))


class StepBreakdown:
    """Per-step compute / collective / idle split of a training loop.

    ``step()`` wraps one step: collective time is the delta of the process's
    collective clock across the block, compute is the rest of the block, and
    idle is the gap since the previous step ended. ``mark()`` is the
    boundary-only variant for loops that cannot wrap their step body: it
    treats mark-to-mark intervals as steps with unknown idle."""

    def __init__(self, role: str):
        self.role = role
        self._last_end: Optional[float] = None
        self._last_coll: Optional[float] = None
        self._last_exposed: Optional[float] = None
        self._last_overlapped: Optional[float] = None

    @contextmanager
    def step(self):
        start = time.perf_counter()
        coll0 = collective_seconds_total()
        exp0 = collective_exposed_seconds_total()
        ovl0 = collective_overlapped_seconds_total()
        try:
            yield
        finally:
            end = time.perf_counter()
            coll = collective_seconds_total() - coll0
            idle = (
                start - self._last_end if self._last_end is not None else 0.0
            )
            self._last_end = end
            # under the overlapped scheduler only the exposed share of the
            # collective clock left the critical path's compute
            exposed = collective_exposed_seconds_total() - exp0
            overlapped = collective_overlapped_seconds_total() - ovl0
            critical_coll = min(coll, exposed) if overlapped > 0 else coll
            record_step_breakdown(
                self.role, (end - start) - critical_coll, critical_coll,
                idle, exposed_s=exposed, overlapped_s=overlapped,
            )

    def mark(self):
        now = time.perf_counter()
        coll_now = collective_seconds_total()
        exp_now = collective_exposed_seconds_total()
        ovl_now = collective_overlapped_seconds_total()
        if self._last_end is not None:
            total = now - self._last_end
            coll = coll_now - (self._last_coll or 0.0)
            exposed = exp_now - (self._last_exposed or 0.0)
            overlapped = ovl_now - (self._last_overlapped or 0.0)
            critical_coll = min(coll, exposed) if overlapped > 0 else coll
            record_step_breakdown(
                self.role, total - critical_coll, critical_coll, 0.0,
                exposed_s=exposed, overlapped_s=overlapped,
            )
        self._last_end = now
        self._last_coll = coll_now
        self._last_exposed = exp_now
        self._last_overlapped = ovl_now


# -- device memory ------------------------------------------------------------
# The reference's per-device HBM gauges, under the same names so that one
# dashboard reads both packages: "used" is the CUDA caching allocator's
# allocated bytes (XLA's bytes_in_use), "limit" the device's total memory.


def _ensure_device_metrics() -> dict:
    return _family("device", lambda: {
        "used": Gauge(
            "tpu_hbm_used_bytes",
            "Device memory in use (HBM on TPU)",
            tag_keys=("node", "device", "kind"),
        ),
        "limit": Gauge(
            "tpu_hbm_limit_bytes",
            "Device memory capacity (HBM on TPU)",
            tag_keys=("node", "device", "kind"),
        ),
    })


def sample_device_memory() -> Dict[str, Dict[str, float]]:
    """Set the per-device memory gauges of every CUDA device and return
    ``{"cuda:<i>": {used, limit}}``. Like the reference, which reads nothing
    when jax was never imported, it brings no backend into being: ``{}``
    when this process never initialised CUDA."""
    import torch

    if not torch.cuda.is_initialized():
        return {}
    m = _ensure_device_metrics()
    out: Dict[str, Dict[str, float]] = {}
    for i in range(torch.cuda.device_count()):
        used = float(torch.cuda.memory_allocated(i))
        limit = float(torch.cuda.mem_get_info(i)[1])
        dev = f"cuda:{i}"
        tags = {"node": "", "device": dev, "kind": torch.cuda.get_device_name(i)}
        m["used"].set(used, tags)
        m["limit"].set(limit, tags)
        out[dev] = {"used": used, "limit": limit}
    return out


# -- KV cache -----------------------------------------------------------------
# The engine records each admission's hit and computed token counts and its
# TTFT (tagged by cache outcome); the KVCacheManager keeps the block gauges
# and the eviction and backpressure counters current. Every metric carries
# the replica's mesh shape ("tp=1").

_KVCACHE_TTFT_BOUNDARIES_MS = [
    1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000,
]


def _ensure_kvcache_metrics() -> dict:
    return _family("kvcache", lambda: {
        "hit_tokens": Counter(
            "kvcache_prefix_hit_tokens_total",
            "Prompt tokens served from the prefix cache "
            "instead of prefilled",
            tag_keys=("mesh",),
        ),
        "prefill_tokens": Counter(
            "kvcache_prefill_tokens_total",
            "Prompt tokens actually computed at admission",
            tag_keys=("mesh",),
        ),
        "evictions": Counter(
            "kvcache_evictions_total",
            "KV blocks LRU-evicted from the prefix index",
            tag_keys=("mesh",),
        ),
        "blocked": Counter(
            "kvcache_admission_blocked_total",
            "Admissions deferred: block pool exhausted "
            "(backpressure, not OOM)",
            tag_keys=("mesh",),
        ),
        "blocks_in_use": Gauge(
            "kvcache_blocks_in_use",
            "Allocated KV blocks in this engine's pool",
            tag_keys=("mesh",),
        ),
        "blocks_capacity": Gauge(
            "kvcache_blocks_capacity",
            "Total KV blocks in this engine's pool",
            tag_keys=("mesh",),
        ),
        # "tier": where the prefix came from: local (this replica's radix),
        # peer (the cluster KV tier), miss (computed from scratch)
        "ttft": Histogram(
            "kvcache_ttft_ms",
            "Time to first token (ms) by prefix-cache outcome",
            boundaries=_KVCACHE_TTFT_BOUNDARIES_MS,
            tag_keys=("cache", "mesh", "tier"),
        ),
    })


def record_kvcache_prefill(
    hit_tokens: int, computed_tokens: int, mesh: str = "tp=1"
):
    m = _ensure_kvcache_metrics()
    m["hit_tokens"].inc(float(hit_tokens), {"mesh": mesh})
    m["prefill_tokens"].inc(float(computed_tokens), {"mesh": mesh})


def record_kvcache_eviction(n: int = 1, mesh: str = "tp=1"):
    _ensure_kvcache_metrics()["evictions"].inc(float(n), {"mesh": mesh})


def record_kvcache_blocked(mesh: str = "tp=1"):
    _ensure_kvcache_metrics()["blocked"].inc(1.0, {"mesh": mesh})


def set_kvcache_blocks(in_use: int, capacity: int, mesh: str = "tp=1"):
    """The block gauges. (The reference also feeds its pool-occupancy time
    series here; that series waits for the port's telemetry stream.)"""
    m = _ensure_kvcache_metrics()
    m["blocks_in_use"].set(float(in_use), {"mesh": mesh})
    m["blocks_capacity"].set(float(capacity), {"mesh": mesh})


def record_kvcache_ttft(
    seconds: float, hit: bool, mesh: str = "tp=1", tier: str = "local"
):
    _ensure_kvcache_metrics()["ttft"].observe(
        seconds * 1000.0,
        {"cache": "hit" if hit else "miss", "mesh": mesh, "tier": tier},
    )


def kvcache_counters() -> Dict[str, float]:
    """This process's KV-cache counters."""
    m = _ensure_kvcache_metrics()
    return {
        "prefix_hit_tokens": _total(m["hit_tokens"]),
        "prefill_tokens_computed": _total(m["prefill_tokens"]),
        "evictions": _total(m["evictions"]),
        "admission_blocked": _total(m["blocked"]),
    }


def kvcache_summary(payloads: List[dict]) -> Dict[str, object]:
    """KV-cache rollup over payloads: counters and block gauges summed
    across engines (each owns its pool), TTFT count, mean and bucket
    quantiles by hit / miss."""
    out: Dict[str, object] = {
        "prefix_hit_tokens": 0.0,
        "prefill_tokens_computed": 0.0,
        "evictions": 0.0,
        "admission_blocked": 0.0,
        "blocks_in_use": 0.0,
        "blocks_capacity": 0.0,
        "ttft_ms": {},
    }
    simple = {
        "kvcache_prefix_hit_tokens_total": "prefix_hit_tokens",
        "kvcache_prefill_tokens_total": "prefill_tokens_computed",
        "kvcache_evictions_total": "evictions",
        "kvcache_admission_blocked_total": "admission_blocked",
        "kvcache_blocks_in_use": "blocks_in_use",
        "kvcache_blocks_capacity": "blocks_capacity",
    }
    ttft: Dict[str, Dict[str, float]] = out["ttft_ms"]  # type: ignore[assignment]
    ttft_buckets: Dict[str, List[float]] = {}
    ttft_bounds: Dict[str, List[float]] = {}
    for payload in payloads:
        for snap in payload.get("metrics", []):
            name = snap["name"]
            if name in simple:
                out[simple[name]] += float(sum(snap["values"].values()))
            elif name == "kvcache_ttft_ms":
                for tag_json, counts in snap.get("counts", {}).items():
                    tags = dict(zip(snap["tag_keys"], json.loads(tag_json)))
                    cache = tags.get("cache", "?")
                    row = ttft.setdefault(
                        cache, {"count": 0.0, "sum_ms": 0.0}
                    )
                    row["count"] += float(sum(counts))
                    row["sum_ms"] += float(
                        snap["values"].get(tag_json, 0.0)
                    )
                    merged = ttft_buckets.setdefault(cache, [0.0] * len(counts))
                    if len(merged) < len(counts):
                        merged.extend([0.0] * (len(counts) - len(merged)))
                    for i, c in enumerate(counts):
                        merged[i] += c
                    ttft_bounds.setdefault(
                        cache,
                        list(snap.get("boundaries")
                             or _KVCACHE_TTFT_BOUNDARIES_MS),
                    )
    for cache, row in ttft.items():
        if row["count"]:
            row["mean_ms"] = row["sum_ms"] / row["count"]
            counts = ttft_buckets.get(cache)
            if counts:
                bounds = ttft_bounds[cache]
                row["p50_ms"] = quantile_from_buckets(bounds, counts, 0.50)
                row["p99_ms"] = quantile_from_buckets(bounds, counts, 0.99)
    return out


# -- KV tier ------------------------------------------------------------------
# Per-request resolution outcomes (hit = the registry had a deeper prefix
# than the local radix, peer_pull = the blocks arrived and decoded,
# recompute = the tier was consulted but the prefix was prefilled anyway:
# a miss, a lease conflict or a dead holder), and the logical / wire byte
# split, so the int8 shipment codec's compression shows. The per-tier TTFT
# split rides the kvcache histogram's "tier" tag.

_KVTIER_OUTCOMES = ("hit", "peer_pull", "recompute")


def _ensure_kvtier_metrics() -> dict:
    return _family("kvtier", lambda: {
        "hit": Counter(
            "kvtier_hit_total",
            "Tier resolutions that found a registered prefix "
            "deeper than the local radix",
            tag_keys=("model",),
        ),
        "peer_pull": Counter(
            "kvtier_peer_pull_total",
            "Warm prefixes successfully pulled from a peer "
            "replica and adopted",
            tag_keys=("model",),
        ),
        "recompute": Counter(
            "kvtier_recompute_total",
            "Tier consultations that fell back to prefill "
            "(miss, lease conflict, or dead holder)",
            tag_keys=("model",),
        ),
        "transfer_bytes": Counter(
            "kvtier_transfer_bytes_total",
            "KV bytes moved through the tier by kind "
            "(logical = raw leaf bytes, wire = encoded)",
            tag_keys=("model", "kind"),
        ),
    })


def record_kvtier(outcome: str, model: str = ""):
    """One tier resolution outcome: hit | peer_pull | recompute."""
    if outcome not in _KVTIER_OUTCOMES:
        raise ValueError(
            f"kvtier outcome must be one of {_KVTIER_OUTCOMES}, got {outcome!r}"
        )
    _ensure_kvtier_metrics()[outcome].inc(1.0, {"model": model})


def record_kvtier_transfer(logical_nbytes: int, wire_nbytes: int, model: str = ""):
    m = _ensure_kvtier_metrics()
    m["transfer_bytes"].inc(float(logical_nbytes), {"model": model, "kind": "logical"})
    m["transfer_bytes"].inc(float(wire_nbytes), {"model": model, "kind": "wire"})


def kvtier_counters() -> Dict[str, float]:
    """This process's KV-tier counters."""
    m = _ensure_kvtier_metrics()

    def _kind(kind: str) -> float:
        tm = m["transfer_bytes"]
        with tm._lock:
            return float(sum(v for k, v in tm._values.items() if kind in k))

    return {
        "hit": _total(m["hit"]),
        "peer_pull": _total(m["peer_pull"]),
        "recompute": _total(m["recompute"]),
        "transfer_logical_bytes": _kind("logical"),
        "transfer_wire_bytes": _kind("wire"),
    }


def kvtier_summary(payloads: List[dict]) -> Dict[str, object]:
    """KV-tier rollup over payloads: outcome counters and byte totals summed
    across replicas, plus the TTFT split by tier (local | peer | miss) read
    off the kvcache histogram's tier tag."""
    out: Dict[str, object] = {
        "hit": 0.0,
        "peer_pull": 0.0,
        "recompute": 0.0,
        "transfer_bytes": {"logical": 0.0, "wire": 0.0},
        "ttft_ms_by_tier": {},
    }
    simple = {
        "kvtier_hit_total": "hit",
        "kvtier_peer_pull_total": "peer_pull",
        "kvtier_recompute_total": "recompute",
    }
    ttft: Dict[str, Dict[str, float]] = out["ttft_ms_by_tier"]  # type: ignore[assignment]
    ttft_buckets: Dict[str, List[float]] = {}
    ttft_bounds: Dict[str, List[float]] = {}
    xfer: Dict[str, float] = out["transfer_bytes"]  # type: ignore[assignment]
    for payload in payloads:
        for snap in payload.get("metrics", []):
            name = snap["name"]
            if name in simple:
                out[simple[name]] += float(sum(snap["values"].values()))
            elif name == "kvtier_transfer_bytes_total":
                for tag_json, v in snap["values"].items():
                    tags = dict(zip(snap["tag_keys"], json.loads(tag_json)))
                    kind = tags.get("kind", "?")
                    xfer[kind] = xfer.get(kind, 0.0) + float(v)
            elif name == "kvcache_ttft_ms":
                for tag_json, counts in snap.get("counts", {}).items():
                    tags = dict(zip(snap["tag_keys"], json.loads(tag_json)))
                    tier = tags.get("tier", "local")
                    row = ttft.setdefault(tier, {"count": 0.0, "sum_ms": 0.0})
                    row["count"] += float(sum(counts))
                    row["sum_ms"] += float(snap["values"].get(tag_json, 0.0))
                    merged = ttft_buckets.setdefault(tier, [0.0] * len(counts))
                    if len(merged) < len(counts):
                        merged.extend([0.0] * (len(counts) - len(merged)))
                    for i, c in enumerate(counts):
                        merged[i] += c
                    ttft_bounds.setdefault(
                        tier,
                        list(snap.get("boundaries") or _KVCACHE_TTFT_BOUNDARIES_MS),
                    )
    for tier, row in ttft.items():
        if row["count"]:
            row["mean_ms"] = row["sum_ms"] / row["count"]
            counts = ttft_buckets.get(tier)
            if counts:
                bounds = ttft_bounds[tier]
                row["p50_ms"] = quantile_from_buckets(bounds, counts, 0.50)
                row["p99_ms"] = quantile_from_buckets(bounds, counts, 0.99)
    return out


# -- rollups ------------------------------------------------------------------
# Quantiles from histogram buckets: linear interpolation inside the bucket
# that holds the rank, the estimator of Prometheus's histogram_quantile.


def quantile_from_buckets(
    boundaries: List[float], counts: List[float], q: float
) -> Optional[float]:
    """Estimate the q-quantile from non-cumulative histogram buckets.

    Bucket i spans (boundaries[i-1], boundaries[i]]; the first bucket's
    lower edge is 0 (recorded values are non-negative) and the overflow
    bucket clamps to the last boundary. None for an empty histogram."""
    total = float(sum(counts))
    if total <= 0:
        return None
    rank = min(max(q, 0.0), 1.0) * total
    cum = 0.0
    lo = 0.0
    for i, c in enumerate(counts):
        if c and cum + c >= rank:
            if i >= len(boundaries):
                return float(lo)
            hi = float(boundaries[i])
            return lo + (hi - lo) * ((rank - cum) / c)
        cum += c
        if i < len(boundaries):
            lo = float(boundaries[i])
    return float(lo)


def merged_histogram(
    payloads: List[dict],
    name: str,
    tag_filter: Optional[Dict[str, str]] = None,
) -> Optional[dict]:
    """Merge one histogram's buckets across payloads, keeping the series
    whose tags include ``tag_filter``: {boundaries, counts, sum, count}, or
    None if no series matched."""
    boundaries: Optional[List[float]] = None
    merged: Optional[List[float]] = None
    total_sum = 0.0
    for payload in payloads:
        for snap in payload.get("metrics", []):
            if snap.get("name") != name:
                continue
            for tag_json, counts in snap.get("counts", {}).items():
                if tag_filter:
                    tags = dict(
                        zip(snap.get("tag_keys", ()), json.loads(tag_json))
                    )
                    if any(tags.get(k) != v for k, v in tag_filter.items()):
                        continue
                if merged is None:
                    boundaries = list(snap.get("boundaries") or [])
                    merged = [0.0] * len(counts)
                if len(merged) < len(counts):
                    merged.extend([0.0] * (len(counts) - len(merged)))
                for i, c in enumerate(counts):
                    merged[i] += c
                total_sum += float(snap.get("values", {}).get(tag_json, 0.0))
    if merged is None:
        return None
    return {
        "boundaries": boundaries or [],
        "counts": merged,
        "sum": total_sum,
        "count": float(sum(merged)),
    }


def _scaled_quantile(m: dict, q: float, scale: float) -> Optional[float]:
    est = quantile_from_buckets(m["boundaries"], m["counts"], q)
    return None if est is None else est * scale


# -- LLM decode ---------------------------------------------------------------
# Inter-token latency (the cadence a streaming client sees after its first
# token) and the speculative ledger (proposed vs accepted draft tokens).

_SERVE_ITL_BOUNDARIES_S = [
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1, 2.5, 5,
]


def _ensure_llm_metrics() -> dict:
    return _family("llm", lambda: {
        "itl": Histogram(
            "serve_itl_seconds",
            "Inter-token latency: gap between consecutive "
            "emitted tokens of one request (a speculative "
            "step landing n tokens records n observations "
            "of gap/n)",
            boundaries=_SERVE_ITL_BOUNDARIES_S,
            tag_keys=("mesh",),
        ),
        "proposed": Counter(
            "spec_proposed_tokens_total",
            "Draft tokens proposed to the verify pass",
            tag_keys=("mesh",),
        ),
        "accepted": Counter(
            "spec_accepted_tokens_total",
            "Draft tokens the target accepted (excludes the "
            "per-step bonus/correction token)",
            tag_keys=("mesh",),
        ),
        "acceptance": Gauge(
            "spec_acceptance_rate",
            "Lifetime accepted/proposed ratio of this "
            "process's speculative engines",
            tag_keys=("mesh",),
        ),
    })


def record_serve_itl(seconds: float, mesh: str = "tp=1", n: int = 1):
    m = _ensure_llm_metrics()
    for _ in range(max(int(n), 1)):
        m["itl"].observe(seconds, {"mesh": mesh})


def record_spec_tokens(proposed: int, accepted: int, mesh: str = "tp=1"):
    m = _ensure_llm_metrics()
    m["proposed"].inc(float(proposed), {"mesh": mesh})
    m["accepted"].inc(float(accepted), {"mesh": mesh})
    total_p = _total(m["proposed"])
    total_a = _total(m["accepted"])
    if total_p > 0:
        m["acceptance"].set(total_a / total_p, {"mesh": mesh})


def llm_counters() -> Dict[str, float]:
    """This process's speculative counters and ITL observation count."""
    m = _ensure_llm_metrics()
    itl = m["itl"]
    with itl._lock:
        observations = float(sum(sum(c) for c in itl._counts.values()))
    return {
        "spec_proposed_tokens": _total(m["proposed"]),
        "spec_accepted_tokens": _total(m["accepted"]),
        "itl_observations": observations,
    }


def llm_summary(payloads: List[dict]) -> Dict[str, object]:
    """Rollup: speculative acceptance and ITL percentiles (ms)."""
    out: Dict[str, object] = {
        "spec_proposed_tokens": 0.0,
        "spec_accepted_tokens": 0.0,
        "spec_acceptance_rate": None,
        "itl_ms": None,
    }
    simple = {
        "spec_proposed_tokens_total": "spec_proposed_tokens",
        "spec_accepted_tokens_total": "spec_accepted_tokens",
    }
    for payload in payloads:
        for snap in payload.get("metrics", []):
            name = snap.get("name")
            if name in simple:
                out[simple[name]] += float(sum(snap["values"].values()))
    if out["spec_proposed_tokens"]:
        out["spec_acceptance_rate"] = (
            out["spec_accepted_tokens"] / out["spec_proposed_tokens"]
        )
    m = merged_histogram(payloads, "serve_itl_seconds")
    if m and m["count"]:
        out["itl_ms"] = {
            "count": m["count"],
            "mean": m["sum"] / m["count"] * 1000.0,
            "p50": _scaled_quantile(m, 0.50, 1000.0),
            "p99": _scaled_quantile(m, 0.99, 1000.0),
        }
    return out


# -- adapters -----------------------------------------------------------------
# The AdapterStore's hits, cold attaches (and their latency), evictions and
# live slots: thrashing shows as evictions and a cold-attach tail.

_ADAPTER_ATTACH_BOUNDARIES_S = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
]


def _ensure_adapter_metrics() -> dict:
    return _family("adapter", lambda: {
        "hits": Counter(
            "adapter_hit_total",
            "Adapter lease acquisitions served by a resident "
            "slot (no weight-plane pull)",
            tag_keys=("mesh",),
        ),
        "cold": Counter(
            "adapter_cold_attach_total",
            "Adapter lease acquisitions that pulled and wrote "
            "the adapter into a slot",
            tag_keys=("mesh",),
        ),
        "evict": Counter(
            "adapter_evict_total",
            "Idle adapters evicted from their slot (LRU) to "
            "make room for a cold attach",
            tag_keys=("mesh",),
        ),
        "live": Gauge(
            "adapter_slots_live",
            "Adapters currently resident in this process's "
            "slot banks (pinned + idle)",
            tag_keys=("mesh",),
        ),
        "attach": Histogram(
            "adapter_cold_attach_seconds",
            "Cold-attach latency: source fetch + normalize + "
            "slot write, the TTFT tax of an adapter's first "
            "request on a replica",
            boundaries=_ADAPTER_ATTACH_BOUNDARIES_S,
            tag_keys=("mesh",),
        ),
    })


def record_adapter_hit(mesh: str = "tp=1"):
    _ensure_adapter_metrics()["hits"].inc(1.0, {"mesh": mesh})


def record_adapter_cold_attach(seconds: float, mesh: str = "tp=1"):
    m = _ensure_adapter_metrics()
    m["cold"].inc(1.0, {"mesh": mesh})
    m["attach"].observe(seconds, {"mesh": mesh})


def record_adapter_evict(mesh: str = "tp=1"):
    _ensure_adapter_metrics()["evict"].inc(1.0, {"mesh": mesh})


def set_adapter_slots_live(n: int, mesh: str = "tp=1"):
    _ensure_adapter_metrics()["live"].set(float(n), {"mesh": mesh})


def adapter_counters() -> Dict[str, float]:
    """This process's adapter counters."""
    m = _ensure_adapter_metrics()
    return {
        "adapter_hits": _total(m["hits"]),
        "adapter_cold_attaches": _total(m["cold"]),
        "adapter_evictions": _total(m["evict"]),
    }


def adapter_summary(payloads: List[dict]) -> Dict[str, object]:
    """Rollup: hit rate and cold-attach latency percentiles (ms)."""
    out: Dict[str, object] = {
        "hits": 0.0,
        "cold_attaches": 0.0,
        "evictions": 0.0,
        "slots_live": 0.0,
        "hit_rate": None,
        "cold_attach_ms": None,
    }
    simple = {
        "adapter_hit_total": "hits",
        "adapter_cold_attach_total": "cold_attaches",
        "adapter_evict_total": "evictions",
        "adapter_slots_live": "slots_live",
    }
    for payload in payloads:
        for snap in payload.get("metrics", []):
            name = snap.get("name")
            if name in simple:
                out[simple[name]] += float(sum(snap["values"].values()))
    acquired = out["hits"] + out["cold_attaches"]
    if acquired:
        out["hit_rate"] = out["hits"] / acquired
    m = merged_histogram(payloads, "adapter_cold_attach_seconds")
    if m and m["count"]:
        out["cold_attach_ms"] = {
            "count": m["count"],
            "mean": m["sum"] / m["count"] * 1000.0,
            "p50": _scaled_quantile(m, 0.50, 1000.0),
            "p99": _scaled_quantile(m, 0.99, 1000.0),
        }
    return out


# -- payload and exposition ---------------------------------------------------


def local_payload() -> dict:
    """The payload the reference's pusher sends for this process: device
    memory sampled first (only where CUDA is already in use), then a
    snapshot of every registered metric. There is no worker, so the
    identity fields are empty and gauges render without a worker label."""
    sample_device_memory()
    with _registry_lock:
        snaps = [m._snapshot() for m in _registry.values()]
    return {
        "worker_id": "",
        "node_id": "",
        "pid": os.getpid(),
        "ts": time.time(),
        "metrics": snaps,
    }


def render_prometheus(payloads: List[dict]) -> str:
    """Payloads in Prometheus exposition format. Counters and histograms
    with the same (name, labels) across workers are summed into one series;
    gauges are per-worker facts, so each worker's gauge is its own series
    with a ``worker`` label. Histograms render cumulative
    ``_bucket``/``_count``/``_sum`` series."""
    # merged[name] = {"snap": first snapshot, "values": {tag_json: sum},
    #                 "counts": {tag_json: [bucket sums]},
    #                 "series": {(worker, tag_json): value}}  (gauges only)
    merged: Dict[str, dict] = {}
    for payload in payloads:
        worker_tag = str(payload.get("worker_id", ""))[:12]
        for snap in payload.get("metrics", []):
            name = snap["name"]
            m = merged.setdefault(
                name, {"snap": snap, "values": {}, "counts": {},
                       "series": {}}
            )
            if snap["type"] == "gauge":
                for tag_json, value in snap["values"].items():
                    m["series"][(worker_tag, tag_json)] = value
                continue
            for tag_json, value in snap["values"].items():
                m["values"][tag_json] = m["values"].get(tag_json, 0.0) + value
            for tag_json, counts in snap.get("counts", {}).items():
                cur = m["counts"].get(tag_json)
                if cur is None:
                    m["counts"][tag_json] = list(counts)
                else:
                    m["counts"][tag_json] = [
                        a + b for a, b in zip(cur, counts)
                    ]
    lines: List[str] = []
    for name, m in merged.items():
        snap = m["snap"]
        kind = {"counter": "counter", "gauge": "gauge"}.get(
            snap["type"], "histogram"
        )
        lines.append(f"# HELP {name} {snap['description']}")
        lines.append(f"# TYPE {name} {kind}")
        if kind == "gauge":
            for (worker_tag, tag_json), value in m["series"].items():
                label_pairs = [
                    (k, v)
                    for k, v in zip(snap["tag_keys"], json.loads(tag_json))
                    if v
                ]
                if worker_tag:
                    label_pairs.append(("worker", worker_tag))
                lines.append(_sample(name, label_pairs, value))
            continue
        for tag_json in m["values"]:
            label_pairs = [
                (k, v)
                for k, v in zip(snap["tag_keys"], json.loads(tag_json))
                if v
            ]
            if kind == "histogram":
                counts = m["counts"].get(tag_json, [])
                bounds = snap.get("boundaries", [])
                cum = 0
                for bound, c in zip(bounds, counts):
                    cum += c
                    lines.append(
                        _sample(
                            f"{name}_bucket",
                            label_pairs + [("le", str(bound))],
                            cum,
                        )
                    )
                cum += counts[len(bounds)] if len(counts) > len(bounds) else 0
                lines.append(
                    _sample(
                        f"{name}_bucket", label_pairs + [("le", "+Inf")], cum
                    )
                )
                lines.append(_sample(f"{name}_count", label_pairs, cum))
                lines.append(
                    _sample(f"{name}_sum", label_pairs, m["values"][tag_json])
                )
            else:
                lines.append(
                    _sample(name, label_pairs, m["values"][tag_json])
                )
    return "\n".join(lines) + "\n"


def _escape_label_value(value) -> str:
    """Exposition escaping for label values: backslash, double quote and
    newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _sample(name: str, label_pairs, value) -> str:
    labels = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in label_pairs
    )
    label_str = f"{{{labels}}}" if labels else ""
    return f"{name}{label_str} {value}"


# -- the serve control plane ---------------------------------------------------
# The reference's serve fault-tolerance, serve latency, ingress and
# autoscale families, with its names, tags and boundaries: handle-side
# retries (counted in the calling process), replica-side sheds, DOA
# rejections and drains, per-deployment TTFT and replica warmup, the
# proxies' pre-bound request handles, and the SLO autoscaler's decisions.

_SERVE_DRAIN_BOUNDARIES_S = [
    0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60,
]
_SERVE_TTFT_BOUNDARIES_S = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5,
    10, 30,
]
_SERVE_WARMUP_BOUNDARIES_S = [
    0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120,
]
_INGRESS_LATENCY_BOUNDARIES_MS = [
    0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
]
_AUTOSCALE_DECISION_BOUNDARIES_S = [
    0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300,
]


def _ensure_serve_ft_metrics() -> dict:
    return _family("serve_ft", lambda: {
        "retry": Counter(
            "serve_retry_total",
            "Handle-side failover resubmissions (replica death, drain "
            "race, transport failure, or retried backpressure)",
            tag_keys=("deployment", "reason", "replica"),
        ),
        "shed": Counter(
            "serve_shed_total",
            "Requests shed by replica admission control (queue cap "
            "reached -> BackPressureError)",
            tag_keys=("deployment",),
        ),
        "doa": Counter(
            "serve_doa_total",
            "Dead-on-arrival rejections (request deadline already passed "
            "at admission)",
            tag_keys=("deployment",),
        ),
        "drain": Histogram(
            "serve_drain_seconds",
            "Graceful replica drain duration (stop-routing to last "
            "in-flight request finished)",
            boundaries=_SERVE_DRAIN_BOUNDARIES_S,
            tag_keys=("deployment",),
        ),
    })


def record_serve_retry(deployment: str, reason: str, replica: str = ""):
    """``replica`` is the replica the retry was resubmitted to."""
    _ensure_serve_ft_metrics()["retry"].inc(
        1.0, {"deployment": deployment, "reason": reason, "replica": replica}
    )


def record_serve_shed(deployment: str):
    _ensure_serve_ft_metrics()["shed"].inc(1.0, {"deployment": deployment})


def record_serve_doa(deployment: str):
    _ensure_serve_ft_metrics()["doa"].inc(1.0, {"deployment": deployment})


def record_serve_drain(deployment: str, seconds: float):
    _ensure_serve_ft_metrics()["drain"].observe(seconds, {"deployment": deployment})


def serve_ft_counters() -> Dict[str, float]:
    """Process-local totals across all tag values: retries count in the
    calling process, sheds, DOA and drains in the replica's."""
    m = _ensure_serve_ft_metrics()
    out = {label: _total(m[key])
           for label, key in (("retries", "retry"), ("sheds", "shed"), ("doa", "doa"))}
    drain = m["drain"]
    with drain._lock:
        out["drains"] = float(sum(sum(c) for c in drain._counts.values()))
    return out


def _ensure_serve_latency_metrics() -> dict:
    return _family("serve_latency", lambda: {
        "ttft": Histogram(
            "serve_ttft_seconds",
            "Replica-side time to first output: admission (queue wait "
            "included) to first stream item or unary completion",
            boundaries=_SERVE_TTFT_BOUNDARIES_S,
            tag_keys=("deployment",),
        ),
        "warmup": Histogram(
            "serve_replica_warmup_seconds",
            "Replica cold-start: constructor entry to ready-to-serve "
            "(user init + weight resolution + warmup hook)",
            boundaries=_SERVE_WARMUP_BOUNDARIES_S,
            tag_keys=("deployment",),
        ),
    })


def record_serve_ttft(deployment: str, seconds: float,
                      trace_id: Optional[str] = None):
    """``trace_id`` (a traced request's) becomes the bucket's exemplar."""
    _ensure_serve_latency_metrics()["ttft"].observe(
        seconds, {"deployment": deployment}, exemplar=trace_id
    )


def record_serve_replica_warmup(deployment: str, seconds: float):
    _ensure_serve_latency_metrics()["warmup"].observe(
        seconds, {"deployment": deployment}
    )


def _ensure_ingress_metrics() -> dict:
    return _family("ingress", lambda: {
        "requests": Counter(
            "proxy_requests_total",
            "Requests completed by an ingress proxy, by outcome "
            "(ok/error/shed/timeout/drain)",
            tag_keys=("proxy_id", "outcome"),
        ),
        "inflight": Gauge(
            "proxy_inflight",
            "Requests currently being served by this proxy",
            tag_keys=("proxy_id",),
        ),
        "latency": Histogram(
            "proxy_request_latency_ms",
            "End-to-end proxy latency: request read to response write",
            boundaries=_INGRESS_LATENCY_BOUNDARIES_MS,
            tag_keys=("proxy_id",),
        ),
    })


def ingress_handles(proxy_id: str) -> dict:
    """Pre-bound per-proxy metric handles for the proxy's request loop:
    {ok, error, shed, timeout, drain} counters plus {inflight, latency}."""
    m = _ensure_ingress_metrics()
    req = m["requests"]
    out = {outcome: req.bind(proxy_id=proxy_id, outcome=outcome)
           for outcome in ("ok", "error", "shed", "timeout", "drain")}
    out["inflight"] = m["inflight"].bind(proxy_id=proxy_id)
    out["latency"] = m["latency"].bind(proxy_id=proxy_id)
    return out


def _ensure_autoscale_metrics() -> dict:
    return _family("autoscale", lambda: {
        "up": Counter(
            "autoscale_scale_up_total",
            "SLO-autoscaler scale-up decisions applied",
            tag_keys=("deployment",),
        ),
        "down": Counter(
            "autoscale_scale_down_total",
            "SLO-autoscaler scale-down decisions applied",
            tag_keys=("deployment",),
        ),
        "decision": Histogram(
            "autoscale_decision_seconds",
            "Pressure-onset (or idle-onset) to applied decision wall time",
            boundaries=_AUTOSCALE_DECISION_BOUNDARIES_S,
            tag_keys=("deployment", "direction"),
        ),
    })


def record_autoscale_decision(deployment: str, direction: str, breach_age_s: float):
    m = _ensure_autoscale_metrics()
    m["up" if direction == "up" else "down"].inc(1.0, {"deployment": deployment})
    m["decision"].observe(
        max(breach_age_s, 0.0), {"deployment": deployment, "direction": direction}
    )


def autoscale_counters() -> Dict[str, float]:
    """Process-local totals across deployments."""
    m = _ensure_autoscale_metrics()
    return {"scale_ups": _total(m["up"]), "scale_downs": _total(m["down"])}


def fetch_metric_payloads(gcs_call) -> List[dict]:
    """Every pushed payload under the GCS KV's ``metrics:`` prefix, read
    through ``gcs_call(method, *args)`` and normalized as the reference's
    are. The port's processes push none yet (ROADMAP A item 21), so this
    returns what others have put there: on the port's own cluster, []."""
    from ..runtime.gcs import keys as gcs_keys

    payloads: List[dict] = []
    for key in gcs_call("kv_keys", gcs_keys.METRICS.scan):
        raw = gcs_call("kv_get", key)
        if raw is None:
            continue
        doc = json.loads(raw)
        if isinstance(doc, list):  # a legacy untagged push
            doc = {"worker_id": key.split(":", 1)[-1], "node_id": "", "metrics": doc}
        payloads.append(doc)
    return payloads
