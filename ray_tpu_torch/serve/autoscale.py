"""SLO-driven serve autoscaling: the port of ray_tpu/serve/autoscale.py.

An ``AutoscalePolicy`` names SLO targets (TTFT p99, queue depth per
replica, shed rate) and the serve controller evaluates them every
``interval_s`` against live telemetry: instantaneous queue depth from its
own replica polls, TTFT bucket deltas and shed-counter deltas from the
metric payloads in the GCS KV (the cumulative histograms never decay, so
only windowed deltas reflect current pressure). ``evaluate()`` is a pure
function of (policy, mutable state, signals, now), copied without
departure, as are ``shed_total`` and ``ttft_p99_ms``.

Departure of the plane, not of this module: the port's processes do not
push their metric payloads to the GCS yet (ROADMAP A item 21), so the TTFT
and shed signals read empty, as the reference's do before anything has
pushed, and the queue signal drives the decisions.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import List, Optional

from ..runtime.gcs import keys as gcs_keys
from ..util.metrics import merged_histogram, quantile_from_buckets

AUTOSCALE_LOG_KEY = gcs_keys.SERVE_AUTOSCALE_LOG
LOG_LIMIT = 200


@dataclass
class AutoscalePolicy:
    """SLO targets + damping for one deployment. A target of 0 disables
    that pressure signal; pressure on ANY enabled signal counts."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 1.0
    # pressure signals
    target_ttft_p99_ms: float = 0.0
    target_queue_per_replica: float = 4.0
    max_shed_per_interval: float = 0.0
    # damping: consecutive pressured/idle evaluations required, floors on
    # time between decisions, and per-decision step bounds
    up_hysteresis: int = 1
    down_hysteresis: int = 3
    idle_queue_per_replica: float = 0.5
    cooldown_up_s: float = 3.0
    cooldown_down_s: float = 10.0
    scale_up_step: int = 1
    scale_down_step: int = 1

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AutoscalePolicy":
        return cls(**d)


@dataclass
class AutoscaleSignals:
    """One evaluation's inputs, also embedded in the decision event log so
    every transition is explainable after the fact."""

    queue_depth: float = 0.0
    queue_per_replica: float = 0.0
    shed_delta: float = 0.0
    ttft_p99_ms: Optional[float] = None
    running: int = 0
    starting: int = 0
    target: int = 0

    def as_dict(self) -> dict:
        return asdict(self)


@dataclass
class AutoscaleState:
    """Mutable per-deployment evaluation state held by the controller."""

    last_eval_ts: float = 0.0
    pressured_evals: int = 0
    idle_evals: int = 0
    breach_started_ts: float = 0.0
    idle_started_ts: float = 0.0
    last_up_ts: float = 0.0
    last_down_ts: float = 0.0
    # delta baselines for the cumulative push-plane series
    last_shed_total: float = 0.0
    last_ttft_counts: Optional[List[float]] = None
    last_ttft_source: str = ""


@dataclass
class AutoscaleDecision:
    direction: str  # "up" | "down"
    from_replicas: int
    to_replicas: int
    reason: str
    breach_age_s: float = 0.0


def evaluate(
    policy: AutoscalePolicy,
    st: AutoscaleState,
    sig: AutoscaleSignals,
    now: float,
) -> Optional[AutoscaleDecision]:
    """One tick of the policy state machine; mutates ``st``, returns the
    decision to apply (already cooldown/step/bound-checked) or None."""
    reasons = []
    if (
        policy.target_queue_per_replica > 0
        and sig.queue_per_replica > policy.target_queue_per_replica
    ):
        reasons.append(
            f"queue/replica {sig.queue_per_replica:.1f} > "
            f"{policy.target_queue_per_replica:g}"
        )
    if sig.shed_delta > policy.max_shed_per_interval:
        reasons.append(
            f"sheds {sig.shed_delta:.0f} > {policy.max_shed_per_interval:g}"
        )
    if (
        policy.target_ttft_p99_ms > 0
        and sig.ttft_p99_ms is not None
        and sig.ttft_p99_ms > policy.target_ttft_p99_ms
    ):
        reasons.append(
            f"ttft_p99 {sig.ttft_p99_ms:.0f}ms > "
            f"{policy.target_ttft_p99_ms:g}ms"
        )

    pressured = bool(reasons)
    idle = (
        not pressured
        and sig.queue_per_replica <= policy.idle_queue_per_replica
        and sig.shed_delta == 0
    )
    if pressured:
        if st.pressured_evals == 0:
            st.breach_started_ts = now
        st.pressured_evals += 1
        st.idle_evals = 0
    elif idle:
        if st.idle_evals == 0:
            st.idle_started_ts = now
        st.idle_evals += 1
        st.pressured_evals = 0
    else:
        st.pressured_evals = 0
        st.idle_evals = 0

    if (
        pressured
        and st.pressured_evals >= policy.up_hysteresis
        and sig.target < policy.max_replicas
        and sig.starting == 0  # let in-flight scale-ups land first
        and now - st.last_up_ts >= policy.cooldown_up_s
    ):
        to = min(
            policy.max_replicas, sig.target + max(1, policy.scale_up_step)
        )
        st.pressured_evals = 0
        st.last_up_ts = now
        return AutoscaleDecision(
            "up", sig.target, to, "; ".join(reasons),
            now - st.breach_started_ts,
        )

    if (
        idle
        and st.idle_evals >= policy.down_hysteresis
        and sig.target > policy.min_replicas
        and now - max(st.last_up_ts, st.last_down_ts)
        >= policy.cooldown_down_s
    ):
        to = max(
            policy.min_replicas, sig.target - max(1, policy.scale_down_step)
        )
        st.idle_evals = 0
        st.last_down_ts = now
        return AutoscaleDecision(
            "down",
            sig.target,
            to,
            f"idle: queue/replica {sig.queue_per_replica:.2f} <= "
            f"{policy.idle_queue_per_replica:g}",
            now - st.idle_started_ts,
        )
    return None


# ---------------------------------------------------------------------------
# Push-plane signal extraction. Counters and histogram buckets are
# cumulative since process start, so the controller keeps per-deployment
# baselines in AutoscaleState and reads windowed deltas.
# ---------------------------------------------------------------------------


def shed_total(payloads: List[dict], deployment: str) -> float:
    """Cumulative serve_shed_total across the cluster for one deployment."""
    import json as _json

    total = 0.0
    for payload in payloads:
        for snap in payload.get("metrics", []):
            if snap.get("name") != "serve_shed_total":
                continue
            for tag_json, value in snap.get("values", {}).items():
                tags = dict(
                    zip(snap.get("tag_keys", ()), _json.loads(tag_json))
                )
                if tags.get("deployment") == deployment:
                    total += value
    return total


def ttft_p99_ms(
    payloads: List[dict], deployment: str, st: AutoscaleState
) -> Optional[float]:
    """TTFT p99 over the window since the last evaluation, from merged
    bucket deltas. Prefers the deployment-tagged serve_ttft_seconds
    histogram; falls back to the engine-side kvcache_ttft_ms buckets when
    the deployment has recorded nothing (e.g. pre-existing engines).
    Returns None when no new samples landed in the window."""
    source = "serve"
    scale = 1000.0
    m = merged_histogram(
        payloads, "serve_ttft_seconds", {"deployment": deployment}
    )
    if m is None or not m["count"]:
        source = "kvcache"
        scale = 1.0
        m = merged_histogram(payloads, "kvcache_ttft_ms")
    if m is None:
        st.last_ttft_counts = None
        st.last_ttft_source = ""
        return None
    counts = m["counts"]
    prev = st.last_ttft_counts
    if (
        st.last_ttft_source == source
        and prev is not None
        and len(prev) == len(counts)
    ):
        window = [max(0.0, a - b) for a, b in zip(counts, prev)]
    else:
        window = list(counts)
    st.last_ttft_counts = list(counts)
    st.last_ttft_source = source
    est = quantile_from_buckets(m["boundaries"], window, 0.99)
    return None if est is None else est * scale
