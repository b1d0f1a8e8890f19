"""Serve configuration dataclasses: the port of ray_tpu/serve/config.py.

``DeploymentConfig``, ``AutoscalingConfig`` (the queue autoscaler's
``desired_replicas``), ``RequestRouterConfig`` (the handles' failover
policy and prefix affinity) and the status records, copied from the
reference. Departure: replicas reserve the card with ``num_gpus`` in
``ray_actor_options`` (a fraction packs several replicas on one card), as
the reference's reserve TPU chips with ``num_tpus``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 10
    target_ongoing_requests: float = 2.0
    # smoothing / stability knobs (reference: autoscaling_policy.py)
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 10.0
    metrics_interval_s: float = 0.5

    def desired_replicas(
        self, total_ongoing: float, current: int
    ) -> int:
        """reference: _calculate_desired_num_replicas
        (serve/_private/autoscaling_policy.py:12) — scale so each replica
        carries ~target_ongoing_requests."""
        if current <= 0:
            return self.min_replicas
        raw = total_ongoing / max(self.target_ongoing_requests, 1e-9)
        desired = int(math.ceil(raw))
        return max(self.min_replicas, min(self.max_replicas, desired))


@dataclass
class RequestRouterConfig:
    """Handle-side failover policy, distributed to every router via the
    routing table (reference: serve/config.py RequestRouterConfig — there
    it picks the router class; here it parameterizes the retry envelope
    around ``handle.remote()``).

    ``max_attempts`` counts total submissions (1 = no failover).
    ``retry_backpressure`` controls whether a BackPressureError shed is
    retried on another replica or surfaced to the caller immediately —
    proxies surface it (they own the 503/Retry-After contract), plain
    handles retry by default.

    ``prefix_affinity_tokens`` > 0 turns on prefix-affinity routing for
    EVERY router of this deployment — proxies included: each request's
    leading prompt tokens hash onto the shared rendezvous ring
    (serve/hash_ring.py), so all ingress processes send a given prefix to
    the same warm replica without a controller round-trip. A handle-level
    ``options(prefix_affinity_tokens=...)`` still overrides per call site.
    """

    max_attempts: int = 3
    backoff_s: float = 0.05
    default_timeout_s: float = 60.0
    retry_backpressure: bool = True
    prefix_affinity_tokens: int = 0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "max_attempts": self.max_attempts,
            "backoff_s": self.backoff_s,
            "default_timeout_s": self.default_timeout_s,
            "retry_backpressure": self.retry_backpressure,
            "prefix_affinity_tokens": self.prefix_affinity_tokens,
        }


@dataclass
class DeploymentConfig:
    name: str = ""
    num_replicas: int = 1
    max_ongoing_requests: int = 100
    # admission control: requests beyond max_ongoing_requests wait on the
    # replica up to this queue depth; past it the replica sheds with a
    # typed BackPressureError instead of letting latency pile up
    # (reference: serve DeploymentConfig.max_queued_requests)
    max_queued_requests: int = 64
    request_router_config: Optional[RequestRouterConfig] = None
    user_config: Optional[Any] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    # SLO-driven closed-loop autoscaling (serve/autoscale.py). Takes
    # precedence over autoscaling_config when both are set: the policy
    # reads TTFT p99 / queue depth / shed deltas from live telemetry
    # instead of the single instantaneous ongoing-requests signal.
    autoscale_policy: Optional[Any] = None
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    route_prefix: Optional[str] = None
    health_check_period_s: float = 2.0
    graceful_shutdown_timeout_s: float = 5.0
    # replicas still STARTING after this are replaced (raise for slow model
    # loads; reference: initial_health_check_timeout_s semantics)
    startup_timeout_s: float = 300.0
    # streaming/ASGI ingress flags; serve.run auto-detects stream (generator
    # __call__) and asgi (@serve.ingress) and marks the app root as ingress
    # so the HTTP proxy knows how to talk to it
    stream: bool = False
    asgi: bool = False
    ingress: bool = False


@dataclass
class ReplicaStatus:
    replica_id: str
    state: str  # STARTING | RUNNING | DRAINING | STOPPING | DEAD
    queue_len: int = 0


@dataclass
class DeploymentStatus:
    name: str
    status: str  # UPDATING | HEALTHY | UNHEALTHY
    replicas: list = field(default_factory=list)
    message: str = ""


@dataclass
class ApplicationStatus:
    name: str
    status: str  # DEPLOYING | RUNNING | DELETING | NOT_STARTED
    deployments: Dict[str, DeploymentStatus] = field(default_factory=dict)
