"""Framework configuration flags.

Equivalent of the reference's RAY_CONFIG system (src/ray/common/ray_config_def.h:
~232 entries overridable via RAY_<name> env vars or a _system_config JSON passed
to every process). Here: a typed registry of defaults, overridable by
``RAY_TPU_<NAME>`` environment variables or a dict handed to ``init``.

A copy of ``ray_tpu/_internal/config.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field, fields
from typing import Any


def _env(name: str, default, typ):
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes")
    return typ(raw)


@dataclass
class Config:
    # --- object plane ---
    # Results at or below this size are returned inline in the task reply and
    # held in the owner's in-process memory store (reference:
    # ray_config_def.h:198 max_direct_call_object_size = 100KB).
    max_direct_call_object_size: int = 100 * 1024
    # Default shared-memory object store size per node (bytes).
    object_store_memory: int = 512 * 1024 * 1024
    # Chunk size for node-to-node object transfer.
    object_transfer_chunk_size: int = 4 * 1024 * 1024
    # Native (C++ TCP) transfer plane for node-to-node pulls. False forces
    # the python chunked-RPC path (deterministic transfer accounting; the
    # weight-plane broadcast tests rely on it).
    object_transfer_native_enabled: bool = True

    # --- weight plane (ray_tpu.weights) ---
    # Target size of one broadcast chunk: a published pytree's leaves are
    # greedily grouped into store objects of at most this many bytes (one
    # oversized leaf still becomes a single chunk — arrays never split).
    weights_chunk_size: int = 8 * 1024 * 1024
    # How long a subscriber waits for its broadcast-tree parent to hold a
    # chunk before falling back to pulling from any holder. The fallback
    # preserves liveness when a parent node dies mid-broadcast at the cost
    # of the O(1)-publisher-upload property for that chunk.
    weights_prefer_wait_s: float = 10.0
    # Registry pin-lease lifetime: a version pin not refreshed within this
    # window is reaped during GC, so a crashed/restarted reader (which pins
    # again under a fresh reader_id) cannot block tombstoning forever.
    # Subscribers heartbeat their pins at half this interval on get()/
    # staleness(); 0 disables expiry.
    weights_pin_lease_s: float = 600.0

    # --- KV prefix tier (ray_tpu.kvtier) ---
    # Cap on registered prefix entries cluster-wide; LRU unleased entries
    # past the cap are evicted and their holders notified (collect drain)
    # so pinned shipment chunks don't accrete host RAM forever.
    kvtier_max_entries: int = 4096
    # Pull-lease lifetime: a resolve-side lease not released within this
    # window is reaped, so a crashed puller cannot block eviction.
    kvtier_lease_s: float = 60.0

    # --- scheduling ---
    # Hybrid policy: prefer local node until utilization exceeds this, then
    # spread over top-k remote candidates (reference: hybrid_scheduling_policy.h).
    scheduler_spread_threshold: float = 0.5
    scheduler_top_k_fraction: float = 0.2
    # Max times a lease request is spilled back before failing.
    max_lease_spillback: int = 32
    # Worker pool
    prestart_workers: int = 0
    max_workers_per_node: int = 64
    idle_worker_kill_s: float = 300.0

    # --- OOM defense (reference: memory_monitor_refresh_ms,
    # memory_usage_threshold in ray_config_def.h) ---
    # 0 disables the monitor.
    memory_monitor_refresh_s: float = 1.0
    memory_usage_threshold: float = 0.95
    # kill policy: "group_by_owner" | "retriable_lifo"
    worker_killing_policy: str = "group_by_owner"
    # minimum spacing between OOM kills: reclaim after a SIGKILL lags, and
    # killing a worker per tick would drain the node before pressure clears
    oom_kill_cooldown_s: float = 5.0

    # --- fault tolerance ---
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 10.0
    # --- partition tolerance ---
    # A node whose resource reports stop arriving is actively probed
    # (raylet ping) once its report age exceeds this; a failed probe marks
    # it SUSPECT (serve stops routing new replicas there) while the full
    # health_check_timeout_s window still governs DEAD.
    suspect_after_s: float = 3.0
    # A raylet that hasn't completed a successful GCS report for this long
    # self-fences: refuses new leases, replicas on the node reject work with
    # NodeFencedError, collectives abort — preventing split-brain while the
    # GCS re-schedules elsewhere. Unfences on the next successful report.
    fence_after_s: float = 5.0
    # How often every process re-reads the cluster chaos-mesh spec
    # (CHAOS_NET_SPEC key) from the GCS.
    chaos_poll_period_s: float = 1.0
    # Per-link circuit breaker: consecutive transport failures before the
    # circuit opens, and how long it stays open before a half-open probe.
    rpc_breaker_threshold: int = 5
    rpc_breaker_cooldown_s: float = 2.0
    # Owner-side liveness probe of registered borrowers while a free is
    # deferred on them (reference: WaitForRefRemoved long-poll,
    # reference_counter.h:44 — polled here so a crashed borrower cannot pin
    # an object forever).
    borrower_probe_interval_s: float = 10.0
    task_retry_delay_s: float = 0.05
    actor_restart_delay_s: float = 0.1
    # Durable GCS metadata (reference: RedisStoreClient,
    # redis_store_client.h:126). Empty = in-memory tables; a path selects the
    # sqlite WAL backend so actors/PGs/KV/jobs survive a GCS restart.
    gcs_storage_path: str = ""
    # External spill tier (reference: _private/external_storage.py:399):
    # empty = node-local disk; an fsspec URI prefix ("memory://spill",
    # "gs://bucket/cluster") sends spilled primary copies to that store.
    spill_storage_uri: str = ""

    # --- worker-lease reuse (reference: worker_lease_timeout_milliseconds +
    # lease reuse in normal_task_submitter.h) ---
    # Owners keep a granted worker lease warm per scheduling class and push
    # subsequent same-shape tasks straight to the leased worker (1 RPC/task
    # instead of 3). False restores the request/push/return-per-task path.
    lease_reuse_enabled: bool = True
    # How long an owner's cached lease may sit idle before the owner returns
    # the worker to its raylet.
    worker_lease_idle_ttl_s: float = 1.0
    # Raylet-side backstop: a reusable lease older than this is probed with a
    # revoke_lease RPC to its owner (an owner actively reusing it answers
    # "busy", which renews the clock; a crashed/leaky owner loses the lease).
    lease_ttl_s: float = 60.0

    # --- rpc ---
    rpc_connect_timeout_s: float = 10.0
    rpc_call_timeout_s: float = 120.0
    # Token auth on every RPC channel (reference: enable_cluster_auth,
    # ray_config_def.h:36). Empty = auth disabled.
    cluster_auth_token: str = ""
    # ray:// client server on the head node: -1 disabled, 0 auto port,
    # >0 fixed port (reference: --ray-client-server-port). Bind 0.0.0.0 to
    # accept clients from other machines.
    client_server_port: int = -1
    client_server_host: str = "127.0.0.1"

    # --- misc ---
    session_dir: str = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    log_to_driver: bool = True
    # Deterministic failure injection: JSON map of rpc method -> failure prob,
    # equivalent of RAY_testing_rpc_failure (reference: rpc/rpc_chaos.h).
    testing_rpc_failure: str = ""

    def __post_init__(self):
        # Env vars override *defaults* only — a value explicitly passed to the
        # constructor wins over the environment.
        for f in fields(self):
            current = getattr(self, f.name)
            if current == f.default:
                setattr(self, f.name, _env(f.name, current, type(current)))

    def apply_overrides(self, overrides: dict[str, Any] | None):
        if not overrides:
            return self
        for k, v in overrides.items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown config key: {k}")
            setattr(self, k, v)
        return self

    def to_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})

    @classmethod
    def from_json(cls, raw: str) -> "Config":
        cfg = cls()
        cfg.apply_overrides(json.loads(raw))
        return cfg


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config


def set_config(cfg: Config):
    global _global_config
    _global_config = cfg
