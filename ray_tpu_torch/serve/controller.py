"""ServeController, the control-plane actor that reconciles deployments:
the port of ray_tpu/serve/controller.py.

A reconcile thread compares target replica counts (static, the queue
autoscaler's, or the SLO autoscaler's) with live replicas, starts and
stops replica actors, polls their queue metrics and health, replaces dead
or unhealthy ones, drains victims on scale-down, and serves the replica
directory to routers, which poll ``get_routing_table`` keyed by a
membership version. Goal state and live replica handles checkpoint to the
GCS KV, so a controller restarted under ``max_restarts=-1`` re-adopts the
replicas that still answer.

Copied from the reference, with one departure: the checkpoint pickles
with the port's serialization (callables by reference, ROADMAP kept item
35), not cloudpickle. Replicas reserve what ``ray_actor_options`` names,
the card included (``num_gpus``; a fraction shares one card).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List

from ..runtime.gcs import keys as gcs_keys
from ..util import events as _events
from .config import (
    ApplicationStatus,
    AutoscalingConfig,
    DeploymentConfig,
    DeploymentStatus,
    ReplicaStatus,
)

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"


class _ReplicaState:
    def __init__(self, replica_id: str, handle):
        self.replica_id = replica_id
        self.handle = handle
        self.state = "STARTING"
        self.queue_len = 0
        self.consecutive_health_failures = 0
        self.started_at = time.time()
        self.pid = 0  # captured from get_metrics; chaos CLI targets it
        # hex node id captured from get_metrics: reconcile replaces replicas
        # whose node the GCS marks SUSPECT/DEAD (partition failover)
        self.node_id = ""
        # captured from get_metrics: distinct prefix-affinity keys recently
        # routed here (scale-down victim signal) and cold-start wall time
        self.affinity_keys = 0
        self.warmup_s = 0.0
        # mesh ownership card from get_metrics (None = single device):
        # {"mesh": {"tp": 2}, "tag": "tp=2", "num_devices": 2,
        #  "per_device_hbm_bytes": [...], ...}
        self.mesh = None
        # drain bookkeeping (state == "DRAINING"): the in-flight drain()
        # call and the hard deadline after which the replica is killed
        # whether or not it acked
        self.drain_ref = None
        self.drain_deadline = 0.0


class _DeploymentState:
    def __init__(self, config: DeploymentConfig, cls_bytes, init_args, init_kwargs):
        self.config = config
        self.cls_bytes = cls_bytes
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.replicas: Dict[str, _ReplicaState] = {}
        self.next_replica_idx = 0
        self.target_replicas = config.num_replicas
        if config.autoscaling_config:
            self.target_replicas = config.autoscaling_config.min_replicas
        policy = getattr(config, "autoscale_policy", None)
        if policy is not None:
            self.target_replicas = max(
                policy.min_replicas,
                min(policy.max_replicas, config.num_replicas),
            )
        # per-deployment SLO-autoscaler evaluation state (lazily created
        # for deployments recovered from pre-policy checkpoints)
        self.autoscale_state = None
        self.last_scale_up = 0.0
        self.last_scale_down = 0.0
        # bumped whenever replica membership changes, so routers cheap-poll
        self.version = 0


CHECKPOINT_KEY = gcs_keys.SERVE_CONTROLLER_CKPT


class ServeController:
    def __init__(self):
        self._apps: Dict[str, Dict[str, str]] = {}  # app -> short -> full name
        self._deployments: Dict[str, _DeploymentState] = {}
        self._lock = threading.RLock()
        self._running = True
        self._reconcile_interval_s = 0.25
        # goal state persists to GCS KV; a restarted controller re-adopts
        # live replicas instead of abandoning them (reference:
        # controller.py:98-148 checkpoint/recover)
        self._dirty = False
        # serializes snapshot+write so concurrent checkpoints (reconcile
        # thread vs deploy RPC thread) cannot land out of order and regress
        # the durable state to an older snapshot
        self._ckpt_lock = threading.Lock()
        # SLO-autoscaler decision event log (bounded). Mirrored to the GCS
        # KV under AUTOSCALE_LOG_KEY so dashboard/CLI read it without an
        # actor handle; actor method autoscale_log serves it directly.
        self._autoscale_events: List[dict] = []
        # ingress proxy inventory: proxy_id -> {info, handle, state,
        # failures}. Mirrored to GCS under the proxy: prefix so CLI/
        # dashboard/chaos see live proxies without an actor handle; health
        # is polled from the reconcile loop like replicas.
        self._proxies: Dict[str, dict] = {}
        self._last_proxy_poll = 0.0
        # replica-inventory KV mirror throttle: the snapshot only feeds
        # read-side surfaces (CLI/dashboard), so a 2 s cadence is plenty
        # and keeps the 0.25 s reconcile tick free of a per-tick kv_put
        self._last_replica_mirror = 0.0
        try:
            self._recover_from_checkpoint()
        except Exception:
            # never let recovery crash __init__: with max_restarts=-1 that
            # would restart-loop the controller forever on a bad checkpoint
            logger.exception("serve checkpoint recovery failed; starting fresh")
        self._thread = threading.Thread(
            target=self._run_control_loop, daemon=True, name="serve-reconcile"
        )
        self._thread.start()

    # -- checkpoint / recovery ----------------------------------------------

    def _kv_call(self, method: str, *args):
        from .. import _worker_api

        worker = _worker_api.get_core_worker()
        return _worker_api.run_on_worker_loop(
            worker.client_pool.get(*worker.gcs_address).call(
                method, *args, timeout=10.0
            )
        )

    def _checkpoint(self):
        """Persist goal state + live replica handles to GCS KV. Called from
        the reconcile loop when membership/config changed, and synchronously
        on deploy/delete so the goal state is durable before the API
        returns."""
        from .._internal import serialization

        with self._ckpt_lock:
            with self._lock:
                data = {
                    "apps": {a: dict(n) for a, n in self._apps.items()},
                    "deployments": {
                        full: {
                            "config": dep.config,
                            "cls_bytes": dep.cls_bytes,
                            "init_args": dep.init_args,
                            "init_kwargs": dep.init_kwargs,
                            "target_replicas": dep.target_replicas,
                            "next_replica_idx": dep.next_replica_idx,
                            "replicas": [
                                (r.replica_id, r.handle, r.state)
                                for r in dep.replicas.values()
                            ],
                        }
                        for full, dep in self._deployments.items()
                    },
                }
                self._dirty = False
            try:
                self._kv_call(
                    "kv_put", CHECKPOINT_KEY, serialization.dumps(data), True
                )
            except Exception:
                # a failed write must be retried: without re-marking dirty
                # the change would stay unpersisted until some unrelated
                # later change, and a crash in that window recovers stale
                # membership
                logger.exception("serve controller checkpoint failed")
                with self._lock:
                    self._dirty = True

    def _recover_from_checkpoint(self):
        from .. import api
        from .._internal import serialization

        try:
            raw = self._kv_call("kv_get", CHECKPOINT_KEY)
        except Exception:
            logger.exception("serve checkpoint read failed; starting fresh")
            return
        if not raw:
            return
        try:
            data = serialization.loads(raw)
        except Exception:
            logger.exception("serve checkpoint unreadable; starting fresh")
            return
        # probe every saved replica CONCURRENTLY under one shared deadline:
        # live ones are re-adopted with no churn; unresponsive ones are
        # killed (not just dropped — an alive-but-slow replica left orphaned
        # would double-serve next to its replacement) and converge replaces
        # them
        probes = []  # (dep, rid, handle, probe_ref)
        deps: Dict[str, _DeploymentState] = {}
        for full, d in data.get("deployments", {}).items():
            try:
                dep = _DeploymentState(
                    d["config"], d["cls_bytes"], d["init_args"], d["init_kwargs"]
                )
                dep.target_replicas = d["target_replicas"]
                dep.next_replica_idx = d["next_replica_idx"]
                replicas = list(d["replicas"])
            except Exception:
                # schema drift (checkpoint from another controller version):
                # skip this record rather than crash — with max_restarts=-1
                # an exception here would restart-loop the controller forever
                logger.exception("skipping malformed checkpoint record %s", full)
                continue
            deps[full] = dep
            for rid, handle, _state in replicas:
                try:
                    probes.append((dep, rid, handle, handle.check_health.remote()))
                except Exception:
                    probes.append((dep, rid, handle, None))
        deadline = time.time() + 15.0
        adopted = dead = 0
        for dep, rid, handle, ref in probes:
            healthy = False
            if ref is not None:
                try:
                    healthy = bool(
                        api.get(ref, timeout=max(deadline - time.time(), 0.5))
                    )
                except Exception:
                    healthy = False
            if healthy:
                replica = _ReplicaState(rid, handle)
                replica.state = "RUNNING"
                dep.replicas[rid] = replica
                adopted += 1
            else:
                dead += 1
                try:
                    api.kill(handle)
                except Exception:
                    pass
        self._deployments.update(deps)
        self._apps = {a: dict(n) for a, n in data.get("apps", {}).items()}
        if self._deployments:
            logger.info(
                "serve controller recovered: %d app(s), %d deployment(s); "
                "%d replica(s) re-adopted, %d dead",
                len(self._apps), len(self._deployments), adopted, dead,
            )

    # -- lifecycle -----------------------------------------------------------

    def _run_control_loop(self):
        """reference: ServeController.run_control_loop (controller.py:395)."""
        while self._running:
            try:
                self._reconcile_once()
                if self._dirty:
                    self._checkpoint()
            except Exception:
                logger.exception("serve reconcile iteration failed")
            time.sleep(self._reconcile_interval_s)

    def shutdown(self):
        self._running = False
        with self._lock:
            deps = list(self._deployments.values())
            self._deployments.clear()
            self._apps.clear()
        for dep in deps:
            dep.target_replicas = 0
            for rid in list(dep.replicas):
                self._stop_replica(dep, rid)
        try:
            # intentional teardown: a later controller must start fresh
            self._kv_call("kv_del", CHECKPOINT_KEY)
            from .autoscale import AUTOSCALE_LOG_KEY

            self._kv_call("kv_del", AUTOSCALE_LOG_KEY)
        except Exception:
            pass
        # sweep the proxy registry (including keys from proxies this
        # controller never saw — a crashed predecessor's leftovers)
        with self._lock:
            self._proxies.clear()
        try:
            for key in self._kv_call(
                "kv_keys", gcs_keys.SERVE_PROXY.scan
            ) or []:
                self._kv_call("kv_del", key)
        except Exception:
            pass
        return True

    # -- deploy API ----------------------------------------------------------

    def deploy_application(self, app_name: str, deployments: List[dict]) -> bool:
        """deployments: [{config, cls_bytes, init_args, init_kwargs}];
        re-deploy updates in place (reference: serve.run upsert)."""
        with self._lock:
            names = {}
            for d in deployments:
                config: DeploymentConfig = d["config"]
                full = f"{app_name}#{config.name}"
                names[config.name] = full
                existing = self._deployments.get(full)
                if existing is None:
                    self._deployments[full] = _DeploymentState(
                        config, d["cls_bytes"], d["init_args"], d["init_kwargs"]
                    )
                else:
                    old_user_config = existing.config.user_config
                    existing.config = config
                    policy = getattr(config, "autoscale_policy", None)
                    if not config.autoscaling_config and policy is None:
                        existing.target_replicas = config.num_replicas
                    elif policy is not None:
                        # keep the autoscaler's target across re-deploys,
                        # clamped into the (possibly new) policy bounds
                        existing.target_replicas = max(
                            policy.min_replicas,
                            min(policy.max_replicas,
                                existing.target_replicas),
                        )
                    if config.user_config != old_user_config:
                        # push new user_config without replica restarts
                        # (reference: reconfigure path)
                        for r in existing.replicas.values():
                            try:
                                r.handle.reconfigure.remote(config.user_config)
                            except Exception:
                                pass
            # deployments dropped by the re-deploy must not keep replicas
            old_names = self._apps.get(app_name, {})
            removed = [
                self._deployments.pop(full)
                for short, full in old_names.items()
                if short not in names and full in self._deployments
            ]
            self._apps[app_name] = names
        for dep in removed:
            for rid in list(dep.replicas):
                self._stop_replica(dep, rid)
        self._checkpoint()
        return True

    def delete_application(self, app_name: str) -> bool:
        with self._lock:
            names = self._apps.pop(app_name, {})
            deps = [
                self._deployments.pop(full)
                for full in names.values()
                if full in self._deployments
            ]
        for dep in deps:
            for rid in list(dep.replicas):
                self._stop_replica(dep, rid)
        self._checkpoint()
        return True

    # -- reconcile -----------------------------------------------------------

    def _reconcile_once(self):
        with self._lock:
            items = list(self._deployments.items())
        # metric payloads are fetched at most once per tick, and only when
        # some SLO-policy deployment is actually due for an evaluation
        payload_cache: Dict[str, list] = {}

        def _payloads() -> list:
            if "p" not in payload_cache:
                try:
                    from ..util.metrics import fetch_metric_payloads

                    payload_cache["p"] = fetch_metric_payloads(self._kv_call)
                except Exception:
                    payload_cache["p"] = []
            return payload_cache["p"]

        node_states = self._fetch_node_states()
        self._poll_proxies()
        for full_name, dep in items:
            self._poll_replicas(dep)
            self._evict_partitioned(dep, node_states)
            self._reap_draining(dep)
            policy = getattr(dep.config, "autoscale_policy", None)
            if policy is not None:
                self._autoscale_slo(full_name, dep, policy, _payloads)
            elif dep.config.autoscaling_config:
                self._autoscale(dep)
            self._converge(full_name, dep)
        self._mirror_replica_inventory()

    def _mirror_replica_inventory(self):
        """Mirror the replica inventory (incl. mesh ownership cards) to the
        GCS KV each tick, the proxy-registry pattern: `ray_tpu list
        replicas` and the dashboard read the KV snapshot instead of a
        controller round-trip, so inventory stays visible even while the
        controller is busy converging."""
        import json as _json

        now = time.time()
        if now - self._last_replica_mirror < 2.0:
            return
        self._last_replica_mirror = now
        rows = []
        with self._lock:
            app_names = list(self._apps)
        for app in app_names:
            for row in self.list_replica_info(app):
                row["app"] = app
                rows.append(row)
        try:
            self._kv_call(
                "kv_put", gcs_keys.SERVE_REPLICAS,
                _json.dumps({"ts": time.time(), "replicas": rows}).encode(),
                True,
            )
        except Exception:
            logger.debug("replica inventory mirror failed", exc_info=True)

    def _poll_replicas(self, dep: _DeploymentState):
        from .. import api

        for rid, replica in list(dep.replicas.items()):
            if replica.state != "RUNNING":
                continue
            try:
                metrics = api.get(replica.handle.get_metrics.remote(), timeout=5)
                replica.queue_len = metrics["queue_len"]
                replica.pid = metrics.get("pid", replica.pid)
                replica.node_id = metrics.get("node_id", replica.node_id)
                replica.affinity_keys = int(metrics.get("affinity_keys", 0))
                replica.warmup_s = float(
                    metrics.get("warmup_s", replica.warmup_s)
                )
                replica.mesh = metrics.get("mesh", replica.mesh)
                replica.consecutive_health_failures = 0
            except Exception:
                replica.consecutive_health_failures += 1
                if replica.consecutive_health_failures >= 3:
                    logger.warning("replica %s unhealthy; replacing", rid)
                    _events.record_event(
                        _events.REPLICA_STATE,
                        deployment=dep.config.name, replica=rid,
                        state="UNHEALTHY", reason="health_probe_failures",
                    )
                    with self._lock:
                        dep.replicas.pop(rid, None)
                        dep.version += 1
                        self._dirty = True
                    try:
                        api.kill(replica.handle)
                    except Exception:
                        pass

    def _fetch_node_states(self) -> Dict[str, str]:
        """node-hex -> ALIVE|SUSPECT|DEAD from the GCS, once per reconcile
        tick. An unreachable GCS returns {} — reconcile must keep running on
        health-probe evidence alone during a controller-side partition."""
        try:
            return self._kv_call("get_node_states") or {}
        except Exception:
            return {}

    def _evict_partitioned(self, dep: _DeploymentState, node_states):
        """Replace replicas on SUSPECT/DEAD nodes without waiting for three
        health-probe failures: the GCS's liveness verdict is the faster,
        cluster-wide signal during a partition. The partitioned node
        self-fences, so the old replica rejects work instead of
        double-serving next to its replacement."""
        from .. import api

        if not node_states:
            return
        for rid, replica in list(dep.replicas.items()):
            if replica.state != "RUNNING" or not replica.node_id:
                continue
            state = node_states.get(replica.node_id, "ALIVE")
            if state == "ALIVE":
                continue
            logger.warning(
                "replica %s on %s node %s; replacing",
                rid, state, replica.node_id,
            )
            _events.record_event(
                _events.REPLICA_STATE,
                deployment=dep.config.name, replica=rid,
                state="UNHEALTHY", reason=f"node_{state.lower()}",
                node=replica.node_id,
            )
            with self._lock:
                dep.replicas.pop(rid, None)
                dep.version += 1
                self._dirty = True
            try:
                api.kill(replica.handle)
            except Exception:
                pass

    def _begin_drain(self, dep: _DeploymentState, rid: str):
        """Transition a RUNNING replica to DRAINING: routers stop picking it
        (routing table filters to RUNNING), the replica finishes in-flight
        and queued work bounded by graceful_shutdown_timeout_s, then acks;
        _reap_draining kills it after the ack or the deadline. Asynchronous —
        reconcile keeps running while the replica drains (reference:
        deployment_state.py graceful-stop via STOPPING states)."""
        with self._lock:
            replica = dep.replicas.get(rid)
            if replica is None or replica.state != "RUNNING":
                return
            replica.state = "DRAINING"
            dep.version += 1
            self._dirty = True
        _events.record_event(
            _events.REPLICA_STATE,
            deployment=dep.config.name, replica=rid, state="DRAINING",
        )
        timeout_s = dep.config.graceful_shutdown_timeout_s
        try:
            replica.drain_ref = replica.handle.drain.remote(timeout_s)
        except Exception:
            replica.drain_ref = None
        # small slack over the replica-side bound so a clean ack wins the race
        replica.drain_deadline = time.time() + timeout_s + 2.0

    def _reap_draining(self, dep: _DeploymentState):
        from .. import api

        for rid, replica in list(dep.replicas.items()):
            if replica.state != "DRAINING":
                continue
            done = replica.drain_ref is None
            if not done:
                try:
                    api.get(replica.drain_ref, timeout=0.05)
                    done = True
                except TimeoutError:
                    done = False
                except Exception:
                    # replica died or drain errored; nothing left to wait for
                    done = True
            if done or time.time() >= replica.drain_deadline:
                with self._lock:
                    dep.replicas.pop(rid, None)
                    dep.version += 1
                    self._dirty = True
                _events.record_event(
                    _events.REPLICA_STOP,
                    deployment=dep.config.name, replica=rid,
                    reason="drained" if done else "drain_deadline",
                )
                try:
                    api.kill(replica.handle)
                except Exception:
                    pass

    def _autoscale(self, dep: _DeploymentState):
        cfg: AutoscalingConfig = dep.config.autoscaling_config
        running = [r for r in dep.replicas.values() if r.state == "RUNNING"]
        if not running:
            return
        total_ongoing = sum(r.queue_len for r in running)
        desired = cfg.desired_replicas(total_ongoing, len(running))
        now = time.time()
        if desired > dep.target_replicas:
            if now - dep.last_scale_up >= cfg.upscale_delay_s:
                logger.info(
                    "autoscale %s: %d -> %d (ongoing=%.1f)",
                    dep.config.name, dep.target_replicas, desired, total_ongoing,
                )
                _events.record_event(
                    _events.AUTOSCALE_DECISION,
                    deployment=dep.config.name, direction="up",
                    from_replicas=dep.target_replicas, to_replicas=desired,
                    ongoing=total_ongoing,
                )
                dep.target_replicas = desired
                dep.last_scale_up = now
        elif desired < dep.target_replicas:
            if now - dep.last_scale_down >= cfg.downscale_delay_s:
                _events.record_event(
                    _events.AUTOSCALE_DECISION,
                    deployment=dep.config.name, direction="down",
                    from_replicas=dep.target_replicas, to_replicas=desired,
                    ongoing=total_ongoing,
                )
                dep.target_replicas = desired
                dep.last_scale_down = now
        else:
            dep.last_scale_up = now
            dep.last_scale_down = now

    def _autoscale_slo(self, full_name, dep, policy, payloads_fn):
        """Closed-loop SLO autoscaler (serve/autoscale.py): every
        ``policy.interval_s`` build the pressure signals — queue depth from
        this tick's replica polls (instantaneous, so sustained pressure
        turns into a scale-up within one evaluation interval), TTFT p99 and
        shed counts as windowed deltas from the metrics push plane — run
        the pure ``evaluate`` state machine, and apply the decision by
        moving ``target_replicas`` (converge does the actual start/drain).
        Every applied decision lands in the autoscale_* metrics and the
        event log."""
        import json as _json

        from . import autoscale as _as

        st = dep.autoscale_state
        if st is None:
            st = dep.autoscale_state = _as.AutoscaleState()
        now = time.time()
        if now - st.last_eval_ts < policy.interval_s:
            return
        st.last_eval_ts = now
        running = [r for r in dep.replicas.values() if r.state == "RUNNING"]
        starting = [r for r in dep.replicas.values() if r.state == "STARTING"]
        if not running:
            return
        payloads = payloads_fn()
        shed_now = _as.shed_total(payloads, dep.config.name)
        queue_depth = float(sum(r.queue_len for r in running))
        sig = _as.AutoscaleSignals(
            queue_depth=queue_depth,
            queue_per_replica=queue_depth / len(running),
            shed_delta=max(0.0, shed_now - st.last_shed_total),
            ttft_p99_ms=_as.ttft_p99_ms(payloads, dep.config.name, st),
            running=len(running),
            starting=len(starting),
            target=dep.target_replicas,
        )
        st.last_shed_total = shed_now
        decision = _as.evaluate(policy, st, sig, now)
        if decision is None:
            return
        with self._lock:
            dep.target_replicas = decision.to_replicas
            self._dirty = True
        from ..util.metrics import record_autoscale_decision

        record_autoscale_decision(
            dep.config.name, decision.direction, decision.breach_age_s
        )
        _events.record_event(
            _events.AUTOSCALE_DECISION,
            deployment=full_name, direction=decision.direction,
            from_replicas=decision.from_replicas,
            to_replicas=decision.to_replicas, reason=decision.reason,
        )
        logger.info(
            "autoscale %s: %s %d -> %d (%s)",
            full_name, decision.direction, decision.from_replicas,
            decision.to_replicas, decision.reason,
        )
        event = {
            "ts": now,
            "deployment": full_name,
            "direction": decision.direction,
            "from": decision.from_replicas,
            "to": decision.to_replicas,
            "reason": decision.reason,
            "breach_age_s": round(decision.breach_age_s, 3),
            "signals": sig.as_dict(),
        }
        self._autoscale_events.append(event)
        del self._autoscale_events[:-_as.LOG_LIMIT]
        try:
            self._kv_call(
                "kv_put",
                _as.AUTOSCALE_LOG_KEY,
                _json.dumps(self._autoscale_events).encode(),
                True,
            )
        except Exception:
            logger.exception("autoscale event-log push failed")

    def _converge(self, full_name: str, dep: _DeploymentState):
        from .. import api

        # DRAINING replicas are lame ducks: they still exist (finishing
        # accepted work) but don't count toward the target, so a drained
        # replica's replacement starts immediately and rolling
        # replacement/scale-down never dips serving capacity to zero
        active = [
            r for r in dep.replicas.values()
            if r.state in ("STARTING", "RUNNING")
        ]
        if len(active) < dep.target_replicas:
            for _ in range(dep.target_replicas - len(active)):
                self._start_replica(full_name, dep)
        elif len(active) > dep.target_replicas:
            excess = len(active) - dep.target_replicas
            # STARTING victims first (nothing accepted yet — cheap kill),
            # then RUNNING ones with the fewest recently-routed prefix-
            # affinity keys (draining a cold replica preserves more of the
            # cluster's reusable KV prefix state), queue length as the tie
            # break
            victims = sorted(
                active,
                key=lambda r: (
                    r.state != "STARTING", r.affinity_keys, r.queue_len,
                ),
            )[:excess]
            for v in victims:
                if v.state == "STARTING":
                    self._stop_replica(dep, v.replica_id)
                else:
                    self._begin_drain(dep, v.replica_id)
        for replica in list(dep.replicas.values()):
            if replica.state == "STARTING":
                # short probe per iteration: a slow-loading replica stays
                # STARTING without stalling reconcile for other deployments
                try:
                    if api.get(replica.handle.check_health.remote(), timeout=2):
                        with self._lock:
                            replica.state = "RUNNING"
                            dep.version += 1
                            self._dirty = True
                        _events.record_event(
                            _events.REPLICA_STATE,
                            deployment=dep.config.name,
                            replica=replica.replica_id, state="RUNNING",
                        )
                except TimeoutError:
                    if (
                        time.time() - replica.started_at
                        > dep.config.startup_timeout_s
                    ):
                        logger.warning(
                            "replica %s startup timed out", replica.replica_id
                        )
                        self._stop_replica(dep, replica.replica_id)
                except Exception:
                    logger.exception(
                        "replica %s failed to start", replica.replica_id
                    )
                    with self._lock:
                        dep.replicas.pop(replica.replica_id, None)
                    try:
                        api.kill(replica.handle)
                    except Exception:
                        pass

    def _start_replica(self, full_name: str, dep: _DeploymentState):
        from .. import api
        from .replica import Replica

        rid = f"{full_name}#{dep.next_replica_idx}"
        dep.next_replica_idx += 1
        opts = dict(dep.config.ray_actor_options or {})
        opts.setdefault("num_cpus", 1)
        # getattr: configs unpickled from a pre-admission-control checkpoint
        # lack the queue knob
        max_queued = getattr(dep.config, "max_queued_requests", 64)
        # headroom above the admission caps so control-plane calls
        # (get_metrics/check_health/drain) are not starved behind a
        # saturated data plane and falsely mark the replica unhealthy —
        # queued requests each hold an actor-concurrency slot while waiting
        opts.setdefault(
            "max_concurrency",
            dep.config.max_ongoing_requests + max(0, max_queued) + 8,
        )
        ReplicaActor = api.remote(**opts)(Replica)
        handle = ReplicaActor.remote(
            dep.config.name,
            rid,
            dep.cls_bytes,
            dep.init_args,
            dep.init_kwargs,
            dep.config.user_config,
            max_ongoing_requests=dep.config.max_ongoing_requests,
            max_queued_requests=max_queued,
        )
        with self._lock:
            dep.replicas[rid] = _ReplicaState(rid, handle)
            self._dirty = True
        _events.record_event(
            _events.REPLICA_START, deployment=dep.config.name, replica=rid,
        )

    def _stop_replica(self, dep: _DeploymentState, rid: str):
        from .. import api

        with self._lock:
            replica = dep.replicas.pop(rid, None)
            if replica is None:
                return
            dep.version += 1
            self._dirty = True
        _events.record_event(
            _events.REPLICA_STOP,
            deployment=dep.config.name, replica=rid, reason="stopped",
        )
        try:
            api.get(
                replica.handle.prepare_for_shutdown.remote(
                    dep.config.graceful_shutdown_timeout_s
                ),
                timeout=dep.config.graceful_shutdown_timeout_s + 2,
            )
        except Exception:
            pass
        try:
            api.kill(replica.handle)
        except Exception:
            pass

    # -- router / status API -------------------------------------------------

    def get_routing_table(self, app_name: str) -> Dict[str, Any]:
        """deployment short-name -> {version, replicas: [(rid, handle,
        queue_len)], router_config}. DRAINING/UNHEALTHY replicas are
        filtered out here, so routers never pick a lame duck; the
        router_config dict distributes the deployment's failover policy to
        every handle (reference: LongPollClient pushing DeploymentConfig)."""
        from .config import RequestRouterConfig

        with self._lock:
            out = {}
            for short, full in self._apps.get(app_name, {}).items():
                dep = self._deployments.get(full)
                if dep is None:
                    continue
                rc = getattr(dep.config, "request_router_config", None) \
                    or RequestRouterConfig()
                out[short] = {
                    "version": dep.version,
                    "replicas": [
                        (r.replica_id, r.handle, r.queue_len)
                        for r in dep.replicas.values()
                        if r.state == "RUNNING"
                    ],
                    "router_config": rc.as_dict(),
                }
            return out

    def drain_replica(self, app_name: str, replica_id: str) -> bool:
        """Chaos/ops entry point: gracefully drain one replica. Converge
        starts its replacement on the next reconcile tick (the drained
        replica stops counting toward the target)."""
        with self._lock:
            candidates = [
                self._deployments[full]
                for full in self._apps.get(app_name, {}).values()
                if full in self._deployments
            ]
        for dep in candidates:
            if replica_id in dep.replicas:
                self._begin_drain(dep, replica_id)
                return True
        return False

    def list_replica_info(self, app_name: str) -> List[Dict[str, Any]]:
        """Replica inventory for the chaos CLI and tests: deployment,
        replica_id, state, pid (SIGKILL/SIGSTOP target), queue_len."""
        with self._lock:
            out = []
            for short, full in self._apps.get(app_name, {}).items():
                dep = self._deployments.get(full)
                if dep is None:
                    continue
                for r in dep.replicas.values():
                    out.append({
                        "deployment": short,
                        "replica_id": r.replica_id,
                        "state": r.state,
                        "pid": r.pid,
                        "node_id": r.node_id,
                        "queue_len": r.queue_len,
                        "affinity_keys": r.affinity_keys,
                        "warmup_s": r.warmup_s,
                        "mesh": r.mesh,
                    })
            return out

    # -- proxy inventory ------------------------------------------------------

    _PROXY_POLL_S = 2.0
    _PROXY_MAX_FAILURES = 3

    def register_proxy(self, proxy_id: str, info: dict, handle) -> bool:
        """Add an ingress proxy to the inventory and mirror its identity to
        the GCS ``proxy:`` prefix (what `ray_tpu proxies`, the dashboard
        and chaos kill-proxy read)."""
        import json as _json

        info = dict(info)
        info.setdefault("proxy_id", proxy_id)
        with self._lock:
            self._proxies[proxy_id] = {
                "info": info, "handle": handle, "state": "RUNNING",
                "failures": 0,
            }
        try:
            self._kv_call(
                "kv_put", gcs_keys.SERVE_PROXY.key(proxy_id),
                _json.dumps(info).encode(), True,
            )
        except Exception:
            logger.exception("proxy registry write failed for %s", proxy_id)
        _events.record_event(
            _events.PROXY_START, proxy_id=proxy_id,
            kind=info.get("kind"), host=info.get("host"),
            port=info.get("port"), pid=info.get("pid"),
        )
        return True

    def deregister_proxy(self, proxy_id: str, reason: str = "stopped") -> bool:
        with self._lock:
            entry = self._proxies.pop(proxy_id, None)
        if entry is None:
            return False
        try:
            self._kv_call("kv_del", gcs_keys.SERVE_PROXY.key(proxy_id))
        except Exception:
            pass
        _events.record_event(
            _events.PROXY_STOP, proxy_id=proxy_id, reason=reason,
        )
        return True

    def list_proxies(self) -> List[Dict[str, Any]]:
        """Proxy inventory rows (identity + state, no actor handles) for
        the CLI / dashboard / chaos kill-proxy."""
        with self._lock:
            return [
                {**e["info"], "proxy_id": pid, "state": e["state"]}
                for pid, e in sorted(self._proxies.items())
            ]

    def drain_proxy(self, proxy_id: str, timeout_s: float = 5.0) -> bool:
        """Gracefully retire one proxy: it refuses new requests (503 +
        Retry-After pushes clients to the survivors), finishes in-flight
        work bounded by ``timeout_s``, then leaves the inventory."""
        from .. import api

        with self._lock:
            entry = self._proxies.get(proxy_id)
            if entry is None:
                return False
            entry["state"] = "DRAINING"
        try:
            ok = api.get(
                entry["handle"].drain.remote(timeout_s),
                timeout=timeout_s + 5,
            )
        except Exception:
            ok = False
        self.deregister_proxy(proxy_id, reason="drained")
        return bool(ok)

    def _poll_proxies(self):
        """Reconcile-loop health pass over the proxy inventory: a proxy
        whose actor died (SIGKILL chaos, node loss) is deregistered at
        once; transient ping failures tolerate _PROXY_MAX_FAILURES
        consecutive misses before eviction."""
        from .. import api
        from ..exceptions import ActorDiedError

        now = time.time()
        if now - self._last_proxy_poll < self._PROXY_POLL_S:
            return
        self._last_proxy_poll = now
        with self._lock:
            items = [
                (pid, e) for pid, e in self._proxies.items()
                if e["state"] == "RUNNING"
            ]
        probes = []
        for pid, entry in items:
            try:
                probes.append((pid, entry, entry["handle"].ping.remote()))
            except Exception:
                probes.append((pid, entry, None))
        for pid, entry, ref in probes:
            dead = False
            ok = False
            if ref is not None:
                try:
                    api.get(ref, timeout=5)
                    ok = True
                except ActorDiedError:
                    dead = True
                except Exception:
                    ok = False
            if ok:
                entry["failures"] = 0
            else:
                entry["failures"] += 1
                if dead or entry["failures"] >= self._PROXY_MAX_FAILURES:
                    logger.warning(
                        "serve proxy %s unresponsive (dead=%s); "
                        "deregistering", pid, dead,
                    )
                    self.deregister_proxy(pid, reason="dead")

    def get_ingress_info(self, app_name: str) -> Dict[str, Any]:
        """How the proxy should talk to the app root: plain request/response,
        item streaming, or ASGI (reference: the proxy's per-app ingress
        resolution, serve/_private/proxy.py:805)."""
        with self._lock:
            first = None
            for short, full in self._apps.get(app_name, {}).items():
                dep = self._deployments.get(full)
                if dep is None:
                    continue
                info = {
                    "deployment": short,
                    "stream": getattr(dep.config, "stream", False),
                    "asgi": getattr(dep.config, "asgi", False),
                }
                if first is None:
                    first = info
                if getattr(dep.config, "ingress", False):
                    return info
            return first or {}

    def autoscale_log(self, limit: int = 100) -> List[dict]:
        """Most recent SLO-autoscaler decisions, oldest first (`ray_tpu
        autoscale log`, tests)."""
        with self._lock:
            return list(self._autoscale_events)[-max(0, limit):]

    def list_applications(self) -> List[str]:
        with self._lock:
            return list(self._apps.keys())

    def get_app_route_prefixes(self) -> Dict[str, str]:
        """route prefix -> app name, for the HTTP proxy."""
        with self._lock:
            out = {}
            for app_name, names in self._apps.items():
                prefix = f"/{app_name}"
                for short, full in names.items():
                    dep = self._deployments.get(full)
                    if dep and dep.config.route_prefix:
                        prefix = dep.config.route_prefix
                out[prefix] = app_name
            return out

    def status(self) -> Dict[str, ApplicationStatus]:
        with self._lock:
            out = {}
            for app_name, names in self._apps.items():
                deps = {}
                app_healthy = True
                for short, full in names.items():
                    dep = self._deployments.get(full)
                    if dep is None:
                        continue
                    replicas = [
                        ReplicaStatus(r.replica_id, r.state, r.queue_len)
                        for r in dep.replicas.values()
                    ]
                    n_running = sum(1 for r in replicas if r.state == "RUNNING")
                    healthy = n_running >= max(1, dep.target_replicas)
                    app_healthy = app_healthy and healthy
                    deps[short] = DeploymentStatus(
                        name=short,
                        status="HEALTHY" if healthy else "UPDATING",
                        replicas=replicas,
                    )
                out[app_name] = ApplicationStatus(
                    name=app_name,
                    status="RUNNING" if app_healthy else "DEPLOYING",
                    deployments=deps,
                )
            return out

    def ping(self):
        return True
