"""Test utilities: the port of ray_tpu/testing.py's serve part
(``list_serve_replicas`` and ``kill_serve_replica``) and its network chaos
hooks (``set_network_chaos`` / ``clear_network_chaos``, which every process
of the cluster polls from the GCS KV).

The reference's worker and node killers and the proxy killer wait for the
planes they drive (ROADMAP A items 21-22).
"""

from __future__ import annotations

import logging
import os
import signal
from typing import List, Optional

logger = logging.getLogger(__name__)


def list_serve_replicas(app_name: str = "default") -> List[dict]:
    """Replica inventory rows ({deployment, replica_id, state, pid,
    node_id, queue_len, affinity_keys, warmup_s, mesh}) from the live serve
    controller ([] if there is none)."""
    from . import api
    from .serve.controller import CONTROLLER_NAME

    try:
        controller = api.get_actor(CONTROLLER_NAME)
    except Exception:
        return []
    try:
        return api.get(controller.list_replica_info.remote(app_name), timeout=10)
    except Exception:
        return []


def kill_serve_replica(app_name: str = "default",
                       deployment: Optional[str] = None,
                       replica_id: Optional[str] = None,
                       sig: int = signal.SIGKILL):
    """Send ``sig`` (SIGKILL by default) to one replica process of the app,
    as losing its host would: the controller's health poll replaces it and
    in-flight requests fail over through the handle's retry envelope. Picks
    the first RUNNING replica matching the filters; returns
    (replica_id, pid), or (None, None) when nothing matched."""
    for row in list_serve_replicas(app_name):
        if row.get("state") != "RUNNING" or not row.get("pid"):
            continue
        if deployment is not None and row["deployment"] != deployment:
            continue
        if replica_id is not None and row["replica_id"] != replica_id:
            continue
        pid = row["pid"]
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            continue
        logger.info("kill_serve_replica: sent signal %s to replica %s (pid %d)",
                    sig, row["replica_id"], pid)
        return row["replica_id"], pid
    return None, None


def _gcs_kv(method, *args):
    from . import _worker_api

    worker = _worker_api.get_core_worker()
    client = worker.client_pool.get(*worker.gcs_address)
    return _worker_api.run_on_worker_loop(client.call(method, *args, timeout=10.0))


def set_network_chaos(spec: dict):
    """Publish a structured chaos-mesh spec (see ``_internal.rpc.
    set_rpc_chaos``) to the GCS KV, so every process of the cluster
    (raylets, workers, drivers) applies it within about one poll period
    (``chaos_poll_period_s``)."""
    import json

    from .runtime.gcs import keys as gcs_keys

    _gcs_kv("kv_put", gcs_keys.CHAOS_NET_SPEC, json.dumps(spec).encode(), True)


def clear_network_chaos():
    """Remove the cluster's chaos-mesh spec: every process heals within
    about one poll period."""
    from .runtime.gcs import keys as gcs_keys

    _gcs_kv("kv_del", gcs_keys.CHAOS_NET_SPEC)
