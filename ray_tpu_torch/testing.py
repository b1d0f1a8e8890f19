"""Test utilities of the serve control plane: the port of the serve part of
ray_tpu/testing.py (``list_serve_replicas`` and ``kill_serve_replica``).

The reference's worker and node killers, the proxy killer and the network
chaos hooks wait for the planes they drive (ROADMAP A items 21-22).
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
