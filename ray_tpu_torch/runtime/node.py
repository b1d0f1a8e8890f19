"""In-process node bring-up.

Role-equivalent of the reference's Node (_private/node.py:52): starts the
head-node processes (GCS) and the per-node processes (raylet + object store +
worker pool). Unlike the reference — which spawns separate gcs_server/raylet
binaries — the GCS and raylet here are asyncio services hosted on a dedicated
loop thread inside the starting process; worker processes are real
subprocesses.

A copy of ``ray_tpu/runtime/node.py`` (host code: the port imports nothing of
``ray_tpu``) without the ``ray://`` client server and the dashboard, which
are not ported.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

from .._internal.config import Config
from .._internal.event_loop import LoopThread
from .gcs.server import GcsServer
from .raylet.raylet import Raylet


class Node:
    def __init__(
        self,
        config: Config,
        head: bool = True,
        gcs_address: Optional[Tuple[str, int]] = None,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        session_id: Optional[str] = None,
        object_store_memory: Optional[int] = None,
        loop_thread: Optional[LoopThread] = None,
    ):
        self.config = config
        self.head = head
        self.session_id = session_id or f"{os.getpid()}_{int(time.time() * 1000) % 10**8}"
        self._own_loop = loop_thread is None
        self.loop_thread = loop_thread or LoopThread("ray_tpu_torch-node")
        self.gcs: Optional[GcsServer] = None
        self.gcs_address = gcs_address

        resources = dict(resources or {})
        resources.setdefault("CPU", float(os.cpu_count() or 1))
        labels = dict(labels or {})

        if head:
            self.gcs = GcsServer(config)
            self.gcs_address = self.loop_thread.run(self.gcs.start(), timeout=30)
        assert self.gcs_address is not None, "non-head node needs gcs_address"
        self.raylet = Raylet(
            config,
            self.gcs_address,
            resources,
            labels,
            self.session_id,
            is_head=head,
            object_store_memory=object_store_memory,
        )
        self.raylet_address = self.loop_thread.run(self.raylet.start(), timeout=30)

    @property
    def node_id(self):
        return self.raylet.node_id

    def kill_gcs_for_testing(self):
        """Abruptly stop the GCS service (FT tests: the head process dies).
        In-flight subscriber polls and RPCs fail exactly as they would on a
        real GCS crash; tables die with the process unless gcs_storage_path
        points at the durable backend."""
        assert self.gcs is not None, "only the head node hosts the GCS"
        self.loop_thread.run(self.gcs.stop(), timeout=10)

    def restart_gcs_for_testing(self):
        """Start a fresh GcsServer on the SAME address, reloading state from
        the configured storage backend (reference: GCS restart with a Redis
        backend + NotifyGCSRestart reconnects)."""
        host, port = self.gcs_address
        self.gcs = GcsServer(self.config)
        self.gcs_address = self.loop_thread.run(
            self.gcs.start(host, port), timeout=30
        )
        return self.gcs_address

    def stop(self):
        try:
            self.loop_thread.run(self.raylet.stop(), timeout=10)
        except Exception:
            pass
        if self.gcs is not None:
            try:
                self.loop_thread.run(self.gcs.stop(), timeout=10)
            except Exception:
                pass
        if self._own_loop:
            self.loop_thread.stop()
