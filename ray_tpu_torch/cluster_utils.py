"""Several nodes inside one host process, for tests and development: the
port of ray_tpu/cluster_utils.py's ``Cluster``.

N raylets, each with its own object store and worker pool, run against one
GCS on one loop thread of this process; nodes are added and removed at run
time. That is how the weight plane's relay tree, pulls across nodes and the
KV tier's holders on other nodes are tested without several machines.

    cluster = Cluster(head_node_args=dict(num_cpus=2))
    cluster.add_node(num_cpus=1, resources={"sub0": 1.0})
    cluster.connect()          # this process becomes the cluster's driver
    ...
    ray_tpu_torch.shutdown(); cluster.shutdown()

A node's resources are what its arguments name and nothing is detected
(the reference's ``add_node`` takes ``num_tpus``; a ``GPU`` count goes in
``resources``). The reference's ``AutoscalingCluster`` waits for the
autoscaler, which is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ._internal.config import Config
from .runtime.node import Node


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_node_args: Optional[dict] = None,
        _system_config: Optional[dict] = None,
    ):
        self.config = Config()
        self.config.apply_overrides(_system_config)
        self._nodes: List[Node] = []
        self.head_node: Optional[Node] = None
        if initialize_head:
            self.head_node = self.add_node(**(head_node_args or {}))

    @property
    def gcs_address(self):
        return self.head_node.gcs_address if self.head_node else None

    @property
    def address(self) -> str:
        host, port = self.gcs_address
        return f"{host}:{port}"

    def add_node(
        self,
        num_cpus: float = 1,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
    ) -> Node:
        res = dict(resources or {})
        res.setdefault("CPU", float(num_cpus))
        head = self.head_node is None
        node = Node(
            self.config,
            head=head,
            gcs_address=None if head else self.gcs_address,
            resources=res,
            labels=labels,
            object_store_memory=object_store_memory,
        )
        self._nodes.append(node)
        return node

    def remove_node(self, node: Node, graceful: bool = True):
        """Take a node down; with graceful=False the raylet just vanishes
        and the GCS health check finds the death (a crash)."""
        if graceful:
            try:
                node.loop_thread.run(node.raylet.handle_drain(), timeout=10)
            except Exception:  # noqa: BLE001 - a drain that fails still stops
                pass
        node.stop()
        if node in self._nodes:
            self._nodes.remove(node)

    def list_nodes(self) -> List[Node]:
        return list(self._nodes)

    def connect(self, **init_kwargs):
        """Attach this process to the cluster as its driver."""
        from . import api

        return api.init(address=self.address, **init_kwargs)

    def shutdown(self):
        for node in list(reversed(self._nodes)):
            node.stop()
        self._nodes.clear()
        self.head_node = None
