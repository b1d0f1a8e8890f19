"""Shared cluster-node lookup used by drivers: a copy of
ray_tpu/_internal/node_lookup.py (host code: the port imports nothing of
``ray_tpu``)."""

from __future__ import annotations


async def find_raylet_address(gcs_client):
    """Pick a raylet for a connecting driver: prefer a local node, else any
    alive one (reference: ray.init address resolution via GCS node table)."""
    nodes = await gcs_client.call("get_all_nodes")
    for n in nodes:
        if n.alive and n.address[0] in ("127.0.0.1", "localhost"):
            return n.address
    for n in nodes:
        if n.alive:
            return n.address
    raise RuntimeError("no alive nodes in cluster")
