"""Placement groups: public API.

Role-equivalent of the reference's ray.util.placement_group
(python/ray/util/placement_group.py:146): reserve a gang of resource bundles
across the cluster with PACK/SPREAD/STRICT_PACK/STRICT_SPREAD strategies and
schedule tasks/actors into them. On TPU, bundles with slice label selectors
are the mechanism for reserving ICI-connected hosts (see ray_tpu.util.tpu).

A copy of ``ray_tpu/util/placement_group.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import _worker_api
from .._internal.ids import PlacementGroupID
from .._internal.protocol import (
    Bundle,
    PlacementGroupInfo,
    PlacementGroupState,
    PlacementStrategy,
)


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundle_specs = bundles

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until all bundles are committed (reference:
        PlacementGroup.wait :93)."""
        worker = _worker_api.get_core_worker()
        return _worker_api.run_on_worker_loop(
            worker.client_pool.get(*worker.gcs_address).call(
                "pg_wait_ready", self.id, timeout
            ),
            timeout=None,
        )

    wait = ready

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def info(self) -> PlacementGroupInfo:
        worker = _worker_api.get_core_worker()
        return _worker_api.run_on_worker_loop(
            worker.client_pool.get(*worker.gcs_address).call(
                "get_placement_group", self.id
            )
        )

    def bundle_node_ids(self) -> List[Optional[str]]:
        info = self.info()
        return [
            b.node_id.hex() if b.node_id is not None else None for b in info.bundles
        ]

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    bundle_label_selector: Optional[List[Dict[str, str]]] = None,
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    worker = _worker_api.get_core_worker()
    pg_id = PlacementGroupID.from_random()
    selectors = bundle_label_selector or [{} for _ in bundles]
    if len(selectors) != len(bundles):
        raise ValueError("bundle_label_selector length must match bundles")
    info = PlacementGroupInfo(
        placement_group_id=pg_id,
        name=name,
        strategy=PlacementStrategy[strategy],
        bundles=[
            Bundle(bundle_index=i, resources=dict(b), label_selector=dict(sel))
            for i, (b, sel) in enumerate(zip(bundles, selectors))
        ],
        creator_job_id=worker.job_id,
    )
    _worker_api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call(
            "create_placement_group", info
        )
    )
    return PlacementGroup(pg_id, [dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup):
    worker = _worker_api.get_core_worker()
    _worker_api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call(
            "remove_placement_group", pg.id
        )
    )


def get_placement_group(name: str) -> Optional[PlacementGroup]:
    worker = _worker_api.get_core_worker()
    info = _worker_api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call(
            "get_placement_group_by_name", name
        )
    )
    if info is None or info.state == PlacementGroupState.REMOVED:
        return None
    return PlacementGroup(
        info.placement_group_id, [dict(b.resources) for b in info.bundles]
    )


def placement_group_table() -> List[dict]:
    worker = _worker_api.get_core_worker()
    infos = _worker_api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call("list_placement_groups")
    )
    return [
        {
            "placement_group_id": i.placement_group_id.hex(),
            "name": i.name,
            "strategy": i.strategy.name,
            "state": i.state.name,
            "bundles": [dict(b.resources) for b in i.bundles],
            "nodes": [b.node_id.hex() if b.node_id else None for b in i.bundles],
        }
        for i in infos
    ]
