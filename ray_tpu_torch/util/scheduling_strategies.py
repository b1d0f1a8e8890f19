"""User-facing scheduling strategies.

Role-equivalent of the reference's ray.util.scheduling_strategies
(util/scheduling_strategies.py:17,43,164): strategy objects passed as
``scheduling_strategy=`` to task/actor options. Each converts to the internal
protocol representation at submission time.

A copy of ``ray_tpu/util/scheduling_strategies.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .._internal import protocol
from .._internal.ids import NodeID
from .placement_group import PlacementGroup


class PlacementGroupSchedulingStrategy:
    """Pin a task/actor into a placement group bundle."""

    def __init__(
        self,
        placement_group: PlacementGroup,
        placement_group_bundle_index: int = -1,
        placement_group_capture_child_tasks: bool = False,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks

    def _to_protocol(self) -> protocol.PlacementGroupSchedulingStrategy:
        return protocol.PlacementGroupSchedulingStrategy(
            placement_group_id=self.placement_group.id,
            bundle_index=self.placement_group_bundle_index,
            capture_child_tasks=self.placement_group_capture_child_tasks,
        )


class NodeAffinitySchedulingStrategy:
    """Pin to a specific node by id (hex string from ray_tpu.nodes())."""

    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft

    def _to_protocol(self) -> protocol.NodeAffinitySchedulingStrategy:
        return protocol.NodeAffinitySchedulingStrategy(
            node_id=NodeID.from_hex(self.node_id), soft=self.soft
        )


class NodeLabelSchedulingStrategy:
    """Schedule onto nodes matching label constraints (reference:
    util/scheduling_strategies.py:164; used for TPU slice targeting)."""

    def __init__(
        self,
        hard: Optional[Dict[str, List[str]]] = None,
        soft: Optional[Dict[str, List[str]]] = None,
    ):
        self.hard = hard or {}
        self.soft = soft or {}

    def _to_protocol(self) -> protocol.NodeLabelSchedulingStrategy:
        return protocol.NodeLabelSchedulingStrategy(
            hard=dict(self.hard), soft=dict(self.soft)
        )


def SPREAD() -> protocol.SpreadSchedulingStrategy:
    return protocol.SpreadSchedulingStrategy()


def to_protocol_strategy(strategy):
    """Normalize a user-supplied strategy for a TaskSpec."""
    if strategy is None or isinstance(strategy, str):
        if strategy == "SPREAD":
            return protocol.SpreadSchedulingStrategy()
        return protocol.DefaultSchedulingStrategy()
    if hasattr(strategy, "_to_protocol"):
        return strategy._to_protocol()
    return strategy
