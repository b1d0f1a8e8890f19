"""Node-local resource accounting.

Role-equivalent of the reference's resource model (common/scheduling/
resource_set.h, resource_instance_set.h, fixed_point.h): vector resources with
fixed-point arithmetic, per-instance granularity for accelerator chips, label
selectors, and placement-group bundle sub-pools.

``GPU`` is a countable resource whose *instances* are the card ids of the
host; an allocation returns concrete ids, which the lease carries to the
worker, and the worker binds ``torch.cuda`` to its card. A whole demand
takes whole free cards, lowest ids first; a demand below 1 takes its share
of one card, the lowest-numbered that has that much left, and its lease
names that card (so replicas at ``num_gpus=0.5`` pack two to a card, each
bound to it); a non-integer demand above 1 is refused with a ValueError,
as Ray refuses it (ROADMAP kept item 39). The reference hands out ids only
for whole amounts, so a fractional lease there names no card.

A copy of ``ray_tpu/runtime/raylet/resources.py`` (host code: the port
imports nothing of ``ray_tpu``). Only ``GPU`` is an instance resource here:
the card's host has no TPU, so ``TPU`` is a plain custom resource.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..._internal.ids import PlacementGroupID

# fixed-point: resource quantities are integers in units of 1/10000
# (reference: fixed_point.h)
_SCALE = 10_000


def _fp(v: float) -> int:
    return int(round(v * _SCALE))


def _unfp(v: int) -> float:
    return v / _SCALE


# resources whose allocations map to concrete device instances
INSTANCE_RESOURCES = ("GPU",)


def unschedulable_devices(demand: Dict[str, float],
                          node_totals: List[Dict[str, float]]) -> Dict[str, float]:
    """The device resources of ``demand`` that no node has at all (the
    port has no autoscaler to add one)."""
    return {k: v for k, v in demand.items()
            if k in INSTANCE_RESOURCES and v > 0
            and not any(t.get(k, 0.0) > 0 for t in node_totals)}


def check_instance_demand(demand: Dict[str, float]) -> None:
    """A device demand is a share of one card (below 1) or whole cards."""
    for k, v in demand.items():
        if k in INSTANCE_RESOURCES and v > 1 and not float(v).is_integer():
            raise ValueError(
                f"{k} demand {v} is above 1 and not whole: a demand takes a "
                "share of one card (below 1) or whole cards"
            )


@dataclass
class Allocation:
    resources: Dict[str, int]  # fixed-point amounts
    instance_ids: Dict[str, List[int]] = field(default_factory=dict)
    bundle: Optional[Tuple[PlacementGroupID, int]] = None


class ResourcePool:
    """One pool of vector resources with instance tracking: each card's
    remaining share, in fixed point."""

    def __init__(self, totals: Dict[str, float]):
        self.total: Dict[str, int] = {k: _fp(v) for k, v in totals.items()}
        self.available: Dict[str, int] = dict(self.total)
        # instance resources: card id -> its free share (_SCALE = whole)
        self._instances: Dict[str, Dict[int, int]] = {
            k: {i: _SCALE for i in range(int(v))}
            for k, v in totals.items()
            if k in INSTANCE_RESOURCES and float(v).is_integer()
        }

    def feasible(self, demand: Dict[str, float]) -> bool:
        return all(self.total.get(k, 0) >= _fp(v) for k, v in demand.items())

    def _place(self, k: str, amount: int) -> Optional[List[int]]:
        """The cards an instance demand of ``amount`` takes, or None where
        none fit: whole free cards for a whole demand, else the
        lowest-numbered card with that share left."""
        cards = self._instances[k]
        if amount % _SCALE == 0:
            n = amount // _SCALE
            free = [i for i in sorted(cards) if cards[i] == _SCALE]
            return free[:n] if len(free) >= n else None
        if amount > _SCALE:
            raise ValueError(
                f"{k} demand {_unfp(amount)} is above 1 and not whole: a demand "
                "takes a share of one card (below 1) or whole cards"
            )
        for i in sorted(cards):
            if cards[i] >= amount:
                return [i]
        return None

    def can_allocate(self, demand: Dict[str, float]) -> bool:
        check_instance_demand(demand)
        if not all(self.available.get(k, 0) >= _fp(v) for k, v in demand.items()):
            return False
        return all(self._place(k, _fp(v)) is not None
                   for k, v in demand.items() if k in self._instances and _fp(v) > 0)

    def allocate(self, demand: Dict[str, float]) -> Optional[Allocation]:
        if not self.can_allocate(demand):
            return None
        fp_demand = {k: _fp(v) for k, v in demand.items()}
        alloc = Allocation(resources=fp_demand)
        for k, amount in fp_demand.items():
            self.available[k] -= amount
            if k in self._instances and amount > 0:
                ids = self._place(k, amount)
                share = min(amount, _SCALE)
                for i in ids:
                    self._instances[k][i] -= share
                alloc.instance_ids[k] = ids
        return alloc

    def release(self, alloc: Allocation):
        for k, amount in alloc.resources.items():
            self.available[k] = min(
                self.available.get(k, 0) + amount, self.total.get(k, amount)
            )
        for k, ids in alloc.instance_ids.items():
            cards = self._instances.get(k)
            if cards is None:
                continue
            share = min(alloc.resources.get(k, 0), _SCALE)
            for i in ids:
                if i in cards:
                    cards[i] = min(cards[i] + share, _SCALE)

    def available_float(self) -> Dict[str, float]:
        return {k: _unfp(v) for k, v in self.available.items()}

    def total_float(self) -> Dict[str, float]:
        return {k: _unfp(v) for k, v in self.total.items()}


class LocalResourceManager:
    """Per-node manager: the main pool plus per-bundle sub-pools reserved by
    placement-group 2-phase commit (reference: LocalResourceManager +
    bundle resource accounting in the raylet)."""

    def __init__(self, totals: Dict[str, float], labels: Dict[str, str]):
        self.pool = ResourcePool(totals)
        self.labels = dict(labels)
        # (pg_id, bundle_index) -> (reservation from main pool, sub-pool)
        self._bundles: Dict[Tuple[PlacementGroupID, int], Tuple[Allocation, ResourcePool]] = {}
        self._committed: set = set()

    # -- plain allocations -------------------------------------------------

    def matches_labels(self, selector: Dict[str, str]) -> bool:
        from ..._internal.protocol import label_match

        return label_match(self.labels, selector)

    def feasible(self, demand: Dict[str, float], selector: Dict[str, str]) -> bool:
        return self.matches_labels(selector) and self.pool.feasible(demand)

    def allocate(
        self,
        demand: Dict[str, float],
        bundle: Optional[Tuple[PlacementGroupID, int]] = None,
    ) -> Optional[Allocation]:
        if bundle is not None:
            entry = self._bundles.get(bundle)
            if entry is None or bundle not in self._committed:
                return None
            alloc = entry[1].allocate(demand)
            if alloc is not None:
                alloc.bundle = bundle
            return alloc
        return self.pool.allocate(demand)

    def release(self, alloc: Allocation):
        if alloc.bundle is not None:
            entry = self._bundles.get(alloc.bundle)
            if entry is not None:
                entry[1].release(alloc)
            return
        self.pool.release(alloc)

    # -- placement group bundles (2-phase) ---------------------------------

    def prepare_bundle(
        self, pg_id: PlacementGroupID, index: int, resources: Dict[str, float]
    ) -> bool:
        key = (pg_id, index)
        if key in self._bundles:
            return True
        reservation = self.pool.allocate(resources)
        if reservation is None:
            return False
        sub = ResourcePool(resources)
        # the bundle's sub-pool holds the cards (or the share of one card)
        # reserved from the main pool
        for k, ids in reservation.instance_ids.items():
            share = min(reservation.resources.get(k, 0), _SCALE)
            sub._instances[k] = {i: share for i in ids}
        self._bundles[key] = (reservation, sub)
        return True

    def commit_bundle(self, pg_id: PlacementGroupID, index: int) -> bool:
        key = (pg_id, index)
        if key not in self._bundles:
            return False
        self._committed.add(key)
        return True

    def return_bundle(self, pg_id: PlacementGroupID, index: int):
        key = (pg_id, index)
        entry = self._bundles.pop(key, None)
        self._committed.discard(key)
        if entry is not None:
            self.pool.release(entry[0])

    def has_bundle(self, pg_id: PlacementGroupID, index: int) -> bool:
        return (pg_id, index) in self._committed

    def bundle_can_allocate(
        self, pg_id: PlacementGroupID, index: int, demand: Dict[str, float]
    ) -> bool:
        entry = self._bundles.get((pg_id, index))
        return entry is not None and entry[1].can_allocate(demand)

    # -- views -------------------------------------------------------------

    def available_float(self) -> Dict[str, float]:
        return self.pool.available_float()

    def total_float(self) -> Dict[str, float]:
        return self.pool.total_float()
