"""Connector pipelines: the port of ray_tpu/rllib/connectors.py.

An **env-to-module** pipeline turns raw env observations into the model's
input batch; a **module-to-env** pipeline turns model outputs into actions
the env accepts. A connector is ``__call__(data, ctx) -> data`` where data is
a numpy batch ([N, ...] observations or [N, ...] actions) and ctx carries
the spaces. Connectors run in numpy on the host, where the env runners are.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from .env import encode_obs, is_box


class ConnectorContext:
    """Spaces (and room for future fields) visible to every connector."""

    def __init__(self, observation_space=None, action_space=None):
        self.observation_space = observation_space
        self.action_space = action_space


class Connector:
    """One transform stage (reference: ConnectorV2.__call__)."""

    def __call__(self, data, ctx: ConnectorContext):
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class ConnectorPipeline(Connector):
    """Ordered chain of connectors: ``pipeline(data)`` pushes the batch
    through every stage in order. Mutate with prepend/append/insert_after."""

    def __init__(self, connectors: Optional[Sequence[Connector]] = None):
        self.connectors: List[Connector] = list(connectors or [])

    def __call__(self, data, ctx: ConnectorContext):
        for connector in self.connectors:
            data = connector(data, ctx)
        return data

    def prepend(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def insert_after(self, anchor_type, connector: Connector) -> "ConnectorPipeline":
        for i, existing in enumerate(self.connectors):
            if isinstance(existing, anchor_type):
                self.connectors.insert(i + 1, connector)
                return self
        raise ValueError(f"no connector of type {anchor_type.__name__} in pipeline")

    def __repr__(self):
        inner = " -> ".join(repr(c) for c in self.connectors)
        return f"ConnectorPipeline[{inner}]"


class FlattenObservations(Connector):
    """Raw obs batch -> float32 [N, obs_dim]; Discrete obs one-hot encode."""

    def __call__(self, data, ctx: ConnectorContext):
        return encode_obs(ctx.observation_space, np.asarray(data))


class NormalizeObservations(Connector):
    """Running mean/std normalization, updated on every batch (Welford, row
    by row, in float32 as the reference does)."""

    def __init__(self, epsilon: float = 1e-8):
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None
        self._eps = epsilon

    def __call__(self, data, ctx: ConnectorContext):
        batch = np.asarray(data, np.float32)
        if self._mean is None:
            self._mean = np.zeros(batch.shape[1:], np.float32)
            self._m2 = np.ones(batch.shape[1:], np.float32)
        for row in batch:  # batches are small on the rollout path
            self._count += 1.0
            delta = row - self._mean
            self._mean += delta / self._count
            self._m2 += delta * (row - self._mean)
        var = self._m2 / max(self._count, 1.0)
        return (batch - self._mean) / np.sqrt(var + self._eps)


class ClipActions(Connector):
    """Clip continuous actions into the Box bounds; pass-through for
    Discrete."""

    def __call__(self, data, ctx: ConnectorContext):
        space = ctx.action_space
        if is_box(space):
            return np.clip(np.asarray(data), space.low, space.high)
        return data


class Lambda(Connector):
    """Wrap a plain function as a connector stage."""

    def __init__(self, fn: Callable[[Any, ConnectorContext], Any], name: str = ""):
        self._fn = fn
        self._name = name or getattr(fn, "__name__", "lambda")

    def __call__(self, data, ctx: ConnectorContext):
        return self._fn(data, ctx)

    def __repr__(self):
        return f"Lambda({self._name})"


def default_env_to_module() -> ConnectorPipeline:
    return ConnectorPipeline([FlattenObservations()])


def default_module_to_env() -> ConnectorPipeline:
    return ConnectorPipeline([ClipActions()])
