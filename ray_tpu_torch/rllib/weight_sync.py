"""Learner -> env-runner weight sync: the port of ray_tpu/rllib/weight_sync.py.

The reference hands every runner one ObjectRef per iteration (``api.put``
once, not once per runner). The port's runners live in the caller's
process (ROADMAP A item 24 makes them actors), so in the default mode the
handle is the learner's host copy of the parameters itself:
``PPOLearner.get_params`` makes that copy once per update and keeps it until
the parameters change, which is the reference's cache per params object.

With ``use_weight_plane`` (``config.weight_sync(use_weight_plane=True)``)
each distinct params object is published once as a version of
``weight_plane_name`` through ``ray_tpu_torch.weights`` (int8 chunks with
``quantized``), and the runners are handed a small ``WeightHandle``, which
:func:`resolve_params` at the top of each runner's ``sample`` fetches back.
This mode needs ``ray_tpu_torch.init()``, as the reference's does.
:func:`grad_scheduler_for` builds a learner gang's gradient scheduler over a
collective group.
"""

from __future__ import annotations

from typing import Any, Optional


class ParamsBroadcaster:
    def __init__(self, use_weight_plane: bool = False, name: Optional[str] = None,
                 quantized: bool = False):
        self._use_weight_plane = use_weight_plane
        self._name = name or "rllib/params"
        # the int8 chunk codec on weight-plane publishes; no effect otherwise
        self._quantized = quantized
        self._cached: Any = None
        self._handle: Any = None

    def handle(self, params: Any):
        """What the runners are handed for ``params``: without the weight
        plane the host copy itself (the learner's, made once per update);
        with it a ``WeightHandle``, published at most once per distinct
        params object."""
        if not self._use_weight_plane:
            return params
        if params is self._cached and self._handle is not None:
            return self._handle
        from .. import weights

        self._handle = weights.publish(self._name, params, quantized=self._quantized)
        self._cached = params
        return self._handle

    def invalidate(self):
        """Forget the cache (e.g. params mutated in place)."""
        self._cached = None
        self._handle = None


def broadcaster_for(config) -> ParamsBroadcaster:
    """Build from an AlgorithmConfig's weight-sync fields."""
    return ParamsBroadcaster(
        use_weight_plane=getattr(config, "use_weight_plane", False),
        name=getattr(config, "weight_plane_name", None)
        or f"rllib/{type(config).__name__.removesuffix('Config').lower()}",
        quantized=getattr(config, "quantized_weight_sync", False),
    )


def grad_scheduler_for(config, group):
    """Learner-side gradient scheduler from an AlgorithmConfig's
    weight-sync fields, as ``broadcaster_for``: ``group`` is the learner
    gang's collective group (either backend). With ``overlap_grad_sync``
    off the scheduler still bucketizes but blocks on each bucket: the same
    calls, an A/B by config alone."""
    from ..collective.bucketizer import DEFAULT_BUCKET_BYTES
    from ..collective.scheduler import GradientReduceScheduler

    return GradientReduceScheduler(
        group,
        bucket_bytes=getattr(config, "grad_sync_bucket_bytes", None) or DEFAULT_BUCKET_BYTES,
        overlap=getattr(config, "overlap_grad_sync", False),
    )


def resolve_params(params: Any) -> Any:
    """Runner-side inverse of ``ParamsBroadcaster.handle``: a
    ``WeightHandle`` fetches its version over the weight plane (onto the
    host, where the runners' models live); anything else passes through."""
    from ..weights import WeightHandle, resolve

    if isinstance(params, WeightHandle):
        return resolve(params)
    return params
