"""Learner -> env-runner weight sync: the port of ray_tpu/rllib/weight_sync.py.

The reference hands every runner one ObjectRef per iteration (``api.put``
once, not once per runner). The port has no object plane: its runners live
in the caller's process, so the handle is the learner's host copy of the
parameters itself. ``PPOLearner.get_params`` makes that copy once per
update (the one device-to-host copy of an iteration) and keeps it until the
parameters change, which is the reference's cache per params object.

The weight plane (``use_weight_plane``, ``quantized_weight_sync``) waits for
the port of ``weights/``, and the learner group's gradient scheduler for the
collectives (ROADMAP item A.4): both raise until then.
"""

from __future__ import annotations

from typing import Any

_NO_WEIGHT_PLANE = ("the weight plane (use_weight_plane, quantized weight sync) "
                    "waits for the port of weights/ (ROADMAP, not yet placed)")


class ParamsBroadcaster:
    def __init__(self, use_weight_plane: bool = False, quantized: bool = False):
        if use_weight_plane or quantized:
            raise NotImplementedError(_NO_WEIGHT_PLANE)

    def handle(self, params: Any):
        """What the runners are handed for ``params``: the host copy itself.
        The copy is the learner's, made once per update, so an unchanged
        policy is handed on with no new copy, as the reference's cached
        ObjectRef is."""
        return params


def broadcaster_for(config) -> ParamsBroadcaster:
    """Build from an AlgorithmConfig's weight-sync fields."""
    return ParamsBroadcaster(
        use_weight_plane=getattr(config, "use_weight_plane", False),
        quantized=getattr(config, "quantized_weight_sync", False),
    )


def grad_scheduler_for(config, group):
    """The learner group's gradient scheduler: it comes with the port of the
    collectives (ROADMAP item A.4)."""
    raise NotImplementedError(
        "the learner group's gradient scheduler comes with the collectives "
        "(ROADMAP item A.4); the port's PPO has one learner"
    )


def resolve_params(params: Any) -> Any:
    """Runner-side inverse of ``ParamsBroadcaster.handle``: without a weight
    plane the handle is the parameters, and passes through."""
    return params
