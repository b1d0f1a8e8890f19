"""Shared AlgorithmConfig base: the port of ray_tpu/rllib/config_base.py.

The fluent config methods (environment / env_runners / training /
resources / weight_sync / debugging / build) shared by every algorithm
config, with per-algorithm defaults and algo classes supplied by subclasses.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Union

from .._internal.device import DeviceLike


class AlgorithmConfig:
    """Every field and config method of the reference's config.

    The port has no actor runtime: env runners are plain objects in the
    caller's process and the learner runs on the device ``build`` is given.
    So ``num_cpus_per_runner`` and ``num_tpus_for_learner`` are accepted and
    unused, as are ``overlap_grad_sync`` and ``grad_sync_bucket_bytes`` (one
    learner, nothing to reduce). ``use_weight_plane`` (with
    ``weight_plane_name`` and ``quantized_weight_sync``) hands the runners
    weight-plane handles, and needs ``ray_tpu_torch.init()``
    (rllib/weight_sync.py)."""

    #: subclass hook: the Algorithm class ``build()`` instantiates
    algo_class: Any = None

    def __init__(self):
        self.env_spec: Union[str, Callable, None] = None
        self.env_config: Dict[str, Any] = {}
        self.num_env_runners = 2
        self.num_envs_per_runner = 2
        self.rollout_len = 32
        self.seed = 0
        self.num_cpus_per_runner = 1.0
        self.num_tpus_for_learner = 0.0
        self.env_to_module_connector = None
        self.module_to_env_connector = None
        self.use_weight_plane = False
        self.weight_plane_name: Optional[str] = None
        self.quantized_weight_sync = False
        self.overlap_grad_sync = False
        self.grad_sync_bucket_bytes: Optional[int] = None

    def environment(self, env, env_config: Optional[dict] = None):
        self.env_spec = env
        self.env_config = dict(env_config or {})
        return self

    def env_runners(
        self,
        num_env_runners: Optional[int] = None,
        num_envs_per_env_runner: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
        num_cpus_per_env_runner: Optional[float] = None,
        env_to_module_connector=None,
        module_to_env_connector=None,
    ):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_len = rollout_fragment_length
        if num_cpus_per_env_runner is not None:
            self.num_cpus_per_runner = num_cpus_per_env_runner
        # zero-arg factories returning a Connector/ConnectorPipeline —
        # factories, not instances, so stateful connectors stay per-runner
        if env_to_module_connector is not None or module_to_env_connector is not None:
            if not getattr(self, "supports_connectors", False):
                raise NotImplementedError(
                    f"{type(self).__name__} runners do not consume connector "
                    "pipelines yet (PPO does); configuring one here would be "
                    "silently dropped"
                )
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        if module_to_env_connector is not None:
            self.module_to_env_connector = module_to_env_connector
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def resources(self, num_tpus_for_learner: float = 0):
        self.num_tpus_for_learner = num_tpus_for_learner
        return self

    def weight_sync(
        self,
        use_weight_plane: Optional[bool] = None,
        weight_plane_name: Optional[str] = None,
        quantized: Optional[bool] = None,
        overlap: Optional[bool] = None,
        bucket_bytes: Optional[int] = None,
    ):
        if use_weight_plane is not None:
            self.use_weight_plane = use_weight_plane
        if weight_plane_name is not None:
            self.weight_plane_name = weight_plane_name
        if quantized is not None:
            self.quantized_weight_sync = quantized
        if overlap is not None:
            self.overlap_grad_sync = overlap
        if bucket_bytes is not None:
            self.grad_sync_bucket_bytes = bucket_bytes
        return self

    def debugging(self, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        return self

    def build(self, device: DeviceLike = None):
        """The algorithm, its learner on ``device`` (``None``: the card; a
        missing card raises)."""
        if self.algo_class is None:
            raise NotImplementedError(f"{type(self).__name__}.algo_class unset")
        return self.algo_class(copy.deepcopy(self), device=device)

    # legacy alias used by reference examples
    build_algo = build
