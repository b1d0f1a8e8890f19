"""Algorithm + PPOConfig: the user-facing RL training loop, the port of
ray_tpu/rllib/algorithm.py.

``PPOConfig().environment(...).env_runners(...).training(...).build()``
gives a :class:`PPO` whose learner runs on the card (``build(device=None)``;
a missing card raises) and whose env runners step their envs and their
policy copy on the host, in the caller's process. ``train()`` runs one
iteration: sampling, GAE, the learner update; ``save``/``restore``
checkpoint the learner and the iteration count.

The reference runs its runners as actors that sample in parallel; the port
has no actor runtime, so they sample one after another, and ``train()``
records the host time of each part of an iteration in ``PPO.timers``. Each
iteration also feeds the ``rllib`` step breakdown (``util/metrics``
``StepBreakdown``: the ``step_time_seconds`` and
``scaling_efficiency_ratio`` gauges), as the reference's does.
``as_trainable`` waits for the port of ``tune/``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .._internal.device import DeviceLike
from ..util.metrics import StepBreakdown
from .config_base import AlgorithmConfig
from .connectors import ConnectorContext, default_env_to_module
from .env import probe_spaces, space_dims
from .env_runner import EnvRunner
from .learner import PPOLearner
from .models import compute_gae, sample_actions
from .weight_sync import broadcaster_for


def gae_batch(rollouts, gamma: float, lam: float) -> Dict[str, np.ndarray]:
    """Shared postprocess: per-rollout GAE + [T, N] -> [T*N] flatten ->
    one concatenated PPO batch."""
    obs, actions, logp, adv, ret = [], [], [], [], []
    for ro in rollouts:
        a, r = compute_gae(
            ro["rewards"], ro["values"], ro["dones"], ro["last_values"],
            gamma, lam,
        )
        T, N = ro["rewards"].shape
        obs.append(ro["obs"].reshape(T * N, -1))
        actions.append(ro["actions"].reshape(T * N, *ro["actions"].shape[2:]))
        logp.append(ro["logp"].reshape(T * N))
        adv.append(a.reshape(T * N))
        ret.append(r.reshape(T * N))
    return {
        "obs": np.concatenate(obs).astype(np.float32),
        "actions": np.concatenate(actions),
        "logp_old": np.concatenate(logp),
        "advantages": np.concatenate(adv),
        "returns": np.concatenate(ret),
    }


class PPOConfig(AlgorithmConfig):
    #: connector factories are honored by this algorithm's runners
    supports_connectors = True

    def __init__(self):
        super().__init__()
        self.num_envs_per_runner = 4
        self.rollout_len = 64
        self.gamma = 0.99
        self.lam = 0.95
        self.lr = 3e-4
        self.clip_param = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_epochs = 4
        self.minibatch_size = 128
        self.max_grad_norm = 0.5


class PPO:
    """PPO with host env runners + a learner on ``device`` (the card unless
    the caller names another)."""

    def __init__(self, config: PPOConfig, device: DeviceLike = None):
        if config.env_spec is None:
            raise ValueError("config.environment(...) is required")
        self.config = config
        self.iteration = 0
        self._broadcaster = broadcaster_for(config)
        self.observation_space, self.action_space = probe_spaces(config)
        obs_dim, act_dim, discrete = space_dims(self.observation_space, self.action_space)
        self.learner = PPOLearner(
            obs_dim,
            act_dim,
            discrete,
            lr=config.lr,
            clip_param=config.clip_param,
            vf_coeff=config.vf_coeff,
            entropy_coeff=config.entropy_coeff,
            num_epochs=config.num_epochs,
            minibatch_size=config.minibatch_size,
            max_grad_norm=config.max_grad_norm,
            seed=config.seed,
            device=device,
        )
        self.runners = [
            EnvRunner(
                config.env_spec,
                config.env_config,
                config.num_envs_per_runner,
                config.rollout_len,
                config.seed + 1000 * (i + 1),
                config.env_to_module_connector,
                config.module_to_env_connector,
            )
            for i in range(config.num_env_runners)
        ]
        self._ep_return_window: List[float] = []
        # the caller's own env-to-module pipeline for compute_single_action:
        # inference must see the same transform the policy trained on
        # (stateful connector stats live per runner and are not merged back,
        # as in the reference)
        self._infer_ctx = ConnectorContext(self.observation_space, self.action_space)
        self._infer_connector = (
            config.env_to_module_connector() if config.env_to_module_connector
            else default_env_to_module()
        )
        #: host seconds of the last iteration's parts: sampling (every runner,
        #: one after another), GAE and batching, the learner update
        self.timers: Dict[str, float] = {}
        # per-iteration compute / collective / idle split, feeding the
        # scaling-efficiency gauge
        self._step_breakdown = StepBreakdown(role="rllib")

    # -- training -----------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        """One iteration: rollouts -> GAE -> learner update."""
        with self._step_breakdown.step():
            t0 = time.perf_counter()
            params_handle = self._broadcaster.handle(self.learner.get_params())
            rollouts = [r.sample(params_handle) for r in self.runners]
            t1 = time.perf_counter()
            batch, ep_returns, ep_lengths = self._postprocess(rollouts)
            t2 = time.perf_counter()
            stats = self.learner.update(batch)  # ends on the host: waits for the device
            t3 = time.perf_counter()
        self.timers = {"sample_s": t1 - t0, "postprocess_s": t2 - t1, "learn_s": t3 - t2}
        self.iteration += 1
        self._ep_return_window.extend(ep_returns)
        self._ep_return_window = self._ep_return_window[-100:]
        mean_return = (
            float(np.mean(self._ep_return_window))
            if self._ep_return_window
            else float("nan")
        )
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "num_episodes": len(ep_returns),
            "episode_len_mean": float(np.mean(ep_lengths))
            if ep_lengths
            else float("nan"),
            "num_env_steps_sampled": batch["obs"].shape[0],
            "time_this_iter_s": t3 - t0,
            **stats,
        }

    def _postprocess(self, rollouts):
        batch = gae_batch(rollouts, self.config.gamma, self.config.lam)
        ep_returns, ep_lengths = [], []
        for ro in rollouts:
            ep_returns.extend(ro["episode_returns"])
            ep_lengths.extend(ro["episode_lengths"])
        return batch, ep_returns, ep_lengths

    # -- checkpointing --------------------------------------------------------

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        torch.save(
            {"learner": self.learner.state_dict(), "iteration": self.iteration},
            os.path.join(checkpoint_dir, "algorithm_state.pt"),
        )
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        state = torch.load(os.path.join(checkpoint_dir, "algorithm_state.pt"),
                           map_location="cpu", weights_only=True)
        self.learner.load_state_dict(state["learner"])
        self.iteration = state["iteration"]

    def get_policy_params(self):
        return self.learner.get_params()

    def compute_single_action(self, obs):
        """One action for one raw observation, through the env-to-module
        connector, drawn on the learner's device from a generator seeded
        with the iteration count."""
        device = self.learner.device
        generator = torch.Generator(device=device).manual_seed(self.iteration)
        encoded = np.asarray(
            self._infer_connector(np.asarray(obs)[None], self._infer_ctx),
            np.float32,
        )
        with torch.no_grad():
            actions, _, _ = sample_actions(
                self.learner.model, torch.from_numpy(encoded).to(device), generator
            )
        actions = actions.cpu().numpy()
        # the reference's categorical draws are int32
        return (actions.astype(np.int32) if self.learner.discrete else actions)[0]

    def stop(self):
        for r in self.runners:
            r.stop()
        self.runners = []


PPOConfig.algo_class = PPO
