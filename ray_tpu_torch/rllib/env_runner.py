"""EnvRunner: collects rollouts with the current policy, on the host; the port
of ray_tpu/rllib/env_runner.py.

Each runner holds a vector of env copies and a CPU copy of the policy, and
draws its actions from its own ``torch.Generator`` seeded from ``seed``;
``sample(params)`` loads the learner's host copy of the parameters, steps
``rollout_len`` times and returns [T, N] trajectory arrays with the
reference's keys, shapes and dtypes. The reference runs each runner as an
actor in its own process; the port has no actor runtime, so runners are
plain objects in the caller's process (``PPO`` samples them in turn).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .connectors import ConnectorContext, default_env_to_module, default_module_to_env
from .env import VectorEnv, make_env, space_dims
from .models import init_actor_critic, sample_actions
from .weight_sync import resolve_params


def collect_episodes(ep_ret, ep_len, dones, returns: list, lengths: list) -> None:
    """Close the episodes of the envs whose ``dones`` are set: record
    their return and length, and start them again from 0."""
    for i in np.nonzero(dones)[0]:
        returns.append(float(ep_ret[i]))
        lengths.append(int(ep_len[i]))
        ep_ret[i] = 0.0
        ep_len[i] = 0


class EnvRunner:
    def __init__(
        self,
        env_spec,
        env_config: Optional[dict],
        num_envs: int,
        rollout_len: int,
        seed: int,
        env_to_module_connector=None,
        module_to_env_connector=None,
    ):
        factory = make_env(env_spec, env_config)
        self._vec = VectorEnv([factory for _ in range(num_envs)])
        self._rollout_len = rollout_len
        obs_dim, act_dim, discrete = space_dims(
            self._vec.observation_space, self._vec.action_space
        )
        self.model = init_actor_critic(obs_dim, act_dim, discrete, seed, device="cpu")
        self.model.requires_grad_(False)
        self._generator = torch.Generator().manual_seed(seed)
        # connector factories, so that stateful connectors (running
        # normalizers) stay per runner
        self._ctx = ConnectorContext(
            self._vec.observation_space, self._vec.action_space
        )
        self._env_to_module = (
            env_to_module_connector() if env_to_module_connector
            else default_env_to_module()
        )
        self._module_to_env = (
            module_to_env_connector() if module_to_env_connector
            else default_module_to_env()
        )
        self._obs = self._encode(self._vec.reset(seed=seed))
        self._discrete = discrete
        # episode-return bookkeeping
        self._ep_returns = np.zeros(num_envs, np.float32)
        self._ep_lengths = np.zeros(num_envs, np.int64)

    def _encode(self, obs) -> np.ndarray:
        return np.asarray(self._env_to_module(obs, self._ctx), np.float32)

    def sample(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Roll ``rollout_len`` steps with ``params`` (the learner's host
        copy); returns [T, N] arrays + last values for bootstrap + episode
        stats. Discrete actions come back as int32, as the reference's
        ``jax.random.categorical`` gives them."""
        self.model.load_state_dict(resolve_params(params))
        T, N = self._rollout_len, self._vec.num_envs
        obs_buf = np.zeros((T, N) + self._obs.shape[1:], np.float32)
        act_buf = None
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), bool)
        ep_returns: List[float] = []
        ep_lengths: List[int] = []
        with torch.inference_mode():
            for t in range(T):
                actions, logp, values = sample_actions(
                    self.model, torch.from_numpy(self._obs), self._generator
                )
                actions = actions.numpy()
                if self._discrete:
                    actions = actions.astype(np.int32)
                obs_buf[t] = self._obs
                if act_buf is None:
                    act_buf = np.zeros((T, N) + actions.shape[1:], actions.dtype)
                act_buf[t] = actions
                logp_buf[t] = logp.numpy()
                val_buf[t] = values.numpy()
                env_actions = self._module_to_env(actions, self._ctx)
                next_obs, rewards, terms, truncs = self._vec.step(env_actions)
                dones = terms | truncs
                rew_buf[t] = rewards
                done_buf[t] = dones
                self._ep_returns += rewards
                self._ep_lengths += 1
                collect_episodes(self._ep_returns, self._ep_lengths, dones,
                                 ep_returns, ep_lengths)
                self._obs = self._encode(next_obs)
            _, last_values = self.model(torch.from_numpy(self._obs))
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "last_values": last_values.numpy(),
            "episode_returns": ep_returns,
            "episode_lengths": ep_lengths,
        }

    def stop(self):
        self._vec.close()
        return True
