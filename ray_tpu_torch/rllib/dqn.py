"""DQN: off-policy Q-learning over a replay buffer, the port of
ray_tpu/rllib/dqn.py.

Epsilon-greedy env runners step their envs and a CPU copy of the Q network
on the host and feed a numpy :class:`ReplayBuffer`, both in the caller's
process (the reference runs them as actors). The learner (online and target
Q networks, Adam's moments) lives on the card unless ``build(device=...)``
names another device. An iteration's ``num_updates_per_iter`` minibatches
are drawn with the reference's seeds, stacked and copied to the device in
one copy; the double-DQN updates then run as an eager loop (the reference
runs one jitted update per minibatch). Each update leaves its loss on the
device, and ``train()`` copies the losses to the host once.

One departure from the reference: a transition that ends an episode by
truncation is ``done`` here (``terminated | truncated``, as the reference's
SAC, IMPALA and PPO runners have it). The reference's ``DQNRunner`` reads
the truncation flag as an info dict, so a truncated episode never closes and
its Bellman target bootstraps from the next episode's reset observation.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .._internal.device import DeviceLike, resolve_device
from .config_base import AlgorithmConfig
from .env import VectorEnv, encode_obs, make_env, probe_spaces, space_dims
from .env_runner import collect_episodes
from .learner import (adam_init, adam_state_dict, host_copy, load_adam_state, load_module,
                      minimize_, module_names, to_device)
from .models import init_q_network
from .weight_sync import broadcaster_for, resolve_params


class ReplayBuffer:
    """Uniform ring-buffer replay in numpy, on the host (the reference's,
    copied). Actions default to discrete scalars; pass ``act_shape`` /
    ``act_dtype`` for continuous vectors (SAC)."""

    def __init__(self, capacity: int, obs_dim: int, act_shape: tuple = (),
                 act_dtype=np.int64):
        self._capacity = capacity
        self._obs = np.zeros((capacity, obs_dim), np.float32)
        self._next_obs = np.zeros((capacity, obs_dim), np.float32)
        self._actions = np.zeros((capacity,) + tuple(act_shape), act_dtype)
        self._rewards = np.zeros((capacity,), np.float32)
        self._dones = np.zeros((capacity,), np.float32)
        self._idx = 0
        self._size = 0

    def add(self, obs, actions, rewards, next_obs, dones) -> int:
        n = len(rewards)
        pos = (self._idx + np.arange(n)) % self._capacity
        self._obs[pos] = obs[:n]
        self._next_obs[pos] = next_obs[:n]
        self._actions[pos] = actions[:n]
        self._rewards[pos] = rewards[:n]
        self._dones[pos] = dones[:n]
        self._idx = int((self._idx + n) % self._capacity)
        self._size = int(min(self._size + n, self._capacity))
        return self._size

    def _gather(self, idx) -> Dict[str, np.ndarray]:
        return {
            "obs": self._obs[idx],
            "actions": self._actions[idx],
            "rewards": self._rewards[idx],
            "next_obs": self._next_obs[idx],
            "dones": self._dones[idx],
        }

    def sample(self, batch_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
        idx = np.random.default_rng(seed).integers(0, self._size, batch_size)
        return self._gather(idx)

    def sample_many(self, batch_size: int, n_batches: int, seed: int = 0):
        """``n_batches`` minibatches stacked on a leading axis, drawn at
        once."""
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, self._size, (n_batches, batch_size))
        return self._gather(idx)

    def size(self) -> int:
        return self._size


def stack_batches(batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Minibatches stacked on a leading axis, as ``sample_many`` gives them."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


class DQNRunner:
    """Epsilon-greedy env runner on the host: a vector of env copies, a
    CPU copy of the Q network, and a numpy generator seeded ``seed`` for
    exploration (the reference's draws, in its order)."""

    def __init__(self, env_spec, env_config, num_envs, rollout_len, seed):
        env_fn = make_env(env_spec, env_config)
        self._env = VectorEnv([env_fn for _ in range(num_envs)])
        self._obs_space = self._env.envs[0].observation_space
        self._rollout_len = rollout_len
        self._rng = np.random.default_rng(seed)
        self._obs = self._env.reset(seed=seed)
        obs_dim, act_dim, _ = space_dims(self._obs_space, self._env.envs[0].action_space)
        self.model = init_q_network(obs_dim, act_dim, seed, device="cpu")
        self.model.requires_grad_(False)
        self._ep_ret = np.zeros(num_envs)
        self._ep_len = np.zeros(num_envs, np.int64)

    def sample(self, params: Dict[str, torch.Tensor], epsilon: float) -> Dict[str, Any]:
        """``rollout_len`` steps of every env with ``params`` (the learner's
        host copy): flat [T * N] transitions and the episodes closed. A
        transition is done when its episode terminated or was truncated."""
        self.model.load_state_dict(resolve_params(params))
        out: Dict[str, List] = {k: [] for k in ("obs", "actions", "rewards", "next_obs", "dones")}
        ep_returns: List[float] = []
        ep_lengths: List[int] = []
        with torch.inference_mode():
            for _ in range(self._rollout_len):
                enc = encode_obs(self._obs_space, self._obs)
                q = self.model(torch.from_numpy(enc)).numpy()
                greedy = q.argmax(axis=-1)
                random_a = self._rng.integers(0, q.shape[-1], len(greedy))
                explore = self._rng.random(len(greedy)) < epsilon
                actions = np.where(explore, random_a, greedy)
                next_obs, rewards, terms, truncs = self._env.step(actions)
                dones = terms | truncs
                out["obs"].append(enc)
                out["actions"].append(actions)
                out["rewards"].append(rewards)
                out["next_obs"].append(encode_obs(self._obs_space, next_obs))
                out["dones"].append(dones.astype(np.float32))
                self._ep_ret += rewards
                self._ep_len += 1
                collect_episodes(self._ep_ret, self._ep_len, dones, ep_returns, ep_lengths)
                self._obs = next_obs
        return {
            **{k: np.concatenate(v) for k, v in out.items()},
            "episode_returns": ep_returns,
            "episode_lengths": ep_lengths,
        }

    def stop(self):
        self._env.close()
        return True


class DQNConfig(AlgorithmConfig):
    """The reference's DQNConfig, field for field."""

    def __init__(self):
        super().__init__()
        self.gamma = 0.99
        self.lr = 1e-3
        self.buffer_capacity = 100_000
        self.learning_starts = 500
        self.train_batch_size = 64
        self.num_updates_per_iter = 16
        self.target_update_freq = 4  # iterations between target syncs
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_iters = 50
        self.double_q = True


class DQN:
    """DQN with host env runners and replay buffer, and a learner on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, config: DQNConfig, device: DeviceLike = None):
        if config.env_spec is None:
            raise ValueError("config.environment(...) is required")
        self.config = config
        self.iteration = 0
        obs_space, act_space = probe_spaces(config)
        obs_dim, act_dim, discrete = space_dims(obs_space, act_space)
        if not discrete:
            raise ValueError("DQN requires a discrete action space")
        self._obs_dim, self._act_dim = obs_dim, act_dim
        self.device = resolve_device(device)
        self.model = init_q_network(obs_dim, act_dim, config.seed, self.device)
        self.target_model = init_q_network(obs_dim, act_dim, config.seed, self.device)
        self.target_model.requires_grad_(False)
        self._sync_target()
        self.opt_state = adam_init(dict(self.model.named_parameters()))
        self.buffer = ReplayBuffer(config.buffer_capacity, obs_dim)
        self._broadcaster = broadcaster_for(config)
        self.runners = [
            DQNRunner(config.env_spec, config.env_config, config.num_envs_per_runner,
                      config.rollout_len, config.seed + 1000 * (i + 1))
            for i in range(config.num_env_runners)
        ]
        self._ep_return_window: List[float] = []
        self._snapshot: Optional[Dict[str, torch.Tensor]] = None
        #: host seconds of the last iteration's parts: sampling (every
        #: runner, one after another), the buffer's adds and draws, the
        #: learner's updates (ending with the losses' copy to the host)
        self.timers: Dict[str, float] = {}

    # -- learner ---------------------------------------------------------------

    def _sync_target(self):
        with torch.no_grad():
            for t, p in zip(self.target_model.parameters(), self.model.parameters()):
                t.copy_(p)

    def _step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One double-DQN update (the reference's ``_update_impl``); its loss
        stays on the device."""
        cfg = self.config
        params = list(self.model.parameters())
        q = self.model(batch["obs"])
        q_sel = q.gather(1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():
            q_next_target = self.target_model(batch["next_obs"])
            if cfg.double_q:
                best = self.model(batch["next_obs"]).argmax(dim=-1)
                q_next = q_next_target.gather(1, best[:, None])[:, 0]
            else:
                q_next = q_next_target.max(dim=-1).values
            target = batch["rewards"] + cfg.gamma * (1.0 - batch["dones"]) * q_next
        td = q_sel - target
        loss = torch.mean(td * td)
        minimize_(loss, params, self.opt_state, cfg.lr)
        return loss.detach()

    def _update(self, batches: Dict[str, np.ndarray]) -> torch.Tensor:
        """One update per minibatch of ``batches`` ([U, B, ...] numpy, one
        copy to the device); the U losses, on the device."""
        dtype = next(self.model.parameters()).dtype
        stacked = to_device(batches, self.device, dtype)
        losses = [self._step({k: v[u] for k, v in stacked.items()})
                  for u in range(stacked["obs"].shape[0])]
        self._snapshot = None
        return torch.stack(losses)

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(self.iteration / max(cfg.epsilon_decay_iters, 1), 1.0)
        return cfg.epsilon_initial + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    def get_params(self) -> Dict[str, torch.Tensor]:
        """A host copy of the online network's parameters, made once per
        change of them."""
        if self._snapshot is None:
            self._snapshot = host_copy(dict(self.model.named_parameters()))
        return self._snapshot

    # -- training loop -----------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        eps = self._epsilon()
        params_handle = self._broadcaster.handle(self.get_params())
        rollouts = [r.sample(params_handle, eps) for r in self.runners]
        t1 = time.perf_counter()
        ep_returns: List[float] = []
        buffer_size = self.buffer.size()
        for ro in rollouts:
            buffer_size = self.buffer.add(ro["obs"], ro["actions"], ro["rewards"],
                                          ro["next_obs"], ro["dones"])
            ep_returns.extend(ro["episode_returns"])
        batches = None
        if buffer_size >= cfg.learning_starts:
            batches = stack_batches([
                self.buffer.sample(cfg.train_batch_size,
                                   seed=cfg.seed + self.iteration * 997 + u)
                for u in range(cfg.num_updates_per_iter)
            ])
        t2 = time.perf_counter()
        losses = self._update(batches).cpu().numpy() if batches is not None else []
        if self.iteration % max(cfg.target_update_freq, 1) == 0:
            self._sync_target()
        t3 = time.perf_counter()
        self.timers = {"sample_s": t1 - t0, "buffer_s": t2 - t1, "learn_s": t3 - t2}
        self.iteration += 1
        self._ep_return_window.extend(ep_returns)
        self._ep_return_window = self._ep_return_window[-100:]
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(self._ep_return_window))
                                    if self._ep_return_window else float("nan")),
            "num_episodes": len(ep_returns),
            "buffer_size": buffer_size,
            "epsilon": eps,
            "loss_mean": float(np.mean(losses)) if len(losses) else float("nan"),
            "num_env_steps_sampled": sum(len(ro["rewards"]) for ro in rollouts),
            "time_this_iter_s": t3 - t0,
        }

    # -- checkpointing -------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": host_copy(dict(self.model.named_parameters())),
            "target_params": host_copy(dict(self.target_model.named_parameters())),
            "opt_state": adam_state_dict(self.opt_state),
            "iteration": self.iteration,
        }

    def load_state_dict(self, state: Dict[str, Any]):
        """Parameters, target, Adam state and iteration from
        :meth:`state_dict`; tensors keep the dtype they come with."""
        load_module(self.model, state["params"], self.device)
        load_module(self.target_model, state["target_params"], self.device)
        self.target_model.requires_grad_(False)
        self.opt_state = load_adam_state(state["opt_state"], module_names(self.model),
                                         self.device)
        self.iteration = state["iteration"]
        self._snapshot = None

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        torch.save(self.state_dict(), os.path.join(checkpoint_dir, "dqn_state.pt"))
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        self.load_state_dict(torch.load(os.path.join(checkpoint_dir, "dqn_state.pt"),
                                        map_location="cpu", weights_only=True))

    def compute_single_action(self, obs) -> int:
        """The greedy action for one observation."""
        x = torch.as_tensor(np.asarray(obs, np.float32)[None], device=self.device)
        with torch.no_grad():
            return int(self.model(x.to(next(self.model.parameters()).dtype)).argmax(-1)[0])

    def stop(self):
        for r in self.runners:
            r.stop()
        self.runners = []


DQNConfig.algo_class = DQN
