"""SAC: soft actor-critic for continuous control, the port of
ray_tpu/rllib/sac.py.

The env runners step their envs and a CPU copy of the squashed Gaussian
actor on the host, rescale its tanh actions into the env's Box, and feed a
numpy :class:`~.dqn.ReplayBuffer` (before ``learning_starts`` they act
uniformly at random from their numpy generator, as the reference's do). The
learner lives on the card unless ``build(device=...)`` names another
device: actor, twin critics, target critics, a 0-d ``log_alpha`` and an
Adam state for each of the three optimizers.

One update is the reference's ``_one_update`` step for step: the critic
target from the target critics and the next action; the critics' Adam
step; the actor loss against the *updated* critics, its gradients taken
w.r.t. the actor's parameters alone (``torch.autograd.grad``, so no
gradient reaches the critics); the temperature step on ``log_alpha``
against the actor's detached log-probs; the polyak update
``(1 - tau) * t + tau * o``. The reference scans the ``num_updates_per_iter``
updates in one jitted ``lax.scan``; here they are an eager loop over one
``sample_many`` stack copied to the device once, their normal draws from a
device generator seeded ``seed + iteration`` (the reference keys
``PRNGKey(seed + iteration)``), and their stats stay on the device until
``train()`` copies their means once.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._internal.device import DeviceLike, resolve_device
from .config_base import AlgorithmConfig
from .dqn import ReplayBuffer
from .env import VectorEnv, encode_obs, make_env, probe_spaces, space_dims
from .env_runner import collect_episodes
from .learner import (adam_init, adam_state_dict, host_copy, load_adam_state, load_module,
                      minimize_, module_names, polyak_, to_device)
from .models import init_squashed_actor, init_twin_q, squashed_sample_logp
from .weight_sync import broadcaster_for, resolve_params

STAT_KEYS = ("critic_loss", "actor_loss", "alpha_loss", "alpha", "entropy")


def box_bounds(space) -> Tuple[np.ndarray, np.ndarray]:
    """A Box's (low, high) as float32 arrays."""
    return np.asarray(space.low, np.float32), np.asarray(space.high, np.float32)


class SACRunner:
    """Env runner on the host sampling the squashed Gaussian policy (a CPU
    copy, drawing from a torch generator seeded ``seed``) and rescaling its
    tanh actions into the env's Box; before learning starts, uniform
    actions in [-1, 1] from a numpy generator seeded ``seed``."""

    def __init__(self, env_spec, env_config, num_envs, rollout_len, seed):
        factory = make_env(env_spec, env_config)
        self._vec = VectorEnv([factory for _ in range(num_envs)])
        obs_dim, act_dim, discrete = space_dims(self._vec.observation_space,
                                                self._vec.action_space)
        if discrete:
            raise ValueError("SAC requires a continuous (Box) action space")
        self._rollout_len = rollout_len
        self.actor = init_squashed_actor(obs_dim, act_dim, seed, device="cpu")
        self.actor.requires_grad_(False)
        self._generator = torch.Generator().manual_seed(seed)
        self._obs = self._encode(self._vec.reset(seed=seed))
        self._act_low, self._act_high = box_bounds(self._vec.action_space)
        self._ep_ret = np.zeros(num_envs, np.float32)
        self._ep_len = np.zeros(num_envs, np.int64)
        self._np_rng = np.random.default_rng(seed)  # warm-up exploration

    def _encode(self, obs) -> np.ndarray:
        return encode_obs(self._vec.observation_space, obs)

    def sample(self, params: Dict[str, torch.Tensor], random_actions: bool = False):
        """``rollout_len`` steps of every env: flat [T * N] transitions with
        the tanh-space actions, and the episodes closed."""
        self.actor.load_state_dict(resolve_params(params))
        out: Dict[str, List] = {k: [] for k in ("obs", "actions", "rewards", "next_obs", "dones")}
        ep_returns: List[float] = []
        ep_lengths: List[int] = []
        for _ in range(self._rollout_len):
            if random_actions:
                a = self._np_rng.uniform(
                    -1.0, 1.0, (len(self._obs), len(self._act_low))).astype(np.float32)
            else:
                with torch.inference_mode():
                    mean, log_std = self.actor(torch.from_numpy(self._obs.astype(np.float32)))
                    a, _ = squashed_sample_logp(mean, log_std, self._generator)
                a = a.numpy()
            env_a = self._act_low + (a + 1.0) * 0.5 * (self._act_high - self._act_low)
            next_obs, rewards, terms, truncs = self._vec.step(env_a)
            next_enc = self._encode(next_obs)
            dones = (terms | truncs).astype(np.float32)
            out["obs"].append(self._obs)
            out["actions"].append(a)
            out["rewards"].append(rewards)
            out["next_obs"].append(next_enc)
            out["dones"].append(dones)
            self._ep_ret += rewards
            self._ep_len += 1
            collect_episodes(self._ep_ret, self._ep_len, dones, ep_returns, ep_lengths)
            self._obs = next_enc
        return {
            "obs": np.concatenate(out["obs"]).astype(np.float32),
            "actions": np.concatenate(out["actions"]).astype(np.float32),
            "rewards": np.concatenate(out["rewards"]),
            "next_obs": np.concatenate(out["next_obs"]).astype(np.float32),
            "dones": np.concatenate(out["dones"]),
            "episode_returns": ep_returns,
            "episode_lengths": ep_lengths,
        }

    def stop(self):
        self._vec.close()
        return True


class SACConfig(AlgorithmConfig):
    """The reference's SACConfig, field for field."""

    def __init__(self):
        super().__init__()
        self.num_env_runners = 1
        self.num_envs_per_runner = 1
        self.rollout_len = 64
        self.gamma = 0.99
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.tau = 0.005  # polyak coefficient for target critics
        self.initial_alpha = 1.0
        self.target_entropy: Optional[float] = None  # default: -act_dim
        self.buffer_capacity = 100_000
        self.learning_starts = 1000
        self.train_batch_size = 256
        self.num_updates_per_iter = 16


class SAC:
    """SAC with host env runners and replay buffer, and a learner on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, config: SACConfig, device: DeviceLike = None):
        if config.env_spec is None:
            raise ValueError("config.environment(...) is required")
        self.config = config
        self.iteration = 0
        obs_space, act_space = probe_spaces(config)
        obs_dim, act_dim, discrete = space_dims(obs_space, act_space)
        if discrete:
            raise ValueError("SAC requires a continuous (Box) action space")
        self._obs_dim, self._act_dim = obs_dim, act_dim
        self.target_entropy = (config.target_entropy if config.target_entropy is not None
                               else -float(act_dim))
        self.device = resolve_device(device)
        self.actor = init_squashed_actor(obs_dim, act_dim, config.seed, self.device)
        self.critic = init_twin_q(obs_dim, act_dim, config.seed + 1, self.device)
        self.target_critic = init_twin_q(obs_dim, act_dim, config.seed + 1, self.device)
        self.target_critic.requires_grad_(False)
        self.log_alpha = torch.tensor(float(np.log(np.float32(config.initial_alpha))),
                                      device=self.device, requires_grad=True)
        self.opt = {
            "actor": adam_init(dict(self.actor.named_parameters())),
            "critic": adam_init(dict(self.critic.named_parameters())),
            "alpha": adam_init({"log_alpha": self.log_alpha}),
        }
        self._act_low, self._act_high = box_bounds(act_space)
        self.buffer = ReplayBuffer(config.buffer_capacity, obs_dim, (act_dim,), np.float32)
        self._broadcaster = broadcaster_for(config)
        self.runners = [
            SACRunner(config.env_spec, config.env_config, config.num_envs_per_runner,
                      config.rollout_len, config.seed + 1000 * (i + 1))
            for i in range(config.num_env_runners)
        ]
        self._ep_return_window: List[float] = []
        self._snapshot: Optional[Dict[str, torch.Tensor]] = None
        #: host seconds of the last iteration's parts: sampling, the
        #: buffer's adds and draws, the learner's updates (ending with the
        #: stats' copy to the host)
        self.timers: Dict[str, float] = {}

    # -- learner ---------------------------------------------------------------

    def _one_update(self, batch: Dict[str, torch.Tensor], generator=None,
                    noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """One gradient step of every part (the reference's
        ``_one_update``); the stats in ``STAT_KEYS`` order, on the device.
        ``noise`` (next, current) replaces the draws from ``generator``."""
        cfg = self.config
        noise_next, noise_cur = noise if noise is not None else (None, None)
        with torch.no_grad():
            mean_n, log_std_n = self.actor(batch["next_obs"])
            next_a, next_logp = squashed_sample_logp(mean_n, log_std_n, generator, noise_next)
            tq1, tq2 = self.target_critic(batch["next_obs"], next_a)
            alpha = torch.exp(self.log_alpha)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target_q = batch["rewards"] + cfg.gamma * (1.0 - batch["dones"]) * target_v

        critic_params = list(self.critic.parameters())
        q1, q2 = self.critic(batch["obs"], batch["actions"])
        c_loss = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
        minimize_(c_loss, critic_params, self.opt["critic"], cfg.critic_lr)

        # the actor against the updated critics; gradients w.r.t. the actor only
        mean, log_std = self.actor(batch["obs"])
        a, logp = squashed_sample_logp(mean, log_std, generator, noise_cur)
        q1, q2 = self.critic(batch["obs"], a)
        a_loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
        minimize_(a_loss, list(self.actor.parameters()), self.opt["actor"], cfg.actor_lr)

        logp = logp.detach()
        al_loss = -torch.mean(torch.exp(self.log_alpha) * (logp + self.target_entropy))
        minimize_(al_loss, [self.log_alpha], self.opt["alpha"], cfg.alpha_lr)
        with torch.no_grad():
            polyak_(list(self.target_critic.parameters()), critic_params, cfg.tau)
            return torch.stack([c_loss.detach(), a_loss.detach(), al_loss.detach(),
                                torch.exp(self.log_alpha), -torch.mean(logp)])

    def _update(self, batches: Dict[str, np.ndarray], noises=None) -> torch.Tensor:
        """``num_updates_per_iter`` updates over ``batches`` ([U, B, ...]
        numpy, one copy to the device), drawing from a device generator
        seeded ``seed + iteration`` unless ``noises`` (U pairs of (next,
        current) draws) is given; the mean of each stat, on the device."""
        dtype = self.log_alpha.dtype
        stacked = to_device(batches, self.device, dtype)
        generator = None
        if noises is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.config.seed + self.iteration)
        stats = []
        for u in range(stacked["obs"].shape[0]):
            noise = None
            if noises is not None:
                noise = [torch.as_tensor(np.array(n)).to(self.device, dtype)
                         for n in noises[u]]
            stats.append(self._one_update({k: v[u] for k, v in stacked.items()},
                                          generator, noise))
        self._snapshot = None
        return torch.stack(stats).mean(0)

    def get_params(self) -> Dict[str, torch.Tensor]:
        """A host copy of the actor's parameters, made once per change."""
        if self._snapshot is None:
            self._snapshot = host_copy(dict(self.actor.named_parameters()))
        return self._snapshot

    # -- training loop -----------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        warmup = self.buffer.size() < cfg.learning_starts
        actor_handle = self._broadcaster.handle(self.get_params())
        rollouts = [r.sample(actor_handle, warmup) for r in self.runners]
        t1 = time.perf_counter()
        ep_returns: List[float] = []
        buffer_size = self.buffer.size()
        for ro in rollouts:
            buffer_size = self.buffer.add(ro["obs"], ro["actions"], ro["rewards"],
                                          ro["next_obs"], ro["dones"])
            ep_returns.extend(ro["episode_returns"])
        batches = None
        if buffer_size >= cfg.learning_starts:
            batches = self.buffer.sample_many(cfg.train_batch_size, cfg.num_updates_per_iter,
                                              seed=cfg.seed + self.iteration * 997)
        t2 = time.perf_counter()
        stats: Dict[str, float] = {}
        if batches is not None:
            stats = dict(zip(STAT_KEYS, self._update(batches).tolist()))
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
            "num_env_steps_sampled": sum(len(ro["rewards"]) for ro in rollouts),
            "time_this_iter_s": t3 - t0,
            **stats,
        }

    # -- checkpointing -------------------------------------------------------------

    def _modules(self):
        return {"actor": self.actor, "critic": self.critic, "target_critic": self.target_critic}

    def state_dict(self) -> Dict[str, Any]:
        return {
            "state": {name: host_copy(dict(m.named_parameters()))
                      for name, m in self._modules().items()},
            "log_alpha": self.log_alpha.detach().to("cpu", copy=True),
            "opt": {name: adam_state_dict(s) for name, s in self.opt.items()},
            "iteration": self.iteration,
        }

    def load_state_dict(self, state: Dict[str, Any]):
        """Every network, ``log_alpha``, the three Adam states and the
        iteration from :meth:`state_dict`; tensors keep their dtype."""
        for name, module in self._modules().items():
            load_module(module, state["state"][name], self.device)
        self.target_critic.requires_grad_(False)
        self.log_alpha = state["log_alpha"].to(self.device, copy=True).requires_grad_(True)
        self.opt = {
            name: load_adam_state(state["opt"][name], names, self.device)
            for name, names in (("actor", module_names(self.actor)),
                                ("critic", module_names(self.critic)),
                                ("alpha", ["log_alpha"]))
        }
        self.iteration = state["iteration"]
        self._snapshot = None

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        torch.save(self.state_dict(), os.path.join(checkpoint_dir, "sac_state.pt"))
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        self.load_state_dict(torch.load(os.path.join(checkpoint_dir, "sac_state.pt"),
                                        map_location="cpu", weights_only=True))

    def compute_single_action(self, obs) -> np.ndarray:
        """The deterministic (mean) action, rescaled into the env's Box as
        the runners rescale theirs."""
        x = torch.as_tensor(np.asarray(obs, np.float32).reshape(1, -1), device=self.device)
        with torch.no_grad():
            mean, _ = self.actor(x.to(self.log_alpha.dtype))
            a = torch.tanh(mean).float().cpu().numpy()[0]
        return self._act_low + (a + 1.0) * 0.5 * (self._act_high - self._act_low)

    def stop(self):
        for r in self.runners:
            r.stop()
        self.runners = []


SACConfig.algo_class = SAC
