"""IMPALA and APPO: actor-learner training with V-trace, the port of
ray_tpu/rllib/impala.py.

The env runners step their envs and a CPU copy of the ActorCritic on the
host and return [T, N] rollouts with the behaviour policy's log-probs and
the bootstrap observation; the learner (on the card unless
``build(device=...)`` names another device) recomputes values and
log-probs with its own parameters and corrects the gap with V-trace. APPO
(``APPOConfig``, ``use_clip``) adds PPO's clipped surrogate on the V-trace
advantage. The optimizer is ``optax.chain(clip_by_global_norm, adam)``.

Staleness. The reference keeps one ``sample()`` in flight per runner, each
with the parameters handed over when its last rollout was consumed, and
consumes whichever lands first: a rollout is at least one update old. The
port has no actor runtime and keeps that staleness deterministically: a
FIFO of (runner, host copy of the parameters handed over when its last
rollout was consumed); a runner samples when its turn comes. So after the
first update the learner's policy is not the behaviour policy and the mean
importance ratio departs from 1, as in the reference.

V-trace. The reference's reverse ``lax.scan`` over time becomes a loop over
T under ``torch.no_grad()`` (every term of it is a stop-gradient value),
adding the terms in the reference's order. Each update's stats stay on the
device; ``train()`` copies them to the host once.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .._internal.device import DeviceLike, resolve_device
from .config_base import AlgorithmConfig
from .env import VectorEnv, encode_obs, make_env, probe_spaces, space_dims
from .env_runner import collect_episodes
from .learner import (adam_init, adam_state_dict, host_copy, load_adam_state, load_module,
                      minimize_, module_names, to_device)
from .models import init_actor_critic, log_prob_entropy, sample_actions
from .weight_sync import broadcaster_for, resolve_params

STAT_KEYS = ("policy_loss", "vf_loss", "entropy", "total_loss", "mean_rho")
ROLLOUT_KEYS = ("obs", "actions", "behavior_logp", "rewards", "dones", "bootstrap_obs")


class ImpalaRunner:
    """Env runner on the host returning [T, N] trajectories, the behaviour
    log-probs and the bootstrap observation (no values: the learner
    recomputes them). It draws from a torch generator seeded ``seed``."""

    def __init__(self, env_spec, env_config, num_envs, rollout_len, seed):
        factory = make_env(env_spec, env_config)
        self._vec = VectorEnv([factory for _ in range(num_envs)])
        self._rollout_len = rollout_len
        obs_dim, act_dim, discrete = space_dims(self._vec.observation_space,
                                                self._vec.action_space)
        self.model = init_actor_critic(obs_dim, act_dim, discrete, seed, device="cpu")
        self.model.requires_grad_(False)
        self._discrete = discrete
        self._generator = torch.Generator().manual_seed(seed)
        self._obs = self._encode(self._vec.reset(seed=seed))
        self._ep_ret = np.zeros(num_envs, np.float32)
        self._ep_len = np.zeros(num_envs, np.int64)

    def _encode(self, obs) -> np.ndarray:
        return encode_obs(self._vec.observation_space, obs)

    def sample(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Roll ``rollout_len`` steps with ``params`` (a host copy of the
        learner's). Discrete actions are int32, as the reference's
        ``jax.random.categorical`` gives them."""
        self.model.load_state_dict(resolve_params(params))
        T, N = self._rollout_len, self._vec.num_envs
        obs_buf = np.zeros((T, N) + self._obs.shape[1:], np.float32)
        act_buf = None
        logp_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        ep_returns: List[float] = []
        ep_lengths: List[int] = []
        for t in range(T):
            with torch.inference_mode():
                actions, logp, _ = sample_actions(
                    self.model, torch.from_numpy(self._obs.astype(np.float32)),
                    self._generator)
            actions = actions.numpy()
            if self._discrete:
                actions = actions.astype(np.int32)
            obs_buf[t] = self._obs
            if act_buf is None:
                act_buf = np.zeros((T, N) + actions.shape[1:], actions.dtype)
            act_buf[t] = actions
            logp_buf[t] = logp.numpy()
            next_obs, rewards, terms, truncs = self._vec.step(actions)
            dones = terms | truncs
            rew_buf[t] = rewards
            done_buf[t] = dones.astype(np.float32)
            self._ep_ret += rewards
            self._ep_len += 1
            collect_episodes(self._ep_ret, self._ep_len, dones, ep_returns, ep_lengths)
            self._obs = self._encode(next_obs)
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "behavior_logp": logp_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "bootstrap_obs": self._obs.astype(np.float32),
            "episode_returns": ep_returns,
            "episode_lengths": ep_lengths,
        }

    def stop(self):
        self._vec.close()
        return True


class IMPALAConfig(AlgorithmConfig):
    """The reference's IMPALAConfig, field for field."""

    def __init__(self):
        super().__init__()
        self.num_envs_per_runner = 4
        self.gamma = 0.99
        self.lr = 5e-4
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.max_grad_norm = 40.0
        # V-trace clippings (IMPALA paper: rho_bar, c_bar)
        self.vtrace_rho_clip = 1.0
        self.vtrace_c_clip = 1.0
        # APPO variant: additionally clip the pg ratio PPO-style
        self.use_clip = False
        self.clip_param = 0.3
        self.num_batches_per_iter = 4


class APPOConfig(IMPALAConfig):
    """APPO: IMPALA with PPO's clipped surrogate on the V-trace advantage."""

    def __init__(self):
        super().__init__()
        self.use_clip = True


class IMPALA:
    """Actor-learner with host env runners taking turns (a FIFO that keeps
    the reference's one-update staleness) and a V-trace learner on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, config: IMPALAConfig, device: DeviceLike = None):
        if config.env_spec is None:
            raise ValueError("config.environment(...) is required")
        self.config = config
        self.iteration = 0
        self.observation_space, act_space = probe_spaces(config)
        obs_dim, act_dim, discrete = space_dims(self.observation_space, act_space)
        self._discrete = discrete
        self.device = resolve_device(device)
        self.model = init_actor_critic(obs_dim, act_dim, discrete, config.seed, self.device)
        self.opt_state = adam_init(dict(self.model.named_parameters()))
        self._broadcaster = broadcaster_for(config)
        self.runners = [
            ImpalaRunner(config.env_spec, config.env_config, config.num_envs_per_runner,
                         config.rollout_len, config.seed + 1000 * (i + 1))
            for i in range(config.num_env_runners)
        ]
        self._snapshot: Optional[Dict[str, torch.Tensor]] = None
        # every runner's first rollout shares the initial parameters
        handle = self._broadcaster.handle(self.get_params())
        self._turns = deque((r, handle) for r in self.runners)
        self._ep_return_window: List[float] = []
        #: host seconds of the last iteration's parts: sampling (the
        #: runners' turns, one after another), the learner's updates with
        #: the parameters' host copies handed to the runners
        self.timers: Dict[str, float] = {}

    # -- learner ---------------------------------------------------------------

    def _loss(self, batch: Dict[str, torch.Tensor]):
        """(total loss, stats in ``STAT_KEYS`` order) of one [T, N] rollout."""
        cfg = self.config
        T, N = batch["rewards"].shape
        out, values_flat = self.model(batch["obs"].reshape(T * N, -1))
        flat_actions = batch["actions"].reshape((T * N,) + batch["actions"].shape[2:])
        logp_flat, entropy_flat = log_prob_entropy(self._discrete, out, flat_actions)
        values = values_flat.reshape(T, N)
        target_logp = logp_flat.reshape(T, N)
        _, bootstrap_v = self.model(batch["bootstrap_obs"])
        with torch.no_grad():
            rhos = torch.exp(target_logp - batch["behavior_logp"])
            clipped_rho = torch.clamp(rhos, max=cfg.vtrace_rho_clip)
            clipped_c = torch.clamp(rhos, max=cfg.vtrace_c_clip)
            discounts = cfg.gamma * (1.0 - batch["dones"])
            values_sg, bootstrap_sg = values.detach(), bootstrap_v.detach()
            next_values = torch.cat([values_sg[1:], bootstrap_sg[None]], dim=0)
            deltas = clipped_rho * (batch["rewards"] + discounts * next_values - values_sg)
            acc = torch.zeros_like(values_sg[0])
            vs_minus_v = torch.empty_like(values_sg)
            for t in range(T - 1, -1, -1):
                acc = deltas[t] + discounts[t] * clipped_c[t] * acc
                vs_minus_v[t] = acc
            vs = vs_minus_v + values_sg
            next_vs = torch.cat([vs[1:], bootstrap_sg[None]], dim=0)
            pg_adv = clipped_rho * (batch["rewards"] + discounts * next_vs - values_sg)
        if cfg.use_clip:
            ratio = torch.exp(target_logp - batch["behavior_logp"])
            pg1 = ratio * pg_adv
            pg2 = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * pg_adv
            pg_loss = -torch.mean(torch.minimum(pg1, pg2))
        else:
            pg_loss = -torch.mean(target_logp * pg_adv)
        vf_loss = torch.mean((values - vs) ** 2)
        ent = torch.mean(entropy_flat)
        total = pg_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * ent
        return total, torch.stack([pg_loss, vf_loss, ent, total, torch.mean(rhos)])

    def _update(self, rollout: Dict[str, np.ndarray]) -> torch.Tensor:
        """One update on one rollout (numpy, one copy to the device); its
        stats on the device."""
        params = list(self.model.parameters())
        dtype = params[0].dtype
        batch = to_device({k: rollout[k] for k in ROLLOUT_KEYS}, self.device, dtype)
        total, stats = self._loss(batch)
        minimize_(total, params, self.opt_state, self.config.lr, self.config.max_grad_norm)
        self._snapshot = None
        return stats.detach()

    def get_params(self) -> Dict[str, torch.Tensor]:
        """A host copy of the parameters, made once per change of them."""
        if self._snapshot is None:
            self._snapshot = host_copy(dict(self.model.named_parameters()))
        return self._snapshot

    # -- training loop -----------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        t_start = time.perf_counter()
        stats: List[torch.Tensor] = []
        ep_returns: List[float] = []
        steps = 0
        sample_s = 0.0
        for _ in range(self.config.num_batches_per_iter):
            t0 = time.perf_counter()
            runner, params = self._turns.popleft()
            rollout = runner.sample(params)
            t1 = time.perf_counter()
            stats.append(self._update(rollout))
            # the runner's next rollout uses the parameters of now
            self._turns.append((runner, self._broadcaster.handle(self.get_params())))
            sample_s += t1 - t0
            ep_returns.extend(rollout["episode_returns"])
            steps += rollout["rewards"].size
        mean_stats = {}
        if stats:
            means = torch.stack(stats).double().mean(0).tolist()
            mean_stats = dict(zip(STAT_KEYS, means))
        t_end = time.perf_counter()
        self.timers = {"sample_s": sample_s, "learn_s": t_end - t_start - sample_s}
        self.iteration += 1
        self._ep_return_window.extend(ep_returns)
        self._ep_return_window = self._ep_return_window[-100:]
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(self._ep_return_window))
                                    if self._ep_return_window else float("nan")),
            "num_episodes": len(ep_returns),
            "num_env_steps_sampled": steps,
            "time_this_iter_s": t_end - t_start,
            **mean_stats,
        }

    # -- checkpointing -------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": host_copy(dict(self.model.named_parameters())),
            "opt_state": adam_state_dict(self.opt_state),
            "iteration": self.iteration,
        }

    def load_state_dict(self, state: Dict[str, Any]):
        """Parameters, Adam state and iteration from :meth:`state_dict`;
        tensors keep their dtype."""
        load_module(self.model, state["params"], self.device)
        self.opt_state = load_adam_state(state["opt_state"], module_names(self.model),
                                         self.device)
        self.iteration = state["iteration"]
        self._snapshot = None

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        torch.save(self.state_dict(), os.path.join(checkpoint_dir, "impala_state.pt"))
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        self.load_state_dict(torch.load(os.path.join(checkpoint_dir, "impala_state.pt"),
                                        map_location="cpu", weights_only=True))

    def compute_single_action(self, obs):
        """One action for one observation, drawn on the learner's device from
        a generator seeded with the iteration count."""
        generator = torch.Generator(device=self.device).manual_seed(self.iteration)
        enc = encode_obs(self.observation_space, np.asarray(obs)[None])
        dtype = next(self.model.parameters()).dtype
        with torch.no_grad():
            actions, _, _ = sample_actions(
                self.model, torch.from_numpy(enc).to(self.device, dtype), generator)
        actions = actions.cpu().numpy()
        return (actions.astype(np.int32) if self._discrete else actions)[0]

    def stop(self):
        for r in self.runners:
            r.stop()
        self.runners = []
        self._turns.clear()


IMPALAConfig.algo_class = IMPALA
