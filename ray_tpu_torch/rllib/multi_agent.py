"""Multi-agent PPO: one PPO learner per policy over a MultiAgentEnv, the
port of ray_tpu/rllib/multi_agent.py.

Agents map to policies through ``policy_mapping_fn``; each policy owns one
ActorCritic and one Adam state in its own :class:`~.learner.PPOLearner`
(on the card unless ``build(device=...)`` names another device), and the
agents that share a policy train it with their pooled experience. The env
runners step the env dict-wise on the host, batching each policy's agents
through a CPU copy of its module, in the caller's process (the reference
runs them as actors). Simultaneous-move envs give rectangular per-policy
[T, n_agents] rollouts, so the single-agent GAE (``gae_batch``), the
connectors and the learner's update are reused unchanged.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .._internal.device import DeviceLike
from .algorithm import PPOConfig, gae_batch
from .connectors import ConnectorContext, default_env_to_module, default_module_to_env
from .env import make_env, space_dims
from .learner import PPOLearner
from .models import init_actor_critic, sample_actions
from .multi_agent_env import episode_done
from .weight_sync import broadcaster_for, resolve_params


class MultiAgentPPOConfig(PPOConfig):
    """PPOConfig + ``.multi_agent(policies, policy_mapping_fn)``."""

    def __init__(self):
        super().__init__()
        self.policies: List[str] = []
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None

    def multi_agent(self, policies: List[str], policy_mapping_fn: Callable[[str], str]):
        """``policies``: policy ids; ``policy_mapping_fn(agent_id) ->
        policy_id``."""
        self.policies = list(policies)
        self.policy_mapping_fn = policy_mapping_fn
        return self


class MultiAgentEnvRunner:
    """Env runner over one MultiAgentEnv instance on the host: each policy's
    agents go through a CPU copy of that policy's module, every draw from
    one torch generator seeded ``seed``."""

    def __init__(self, env_spec, env_config: Optional[dict], policies: List[str],
                 mapping_items: List, rollout_len: int, seed: int,
                 env_to_module_connector=None, module_to_env_connector=None):
        self._env = make_env(env_spec, env_config)()
        self._agents = list(self._env.possible_agents)
        mapping = dict(mapping_items)
        self._policy_of = {a: mapping[a] for a in self._agents}
        # a stable agent order per policy -> rectangular [T, nA] buffers
        self._agents_of = {pid: [a for a in self._agents if self._policy_of[a] == pid]
                           for pid in policies}
        self._rollout_len = rollout_len
        self._generator = torch.Generator().manual_seed(seed)
        self.models: Dict[str, torch.nn.Module] = {}
        self._ctxs, self._e2m, self._m2e = {}, {}, {}
        for pid, agents in self._agents_of.items():
            if not agents:
                continue
            obs_space = self._env.observation_space(agents[0])
            act_space = self._env.action_space(agents[0])
            obs_dim, act_dim, discrete = space_dims(obs_space, act_space)
            model = init_actor_critic(obs_dim, act_dim, discrete, seed, device="cpu")
            self.models[pid] = model.requires_grad_(False)
            self._ctxs[pid] = ConnectorContext(obs_space, act_space)
            self._e2m[pid] = (env_to_module_connector() if env_to_module_connector
                              else default_env_to_module())
            self._m2e[pid] = (module_to_env_connector() if module_to_env_connector
                              else default_module_to_env())
        self._obs, _ = self._env.reset(seed=seed)
        self._ep_return = 0.0
        self._ep_len = 0
        self._completed: List = []

    def _encode(self, pid: str, obs_rows: List) -> np.ndarray:
        return np.asarray(self._e2m[pid](np.stack(obs_rows), self._ctxs[pid]), np.float32)

    def _act(self, pid: str):
        encoded = self._encode(pid, [self._obs[a] for a in self._agents_of[pid]])
        with torch.inference_mode():
            actions, logp, values = sample_actions(self.models[pid], torch.from_numpy(encoded),
                                                   self._generator)
        actions = actions.numpy()
        if self.models[pid].discrete:  # the reference's categorical draws are int32
            actions = actions.astype(np.int32)
        return encoded, actions, logp.numpy(), values.numpy()

    def sample(self, params_by_policy: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Any]:
        """Roll ``rollout_len`` env steps: per-policy [T, nA] trajectory
        arrays and the episodes closed (an episode's return is the team's
        sum over all agents)."""
        params_by_policy = resolve_params(params_by_policy)
        for pid, model in self.models.items():
            model.load_state_dict(params_by_policy[pid])
        keys = ("obs", "actions", "logp", "values", "rewards", "dones")
        buffers = {pid: {k: [] for k in keys} for pid in self.models}
        for _ in range(self._rollout_len):
            action_dict, step_cache = {}, {}
            for pid in self.models:
                encoded, actions, logp, values = self._act(pid)
                env_actions = self._m2e[pid](actions, self._ctxs[pid])
                for i, agent in enumerate(self._agents_of[pid]):
                    action_dict[agent] = env_actions[i]
                step_cache[pid] = (encoded, actions, logp, values)
            obs, rewards, terms, truncs, _ = self._env.step(action_dict)
            done = episode_done(terms, truncs)
            self._ep_return += float(sum(rewards.get(a, 0.0) for a in self._agents))
            self._ep_len += 1
            for pid, agents in self._agents_of.items():
                if pid not in self.models:
                    continue
                buf = buffers[pid]
                for k, v in zip(keys, step_cache[pid]):
                    buf[k].append(v)
                buf["rewards"].append(np.asarray([rewards.get(a, 0.0) for a in agents],
                                                 np.float32))
                buf["dones"].append(np.full(len(agents), done))
            if done:
                self._completed.append((self._ep_return, self._ep_len))
                self._ep_return, self._ep_len = 0.0, 0
                obs, _ = self._env.reset()
            self._obs = obs
        out: Dict[str, Any] = {}
        for pid in self.models:
            _, _, _, last_values = self._act(pid)
            out[pid] = {k: np.stack(v) for k, v in buffers[pid].items()}
            out[pid]["last_values"] = last_values
        completed, self._completed = self._completed, []
        return {
            "policies": out,
            "episode_returns": [r for r, _ in completed],
            "episode_lengths": [n for _, n in completed],
        }

    def stop(self):
        self._env.close()
        return True


class MultiAgentPPO:
    """Per-policy PPO learners on ``device`` (the card unless the caller
    names another) over host MultiAgentEnvRunners."""

    def __init__(self, config: MultiAgentPPOConfig, device: DeviceLike = None):
        if config.env_spec is None:
            raise ValueError("config.environment(...) is required")
        if not config.policies or config.policy_mapping_fn is None:
            raise ValueError("config.multi_agent(policies, mapping_fn) is required")
        self.config = config
        self.iteration = 0
        probe = make_env(config.env_spec, config.env_config)()
        agents = list(probe.possible_agents)
        if not agents:
            raise ValueError("MultiAgentEnv.possible_agents is empty")
        mapping_items = [(a, config.policy_mapping_fn(a)) for a in agents]
        unknown = {p for _, p in mapping_items} - set(config.policies)
        if unknown:
            raise ValueError(f"mapping_fn produced unknown policies {unknown}")
        self.learners: Dict[str, PPOLearner] = {}
        self._spaces = {}
        for pid in config.policies:
            pid_agents = [a for a, p in mapping_items if p == pid]
            if not pid_agents:
                continue
            spaces = probe.observation_space(pid_agents[0]), probe.action_space(pid_agents[0])
            self._spaces[pid] = spaces
            obs_dim, act_dim, discrete = space_dims(*spaces)
            self.learners[pid] = PPOLearner(
                obs_dim, act_dim, discrete, lr=config.lr, clip_param=config.clip_param,
                vf_coeff=config.vf_coeff, entropy_coeff=config.entropy_coeff,
                num_epochs=config.num_epochs, minibatch_size=config.minibatch_size,
                max_grad_norm=config.max_grad_norm, seed=config.seed, device=device)
        probe.close()
        self._broadcaster = broadcaster_for(config)
        self.runners = [
            MultiAgentEnvRunner(config.env_spec, config.env_config, list(self.learners),
                                mapping_items, config.rollout_len, config.seed + 1000 * (i + 1),
                                config.env_to_module_connector, config.module_to_env_connector)
            for i in range(config.num_env_runners)
        ]
        # the caller's env-to-module pipeline per policy, for compute_single_action
        self._infer = {
            pid: (ConnectorContext(*spaces),
                  config.env_to_module_connector() if config.env_to_module_connector
                  else default_env_to_module())
            for pid, spaces in self._spaces.items()
        }
        self._ep_return_window: List[float] = []
        #: host seconds of the last iteration's parts: sampling, GAE and
        #: batching, the learners' updates (each ends on the host)
        self.timers: Dict[str, float] = {}

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        params = {pid: learner.get_params() for pid, learner in self.learners.items()}
        handle = self._broadcaster.handle(params)
        rollouts = [r.sample(handle) for r in self.runners]
        t1 = time.perf_counter()
        stats: Dict[str, Any] = {}
        steps = 0
        post_s = 0.0
        for pid, learner in self.learners.items():
            tp = time.perf_counter()
            batch = gae_batch([ro["policies"][pid] for ro in rollouts if pid in ro["policies"]],
                              self.config.gamma, self.config.lam)
            post_s += time.perf_counter() - tp
            steps += batch["obs"].shape[0]
            stats.update({f"{pid}/{k}": v for k, v in learner.update(batch).items()})
        t2 = time.perf_counter()
        self.timers = {"sample_s": t1 - t0, "postprocess_s": post_s,
                       "learn_s": t2 - t1 - post_s}
        ep_returns: List[float] = []
        ep_lengths: List[int] = []
        for ro in rollouts:
            ep_returns.extend(ro["episode_returns"])
            ep_lengths.extend(ro["episode_lengths"])
        self.iteration += 1
        self._ep_return_window.extend(ep_returns)
        self._ep_return_window = self._ep_return_window[-100:]
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(self._ep_return_window))
                                    if self._ep_return_window else float("nan")),
            "num_episodes": len(ep_returns),
            "episode_len_mean": float(np.mean(ep_lengths)) if ep_lengths else float("nan"),
            "num_env_steps_sampled": steps,
            "time_this_iter_s": t2 - t0,
            **stats,
        }

    def compute_single_action(self, obs, policy_id: str):
        """One action of ``policy_id`` for one raw observation, through the
        env-to-module connector, drawn on the learner's device from a
        generator seeded with the iteration count."""
        learner = self.learners[policy_id]
        ctx, connector = self._infer[policy_id]
        encoded = np.asarray(connector(np.asarray(obs)[None], ctx), np.float32)
        generator = torch.Generator(device=learner.device).manual_seed(self.iteration)
        dtype = next(learner.model.parameters()).dtype
        with torch.no_grad():
            actions, _, _ = sample_actions(
                learner.model, torch.from_numpy(encoded).to(learner.device, dtype), generator)
        actions = actions.cpu().numpy()
        return (actions.astype(np.int32) if learner.discrete else actions)[0]

    # -- checkpointing ---------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"learners": {pid: lrn.state_dict() for pid, lrn in self.learners.items()},
                "iteration": self.iteration}

    def load_state_dict(self, state: Dict[str, Any]):
        for pid, learner_state in state["learners"].items():
            self.learners[pid].load_state_dict(learner_state)
        self.iteration = state["iteration"]

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        torch.save(self.state_dict(), os.path.join(checkpoint_dir, "algorithm_state.pt"))
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        self.load_state_dict(torch.load(os.path.join(checkpoint_dir, "algorithm_state.pt"),
                                        map_location="cpu", weights_only=True))

    def stop(self):
        for r in self.runners:
            r.stop()
        self.runners = []


MultiAgentPPOConfig.algo_class = MultiAgentPPO
