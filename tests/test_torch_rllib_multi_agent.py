"""ray_tpu_torch.rllib multi-agent PPO against ray_tpu.rllib, on the CPU.

The reference test's cooperative toy (two agents, a shared Discrete(3)
context, a bonus when both match it) runs under both packages. The runner
is replayed against the reference's: the port's per-policy modules give
the reference's log-probs and values on its observations and actions
within 1e-5 of the largest |value|, and the toy replays the recorded
actions to the same rewards and done flags bit for bit. The reference's
MultiAgentPPO trains in process through a stand-in for ``ray_tpu.api``
beside the port's (keys, counts, finiteness); checkpoints round-trip bit
for bit.
"""

import math

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import models as ref_models
from ray_tpu.rllib import multi_agent as ref_multi_agent
from ray_tpu.rllib import multi_agent_env as ref_multi_agent_env
from ray_tpu_torch.models.convert import actor_critic_params_from_jax
from ray_tpu_torch.rllib import env, models, multi_agent, multi_agent_env
from test_torch_rllib_dqn_sac import _close, _moved, _state_equal, in_process


class _Coop:
    """The reference test's CoopMatch: both agents see the same Discrete(3)
    context; each earns 0.2 for matching it and both earn 1 more when both
    match; episodes of 8 steps with a fresh context each step."""

    possible_agents = ("a0", "a1")
    EP_LEN = 8
    N = 3

    def __init__(self, config=None):
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._ctx = 0

    def observation_space(self, agent_id):
        return self.space(self.N)

    def action_space(self, agent_id):
        return self.space(self.N)

    def _obs(self):
        return {a: self._ctx for a in self.possible_agents}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._ctx = int(self._rng.integers(self.N))
        return self._obs(), {}

    def step(self, action_dict):
        hits = {a: int(action_dict[a]) == self._ctx for a in self.possible_agents}
        both = all(hits.values())
        rewards = {a: 0.2 * hits[a] + (1.0 if both else 0.0) for a in self.possible_agents}
        self._t += 1
        done = self._t >= self.EP_LEN
        self._ctx = int(self._rng.integers(self.N))
        terms = {a: done for a in self.possible_agents}
        terms["__all__"] = done
        truncs = {a: False for a in self.possible_agents}
        truncs["__all__"] = False
        return self._obs(), rewards, terms, truncs, {}


class RefCoop(_Coop, ref_multi_agent_env.MultiAgentEnv):
    space = staticmethod(gym.spaces.Discrete)


class PortCoop(_Coop, multi_agent_env.MultiAgentEnv):
    space = staticmethod(env.Discrete)


def test_episode_done_matches_reference():
    cases = [
        ({"__all__": True}, {}), ({}, {"__all__": True}), ({"a": True, "b": False}, {}),
        ({"a": True}, {"b": True}), ({}, {}), ({"a": False, "__all__": False}, {"a": True}),
        ({"a": True, "b": True, "__all__": False}, {"__all__": False}),
    ]
    for terms, truncs in cases:
        assert multi_agent_env.episode_done(terms, truncs) == \
            ref_multi_agent_env.episode_done(terms, truncs), (terms, truncs)


def _tree(seed):
    _, params = ref_models.init_actor_critic(3, 3, True, seed)
    return _moved(params, seed + 30)


@pytest.mark.parametrize("mapping", ["shared", "separate"])
def test_runner_matches_reference(mapping):
    policies = ["shared"] if mapping == "shared" else ["p0", "p1"]
    items = [("a0", policies[0]), ("a1", policies[-1])]
    trees = {pid: _tree(i) for i, pid in enumerate(policies)}
    T, seed = 20, 5
    ref = ref_multi_agent.MultiAgentEnvRunner(RefCoop, {}, policies, items, T, seed)
    want = ref.sample({pid: jax.tree.map(jnp.asarray, t) for pid, t in trees.items()})
    assert len(want["episode_returns"]) == 2  # the replay crosses a reset
    params = {pid: actor_critic_params_from_jax(t, 3, 3, True, device="cpu")
              for pid, t in trees.items()}
    for pid, ro in want["policies"].items():
        model = models.ActorCritic(3, 3, True)
        model.load_state_dict(params[pid])
        nA = ro["obs"].shape[1]
        with torch.no_grad():
            out, values = model(torch.from_numpy(ro["obs"].reshape(T * nA, 3)))
            logp, _ = models.log_prob_entropy(True, out, torch.from_numpy(
                ro["actions"].reshape(T * nA)))
        _close(logp.view(T, nA), ro["logp"], 1e-5, "logp")
        _close(values.view(T, nA), ro["values"], 1e-5, "values")
    # the toy replays the recorded actions to the same rewards and dones
    toy = PortCoop()
    obs, _ = toy.reset(seed=seed)
    agents_of = {pid: [a for a, p in items if p == pid] for pid in policies}
    for t in range(T):
        actions = {}
        for pid, agents in agents_of.items():
            for i, a in enumerate(agents):
                assert want["policies"][pid]["obs"][t, i].argmax() == obs[a]
                actions[a] = want["policies"][pid]["actions"][t, i]
        obs, rewards, terms, truncs, _ = toy.step(actions)
        done = multi_agent_env.episode_done(terms, truncs)
        for pid, agents in agents_of.items():
            np.testing.assert_array_equal(want["policies"][pid]["rewards"][t],
                                          np.asarray([rewards[a] for a in agents], np.float32))
            assert (want["policies"][pid]["dones"][t] == done).all()
        if done:
            obs, _ = toy.reset()

    port = multi_agent.MultiAgentEnvRunner(PortCoop, {}, policies, items, T, seed)
    got = port.sample(params)
    assert got.keys() == want.keys() and got["policies"].keys() == want["policies"].keys()
    for pid, w in want["policies"].items():
        for k, v in w.items():
            assert (got["policies"][pid][k].dtype, got["policies"][pid][k].shape) == (
                v.dtype, v.shape), (pid, k)
        np.testing.assert_array_equal(got["policies"][pid]["obs"][0], w["obs"][0])
    assert got["episode_returns"] and got["episode_lengths"] == want["episode_lengths"]
    assert all(next(m.parameters()).device.type == "cpu" for m in port.models.values())


def _config(mod, env_spec, mapping):
    policies = ["shared"] if mapping == "shared" else ["p0", "p1"]
    fn = (lambda a: "shared") if mapping == "shared" else (lambda a: f"p{a[-1]}")
    return (mod.MultiAgentPPOConfig().environment(env_spec).multi_agent(policies, fn)
            .env_runners(num_env_runners=1, rollout_fragment_length=32)
            .training(num_epochs=2, minibatch_size=32).debugging(seed=0))


@pytest.mark.parametrize("mapping", ["shared", "separate"])
def test_train_on_cpu_with_the_reference_s_result(monkeypatch, tmp_path, mapping):
    in_process(monkeypatch, ref_multi_agent)
    ref_cfg = _config(ref_multi_agent, RefCoop, mapping)
    ref_algo = ref_multi_agent.MultiAgentPPO(ref_cfg)
    want = [ref_algo.train() for _ in range(2)]
    ref_algo.stop()
    algo = _config(multi_agent, PortCoop, mapping).build(device="cpu")
    got = [algo.train() for _ in range(2)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["num_env_steps_sampled"] == w["num_env_steps_sampled"] == 64
        assert g["num_episodes"] == w["num_episodes"] == 4
        assert all(math.isfinite(v) for k, v in g.items() if "/" in k)
    assert set(algo.timers) == {"sample_s", "postprocess_s", "learn_s"}
    counts = {pid: lrn.opt_state["count"] for pid, lrn in algo.learners.items()}
    assert counts == ({"shared": 8} if mapping == "shared" else {"p0": 4, "p1": 4})

    algo.save(str(tmp_path / "ckpt"))
    fresh = _config(multi_agent, PortCoop, mapping).build(device="cpu")
    fresh.restore(str(tmp_path / "ckpt"))
    assert fresh.iteration == 2
    for pid in algo.learners:
        _state_equal(fresh.learners[pid].state_dict(), algo.learners[pid].state_dict())
        action = algo.compute_single_action(1, pid)
        assert action.dtype == np.int32 and action in (0, 1, 2)
        assert fresh.compute_single_action(1, pid) == action
    fresh.train()
    algo.stop()
    fresh.stop()


def test_errors_and_config(monkeypatch):
    with pytest.raises(ValueError, match="environment"):
        multi_agent.MultiAgentPPOConfig().build(device="cpu")
    with pytest.raises(ValueError, match="multi_agent"):
        multi_agent.MultiAgentPPOConfig().environment(PortCoop).build(device="cpu")
    with pytest.raises(ValueError, match="unknown policies"):
        (multi_agent.MultiAgentPPOConfig().environment(PortCoop)
         .multi_agent(["p"], lambda a: "q").build(device="cpu"))
    ref, port = ref_multi_agent.MultiAgentPPOConfig(), multi_agent.MultiAgentPPOConfig()
    assert vars(port) == vars(ref)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _config(multi_agent, PortCoop, "shared").build()
