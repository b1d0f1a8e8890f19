"""ray_tpu_torch.rllib IMPALA and APPO against ray_tpu.rllib, on the CPU.

Rollouts come from numpy seeds and go through the reference's
``IMPALA._update_impl`` (on a small stub ``self``) and the port's update,
from the same ActorCritic weights carried over by
``actor_critic_params_from_jax``. Three updates in a row, each with a
behaviour policy that is not the learner's (so the importance ratios are
clipped and the V-trace recursion runs over every step): stats and
parameters within 1e-5 of the largest |value| (parameters absolute, as in
test_torch_rllib.py). The runner is replayed against the reference's on
gymnasium's CartPole, and the reference's IMPALA trains in process through
a stand-in for ``ray_tpu.api`` whose ``wait`` hands rollouts back in the
order they were asked for, which is the port's FIFO of runner turns.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import impala as ref_impala
from ray_tpu.rllib import models as ref_models
from ray_tpu_torch.models.convert import _flatten, actor_critic_params_from_jax
from ray_tpu_torch.rllib import env, impala, models
from test_torch_rllib_dqn_sac import _close, _moved, _state_equal, in_process

_HEADS = {"discrete": (4, 2, True), "gaussian": (3, 2, False)}


def _tree(obs_dim, act_dim, discrete, seed=0):
    _, params = ref_models.init_actor_critic(obs_dim, act_dim, discrete, seed)
    tree = _moved(params, seed + 10)
    if not discrete:
        tree["log_std"] = np.random.default_rng(seed).uniform(-0.5, 0.5, act_dim).astype(
            np.float32)
    return tree


def _rollout(rng, T, N, obs_dim, act_dim, discrete):
    actions = (rng.integers(0, act_dim, (T, N)).astype(np.int32) if discrete
               else rng.standard_normal((T, N, act_dim)).astype(np.float32))
    return {
        "obs": rng.standard_normal((T, N, obs_dim)).astype(np.float32),
        "actions": actions,
        "behavior_logp": (rng.standard_normal((T, N)) - 1.0).astype(np.float32),
        "rewards": rng.standard_normal((T, N)).astype(np.float32),
        "dones": (rng.random((T, N)) < 0.15).astype(np.float32),
        "bootstrap_obs": rng.standard_normal((N, obs_dim)).astype(np.float32),
    }


class _Shaped:
    """An env of the given dims, for building an algorithm of that shape."""

    def __init__(self, obs_dim, act_dim, discrete):
        self.observation_space = env.Box(-1.0, 1.0, (obs_dim,))
        self.action_space = env.Discrete(act_dim) if discrete else env.Box(-1.0, 1.0, (act_dim,))

    def reset(self, *, seed=None, options=None):
        return np.zeros(self.observation_space.shape, np.float32), {}

    def step(self, action):
        return np.zeros(self.observation_space.shape, np.float32), 0.0, False, False, {}


@pytest.mark.parametrize("variant", ["impala", "appo"])
@pytest.mark.parametrize("head", list(_HEADS))
def test_update_matches_reference(variant, head):
    obs_dim, act_dim, discrete = _HEADS[head]
    config_cls = impala.APPOConfig if variant == "appo" else impala.IMPALAConfig
    cfg = config_cls().environment(lambda: _Shaped(obs_dim, act_dim, discrete))
    tree = _tree(obs_dim, act_dim, discrete)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm), optax.adam(cfg.lr))
    stub = types.SimpleNamespace(config=cfg, _discrete=discrete, tx=tx,
                                 model=ref_models.ActorCritic(act_dim, discrete))
    params = jax.tree.map(jnp.asarray, tree)
    opt = tx.init(params)
    update = jax.jit(lambda p, o, b: ref_impala.IMPALA._update_impl(stub, p, o, b))
    algo = cfg.build(device="cpu")
    algo.model.load_state_dict(actor_critic_params_from_jax(tree, obs_dim, act_dim, discrete,
                                                            device="cpu"))
    rng = np.random.default_rng(6)
    for _ in range(3):
        rollout = _rollout(rng, 16, 3, obs_dim, act_dim, discrete)
        params, opt, want = update(params, opt, {k: jnp.asarray(v) for k, v in rollout.items()})
        got = algo._update(rollout)
        _close(got, [float(want[k]) for k in impala.STAT_KEYS], 1e-5, "stats")
        assert abs(float(want["mean_rho"]) - 1) > 0.1  # off-policy: V-trace does work
    want = _flatten(jax.device_get(params))
    for name, p in algo.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    assert algo.opt_state["count"] == 3
    algo.stop()


def test_runner_matches_reference():
    """The reference's runner samples gymnasium's CartPole; the port's
    model gives the same behaviour log-probs on its obs and actions, the
    port's CartPole replays the actions to the same rewards and dones and
    bootstrap observation, and the port's runner returns the same keys,
    shapes and dtypes."""
    T, N, seed = 40, 3, 7
    tree = _tree(4, 2, True)
    ref = ref_impala.ImpalaRunner("CartPole-v1", {}, N, T, seed)
    want = ref.sample(jax.tree.map(jnp.asarray, tree))
    assert len(want["episode_returns"]) > 0
    model = models.ActorCritic(4, 2, True)
    model.load_state_dict(actor_critic_params_from_jax(tree, 4, 2, True, device="cpu"))
    with torch.no_grad():
        out, _ = model(torch.from_numpy(want["obs"].reshape(T * N, 4)))
        logp, _ = models.log_prob_entropy(True, out, torch.from_numpy(
            want["actions"].reshape(T * N)))
    _close(logp.view(T, N), want["behavior_logp"], 1e-5, "behaviour logp")
    vec = env.VectorEnv([env.make_env(env.CartPoleEnv) for _ in range(N)])
    obs = vec.reset(seed=seed)
    for t in range(T):
        np.testing.assert_array_equal(obs, want["obs"][t])
        obs, rewards, terms, truncs = vec.step(want["actions"][t])
        np.testing.assert_array_equal(rewards, want["rewards"][t])
        np.testing.assert_array_equal((terms | truncs).astype(np.float32), want["dones"][t])
    np.testing.assert_array_equal(obs, want["bootstrap_obs"])

    port = impala.ImpalaRunner(env.CartPoleEnv, {}, N, T, seed)
    got = port.sample(model.state_dict())
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, list):
            assert {type(x) for x in got[k]} <= {type(x) for x in w} | {float, int}, k
        else:
            assert (got[k].dtype, got[k].shape) == (w.dtype, w.shape), k
    np.testing.assert_array_equal(got["obs"][0], want["obs"][0])
    assert next(port.model.parameters()).device.type == "cpu"


def _config(mod, variant, env_spec):
    cls = mod.APPOConfig if variant == "appo" else mod.IMPALAConfig
    return (cls().environment(env_spec)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2, rollout_fragment_length=8)
            .training(num_batches_per_iter=3).debugging(seed=0))


@pytest.mark.parametrize("variant", ["impala", "appo"])
def test_train_on_cpu_with_the_reference_s_result(monkeypatch, tmp_path, variant):
    in_process(monkeypatch, ref_impala)
    ref_algo = _config(ref_impala, variant, "CartPole-v1").build()
    want = [ref_algo.train() for _ in range(2)]
    ref_algo.stop()
    algo = _config(impala, variant, env.CartPoleEnv).build(device="cpu")
    got = [algo.train() for _ in range(2)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["num_env_steps_sampled"] == w["num_env_steps_sampled"] == 48
        assert all(math.isfinite(g[k]) for k in impala.STAT_KEYS)
    assert [g["training_iteration"] for g in got] == [1, 2]
    assert set(algo.timers) == {"sample_s", "learn_s"}
    assert algo.opt_state["count"] == 6

    algo.save(str(tmp_path / "ckpt"))
    fresh = _config(impala, variant, env.CartPoleEnv).build(device="cpu")
    fresh.restore(str(tmp_path / "ckpt"))
    _state_equal(fresh.state_dict(), algo.state_dict())
    action = algo.compute_single_action(np.zeros(4, np.float32))
    assert action.dtype == np.int32 and action in (0, 1)
    assert fresh.compute_single_action(np.zeros(4, np.float32)) == action
    algo.stop()
    fresh.stop()


def test_rollouts_are_one_update_stale():
    """The FIFO of runner turns: the first update is on-policy (mean_rho 1
    within rounding); the second runner's first rollout was sampled with
    the initial parameters and lands after an update, as in the
    reference."""
    cfg = _config(impala, "impala", env.CartPoleEnv).training(num_batches_per_iter=1)
    algo = cfg.build(device="cpu")
    first, second = algo.train(), algo.train()
    assert abs(first["mean_rho"] - 1) < 1e-6
    assert abs(second["mean_rho"] - 1) > 1e-4
    algo.stop()


def test_errors_and_configs(monkeypatch):
    with pytest.raises(ValueError, match="environment"):
        impala.IMPALAConfig().build(device="cpu")
    for ref, port in ((ref_impala.IMPALAConfig(), impala.IMPALAConfig()),
                      (ref_impala.APPOConfig(), impala.APPOConfig())):
        assert vars(port) == vars(ref)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        impala.APPOConfig().environment(env.CartPoleEnv).build()
