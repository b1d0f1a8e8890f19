"""ray_tpu_torch.rllib BC, MARWIL, CQL and IQL against ray_tpu.rllib, on
the CPU.

Synthetic datasets from numpy seeds (the reference tests' rules: the expert
action is ``obs[0] > 0``, continuous ``-obs[0]`` clipped to the Box, so that
some rows sit on its edges) go through the reference's ``_epoch_impl``
(jitted, on a small stub ``self``) and the port's ``_epoch`` from the same
weights carried over by the converters, with the reference's
``jax.random.permutation`` rows handed to the port (``perms=``). One epoch
of several minibatch updates: the mean loss and every parameter within 1e-5
of the largest |value| (parameters absolute, as in test_torch_rllib.py).
``train()`` runs against the reference's on the same data.
"""

import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import bc as ref_bc
from ray_tpu.rllib import models as ref_models
from ray_tpu.rllib import offline as ref_offline
from ray_tpu_torch.models.convert import (
    _flatten,
    actor_critic_params_from_jax,
    q_network_params_from_jax,
    squashed_actor_params_from_jax,
    twin_q_params_from_jax,
)
from ray_tpu_torch.rllib import bc, env, offline
from test_torch_rllib_dqn_sac import _close, _moved, _state_equal

_ENVS = {"discrete": ("CartPole-v1", env.CartPoleEnv),
         "continuous": ("Pendulum-v1", env.PendulumEnv)}


def _dataset(kind, n=600, seed=0):
    """The reference tests' synthetic tasks: CartPole-shaped, the expert
    action obs[0] > 0 with 20% of actions corrupted and rewarded 0, episodes
    of 20; or Pendulum-shaped, the expert action -2 obs[0] clipped to
    [-2, 2] (a third of the rows on the bounds) plus noise on half."""
    rng = np.random.default_rng(seed)
    if kind == "discrete":
        obs = rng.normal(size=(n, 4)).astype(np.float32)
        actions = (obs[:, 0] > 0).astype(np.int64)
        corrupt = rng.random(n) < 0.2
        actions[corrupt] = rng.integers(0, 2, corrupt.sum())
        rewards = (actions == (obs[:, 0] > 0)).astype(np.float32)
        dones = np.zeros(n, np.float32)
        dones[19::20] = 1.0
    else:
        obs = rng.normal(size=(n, 3)).astype(np.float32)
        expert = np.clip(-2 * obs[:, :1], -2.0, 2.0).astype(np.float32)
        noise = rng.normal(scale=0.5, size=(n, 1)).astype(np.float32)
        actions = np.clip(expert + noise * (rng.random((n, 1)) < 0.5), -2.0, 2.0)
        rewards = -np.abs(actions - expert)[:, 0].astype(np.float32)
        dones = np.zeros(n, np.float32)
        dones[49::50] = 1.0
    return {"obs": obs, "actions": actions, "rewards": rewards, "dones": dones,
            "next_obs": np.roll(obs, -1, axis=0)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _perm(key, n, mb):
    n_mb = max(n // mb, 1)
    return np.array(jax.random.permutation(key, n)[: n_mb * mb]).reshape(n_mb, mb)


def _params_close(module, tree, what):
    want = _flatten(jax.device_get(tree))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), rtol=0,
                                   atol=1e-5, err_msg=f"{what} {name}")


def _build(mod_cfg, kind, data, **training):
    return (mod_cfg().environment(_ENVS[kind][1]).offline_data(data)
            .training(train_batch_size=64, **training).debugging(seed=0).build(device="cpu"))


def _stub(cfg, **attrs):
    stub = types.SimpleNamespace(config=cfg, tx=optax.adam(cfg.lr), **attrs)
    return stub


def _ac_tree(obs_dim, act_dim, discrete, seed):
    _, params = ref_models.init_actor_critic(obs_dim, act_dim, discrete, seed)
    tree = _moved(params, seed + 20)
    if not discrete:
        tree["log_std"] = np.full(act_dim, -0.3, np.float32)
    return tree


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_bc_epoch_matches_reference(kind):
    data = _dataset(kind)
    algo = _build(bc.BCConfig, kind, data)
    obs_dim, act_dim, discrete = algo.obs_dim, algo.act_dim, algo.discrete
    tree = _ac_tree(obs_dim, act_dim, discrete, 1)
    algo.model.load_state_dict(actor_critic_params_from_jax(tree, obs_dim, act_dim, discrete,
                                                            device="cpu"))
    stub = _stub(algo.config, model=ref_models.ActorCritic(act_dim, discrete),
                 _discrete=discrete)
    stub._loss = functools.partial(ref_bc.BC._loss, stub)
    key = jax.random.PRNGKey(3)
    rows = {k: jnp.asarray(v.numpy()) for k, v in algo._data.items()}
    params, _, loss = jax.jit(functools.partial(ref_bc.BC._epoch_impl, stub))(
        _jax(tree), stub.tx.init(_jax(tree)), key, rows)
    got = algo._epoch(perms=_perm(key, 600, 64))
    assert algo.opt_state["count"] == 9
    _close(got, loss, 1e-5, "loss")
    _params_close(algo.model, params, "params")


def test_marwil_epoch_matches_reference():
    data = _dataset("discrete")
    algo = _build(offline.MARWILConfig, "discrete", data, beta=2.0)
    want_returns = ref_offline._discounted_returns(data["rewards"], data["dones"], 0.99)
    np.testing.assert_array_equal(algo._data["returns"].numpy(), want_returns)
    tree = _ac_tree(4, 2, True, 2)
    algo.model.load_state_dict(actor_critic_params_from_jax(tree, 4, 2, True, device="cpu"))
    stub = _stub(algo.config, model=ref_models.ActorCritic(2, True), discrete=True)
    stub._loss = functools.partial(ref_offline.MARWIL._loss, stub)
    stub._minibatch_perm = functools.partial(ref_offline._OfflineBase._minibatch_perm, stub)
    key = jax.random.PRNGKey(4)
    rows = {k: jnp.asarray(v.numpy()) for k, v in algo._data.items()}
    params, _, loss = jax.jit(functools.partial(ref_offline.MARWIL._epoch_impl, stub))(
        _jax(tree), stub.tx.init(_jax(tree)), key, rows)
    got = algo._epoch(perms=_perm(key, 600, 64))
    _close(got, loss, 1e-5, "loss")
    _params_close(algo.model, params, "params")


def test_cql_epoch_matches_reference():
    data = _dataset("discrete")
    algo = _build(offline.CQLConfig, "discrete", data, cql_alpha=0.5)
    qnet = ref_models.QNetwork(2)
    tree = _moved(qnet.init(jax.random.PRNGKey(5), jnp.zeros((1, 4)))["params"], 5)
    target = _moved(tree, 6)
    algo.model.load_state_dict(q_network_params_from_jax(tree, 4, 2, device="cpu"))
    algo.target_model.load_state_dict(q_network_params_from_jax(target, 4, 2, device="cpu"))
    stub = _stub(algo.config, model=qnet)
    stub._loss = functools.partial(ref_offline.CQL._loss, stub)
    stub._minibatch_perm = functools.partial(ref_offline._OfflineBase._minibatch_perm, stub)
    key = jax.random.PRNGKey(6)
    rows = {k: jnp.asarray(v.numpy()) for k, v in algo._data.items()}
    params, target_params, _, loss = jax.jit(
        functools.partial(ref_offline.CQL._epoch_impl, stub))(
        _jax(tree), _jax(target), stub.tx.init(_jax(tree)), key, rows)
    got = algo._epoch(perms=_perm(key, 600, 64))
    _close(got, loss, 1e-5, "loss")
    _params_close(algo.model, params, "params")
    _params_close(algo.target_model, target_params, "target")


def _iql_trees(kind, obs_dim, act_dim):
    zo = jnp.zeros((1, obs_dim))
    v = _moved(ref_models.QNetwork(1).init(jax.random.PRNGKey(7), zo)["params"], 7)
    if kind == "discrete":
        q = _moved(ref_models.QNetwork(act_dim).init(jax.random.PRNGKey(8), zo)["params"], 8)
        pi = _ac_tree(obs_dim, act_dim, True, 9)
    else:
        q = _moved(ref_models.TwinQ().init(jax.random.PRNGKey(8), zo,
                                           jnp.zeros((1, act_dim)))["params"], 8)
        pi = _moved(ref_models.SquashedGaussianActor(act_dim).init(
            jax.random.PRNGKey(9), zo)["params"], 9)
    return {"q": q, "target_q": _moved(q, 10), "v": v, "pi": pi}


def _iql_pair(kind, n):
    """The port's IQL on a dataset of n rows and the reference's stub, from
    the same trees; (algo, stub, state, opt, rows)."""
    algo = _build(offline.IQLConfig, kind, _dataset(kind, n=n))
    obs_dim, act_dim = algo.obs_dim, algo.act_dim
    trees = _iql_trees(kind, obs_dim, act_dim)
    algo.vf.load_state_dict(q_network_params_from_jax(trees["v"], obs_dim, 1, device="cpu"))
    if kind == "discrete":
        qf, actor = ref_models.QNetwork(act_dim), ref_models.ActorCritic(act_dim, True)
        q_from, extra = q_network_params_from_jax, {}
        algo.actor.load_state_dict(actor_critic_params_from_jax(trees["pi"], obs_dim, act_dim,
                                                                True, device="cpu"))
    else:
        qf, actor = ref_models.TwinQ(), ref_models.SquashedGaussianActor(act_dim)
        q_from = twin_q_params_from_jax
        extra = {"_act_mid": jnp.zeros(1), "_act_half": jnp.full(1, 2.0)}
        algo.actor.load_state_dict(squashed_actor_params_from_jax(trees["pi"], obs_dim,
                                                                  act_dim, device="cpu"))
    for name, module in (("q", algo.qf), ("target_q", algo.target_qf)):
        module.load_state_dict(q_from(trees[name], obs_dim, act_dim, device="cpu"))
    stub = _stub(algo.config, qf=qf, vf=ref_models.QNetwork(1), actor=actor,
                 discrete=kind == "discrete", **extra)
    for name in ("_q_of", "_v_loss", "_q_loss", "_pi_loss"):
        setattr(stub, name, functools.partial(getattr(ref_offline.IQL, name), stub))
    stub._minibatch_perm = functools.partial(ref_offline._OfflineBase._minibatch_perm, stub)
    state = {k: _jax(v) for k, v in trees.items()}
    opt = {name: stub.tx.init(state[name]) for name in ("q", "v", "pi")}
    rows = {k: jnp.asarray(v.numpy()) for k, v in algo._data.items()}
    return algo, stub, state, opt, rows


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_iql_epoch_matches_reference(kind):
    """V, then Q against the updated V, then the policy, then the target,
    per minibatch; continuous dataset actions include the Box's edges,
    where arctanh's slope is near 5e5."""
    if kind == "continuous":
        assert np.sum(np.abs(_dataset(kind)["actions"]) == 2.0) > 50
    algo, stub, state, opt, rows = _iql_pair(kind, 600)
    key = jax.random.PRNGKey(11)
    want_state, _, loss = jax.jit(functools.partial(ref_offline.IQL._epoch_impl, stub))(
        state, opt, key, rows)
    got = algo._epoch(perms=_perm(key, 600, 64))
    for name, module in (("v", algo.vf), ("q", algo.qf), ("target_q", algo.target_qf),
                         ("pi", algo.actor)):
        _params_close(module, want_state[name], name)
    if kind == "continuous":
        # At an edge row pre = arctanh(1 - 1e-6) = 7.2477, and the
        # correction log(1 - tanh(pre)^2 + 1e-6) is ill-conditioned: XLA's
        # f32 tanh there is one ulp above the correctly rounded value, and
        # its compiled program evaluates 1 - t^2 + eps as (1 + eps) - t^2;
        # either moves the correction by 0.04 or more. The port takes
        # tanh(pre) as the clipped action y itself. The correction reaches
        # the loss, not the gradients (pre is data), so the parameters above
        # agree with the compiled reference. The epoch's loss is checked by
        # its parts on the first minibatch: V's and Q's against the
        # compiled reference, the policy's against the reference's
        # arithmetic run op by op (jax.disable_jit) with tanh(arctanh(y)) = y.
        assert float(jnp.tanh(jnp.float32(7.2477326))) != float(
            torch.tanh(torch.tensor(7.2477326)))
        algo, stub, state, opt, rows = _iql_pair(kind, 600)
        idx = _perm(key, 600, 64)[0]
        batch = {k: v[idx] for k, v in algo._data.items()}
        jbatch = {k: v[idx] for k, v in rows.items()}
        assert np.sum(np.abs(batch["actions"].numpy()) == 2.0) > 5
        for part in ("v", "q", "pi"):
            loss_fn = getattr(ref_offline.IQL, f"_{part}_loss")
            if part == "pi":
                with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
                    mp.setattr(ref_offline, "jnp", _JnpTanhOfArctanh())
                    want = loss_fn(stub, state["pi"], state, jbatch)
            else:
                want = jax.jit(functools.partial(loss_fn, stub))(state[part], state, jbatch)
            with torch.no_grad():
                _close(getattr(algo, f"_{part}_loss")(batch), want, 1e-5, f"{part} loss")
    else:
        _close(got, loss, 1e-5, "loss")


class _JnpTanhOfArctanh:
    """``jax.numpy`` whose ``tanh`` of an ``arctanh`` output gives back the
    arctanh's input exactly (IQL's correction term is data only: never
    differentiated)."""

    def __init__(self):
        self._inputs = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def arctanh(self, y):
        pre = jnp.arctanh(y)
        self._inputs[np.asarray(pre).tobytes()] = y
        return pre

    def tanh(self, x):
        return self._inputs[np.asarray(x).tobytes()]


class _Rows:
    """A dataset that hands out rows, as ray_tpu.data's Dataset does."""

    def __init__(self, data):
        self._data = data

    def take_all(self):
        n = len(self._data["obs"])
        return [{k: v[i] for k, v in self._data.items()} for i in range(n)]


@pytest.mark.parametrize("name,kind", [("BC", "discrete"), ("MARWIL", "discrete"),
                                       ("CQL", "discrete"), ("IQL", "discrete"),
                                       ("IQL", "continuous")])
def test_train_on_cpu_with_the_reference_s_result(name, kind, tmp_path):
    data = _dataset(kind, n=300)
    ref_mod, mod = (ref_bc, bc) if name == "BC" else (ref_offline, offline)
    ref_cfg = (getattr(ref_mod, f"{name}Config")().environment(_ENVS[kind][0])
               .offline_data(data).training(train_batch_size=64).debugging(seed=0))
    ref_algo = ref_cfg.build()
    want = [ref_algo.train() for _ in range(2)]
    cfg = (getattr(mod, f"{name}Config")().environment(_ENVS[kind][1])
           .offline_data(data).training(train_batch_size=64, num_epochs_per_iter=2)
           .debugging(seed=0))
    ref_cfg.num_epochs_per_iter = 2
    algo = cfg.build(device="cpu")
    got = [algo.train() for _ in range(2)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["num_samples"] == w["num_samples"] == 300
        assert all(math.isfinite(v) for v in g.values())
    assert set(algo.timers) == {"learn_s"}
    rows = _build(getattr(mod, f"{name}Config"), kind, _Rows(data))  # rows, duck-typed
    for k, v in algo._data.items():
        assert torch.equal(rows._data[k], v), k

    algo.save(str(tmp_path / "ckpt"))
    fresh = cfg.build(device="cpu")
    fresh.restore(str(tmp_path / "ckpt"))
    _state_equal(fresh._state_dict(), algo._state_dict())
    obs = data["obs"][0]
    a, b = algo.compute_single_action(obs), fresh.compute_single_action(obs)
    np.testing.assert_array_equal(a, b)
    want_a = ref_algo.compute_single_action(obs)
    assert np.shape(a) == np.shape(want_a) and type(a) is type(want_a)
    if kind == "continuous":
        assert np.abs(a).max() <= 2.0
    assert algo.evaluate(num_episodes=1)["num_episodes"] == 1
    fresh.train()


def test_errors_and_configs(monkeypatch):
    data = _dataset("discrete", n=100)
    with pytest.raises(ValueError, match="discrete action spaces"):
        offline.CQLConfig().environment(env.PendulumEnv).offline_data(
            _dataset("continuous", n=100)).build(device="cpu")
    for cfg in (bc.BCConfig(), offline.MARWILConfig(), offline.CQLConfig(), offline.IQLConfig()):
        with pytest.raises(ValueError, match="environment"):
            cfg.build(device="cpu")
        with pytest.raises(ValueError, match="offline_data"):
            type(cfg)().environment(env.CartPoleEnv).build(device="cpu")
    no_next = {k: v for k, v in data.items() if k != "next_obs"}
    with pytest.raises(ValueError, match="next_obs"):
        offline.IQLConfig().environment(env.CartPoleEnv).offline_data(no_next).build(
            device="cpu")
    with pytest.raises(ValueError, match="perms"):
        _build(bc.BCConfig, "discrete", data)._epoch(perms=np.zeros(10, np.int64))
    for ref, port in ((ref_bc.BCConfig(), bc.BCConfig()),
                      (ref_offline.MARWILConfig(), offline.MARWILConfig()),
                      (ref_offline.CQLConfig(), offline.CQLConfig()),
                      (ref_offline.IQLConfig(), offline.IQLConfig())):
        assert vars(port) == vars(ref)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bc.BCConfig().environment(env.CartPoleEnv).offline_data(data).build()
