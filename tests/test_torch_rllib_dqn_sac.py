"""ray_tpu_torch.rllib DQN and SAC (and the models, PendulumEnv and the
replay buffer they need) against ray_tpu.rllib, on the CPU.

Inputs come from numpy seeds and go through the reference's pure methods
(``DQN._update_impl``, ``SAC._update_scan_impl``, called on a small stub
``self``) and the port, from the same weights carried over by the
converters. Model outputs, losses, stats and parameters after 4 updates
are held within 1e-5 of the largest |value| of each compared tensor (both
sides compute in f32, the same sums in other orders; parameters absolute,
as in test_torch_rllib.py). SAC's normal draws are the reference's
``jax.random.normal`` draws of its own key schedule, handed to the port.
The replay buffer's operation sequences and PendulumEnv's trajectories
(against gymnasium's ``Pendulum-v1``) are numpy on both sides and must be
equal bit for bit, as must runners wherever both sides draw from numpy.
"""

import functools
import math
import types

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu
from ray_tpu.rllib import dqn as ref_dqn
from ray_tpu.rllib import models as ref_models
from ray_tpu.rllib import sac as ref_sac
from ray_tpu_torch.models.convert import (
    _flatten,
    q_network_params_from_jax,
    squashed_actor_params_from_jax,
    twin_q_params_from_jax,
)
from ray_tpu_torch.rllib import dqn, env, models, sac


def _close(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _params_close(got, want_tree, what):
    want = {k: np.asarray(v) for k, v in _flatten(jax.device_get(want_tree)).items()}
    assert set(got) == set(want), what
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=1e-5,
                                   err_msg=f"{what} {name}")


def _moved(params, seed):
    """A flax tree with its zero-start biases moved off zero, so that a
    misplaced leaf shows."""
    rng = np.random.default_rng(seed)
    flat = _flatten(jax.device_get(params))
    out = {}
    for name, leaf in flat.items():
        leaf = np.asarray(leaf)
        if name.endswith("bias"):
            leaf = (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        out[name] = leaf
    return _unflatten(out)


def _unflatten(flat):
    tree = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


class _Ref:
    def __init__(self, value):
        self.value = value


class _Handle:
    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        method = getattr(self._obj, name)
        return types.SimpleNamespace(remote=lambda *a, **k: _Ref(method(*a, **k)))


class InProcessApi:
    """``ray_tpu.api``'s remote / get / wait / kill surface, run in the
    caller's process, so that the reference's algorithms train without a
    cluster. ``wait`` hands back refs in the order they were made."""

    @staticmethod
    def remote(**_):
        def wrap(cls):
            return types.SimpleNamespace(remote=lambda *args: _Handle(cls(*args)))
        return wrap

    @staticmethod
    def get(x):
        if isinstance(x, list):
            return [InProcessApi.get(v) for v in x]
        return x.value if isinstance(x, _Ref) else x

    @staticmethod
    def wait(refs, num_returns=1, timeout=None):
        return refs[:num_returns], refs[num_returns:]

    @staticmethod
    def kill(_):
        pass


def in_process(monkeypatch, *modules):
    for mod in modules:
        monkeypatch.setattr(mod, "api", InProcessApi)
    monkeypatch.setattr(ray_tpu.api, "put", lambda x: x)


class _Box2:
    """A toy continuous env: obs in R^5, actions in [-0.5, 0.5]^2 (so that
    every sum over the action axis has two terms)."""

    def __init__(self):
        self.observation_space = env.Box(-1.0, 1.0, (5,))
        self.action_space = env.Box(-0.5, 0.5, (2,))
        self._rng = np.random.default_rng(0)
        self._t = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._rng.uniform(-1, 1, 5).astype(np.float32), {}

    def step(self, action):
        self._t += 1
        obs = self._rng.uniform(-1, 1, 5).astype(np.float32)
        return obs, -float(np.sum(np.square(action))), False, self._t >= 10, {}


# -- models and converters -----------------------------------------------------


def _ref_module(kind, obs_dim, act_dim):
    """(reference module, its moved tree, port module with that tree)."""
    zo = jnp.zeros((1, obs_dim))
    if kind == "q":
        mod = ref_models.QNetwork(act_dim)
        tree = _moved(mod.init(jax.random.PRNGKey(0), zo)["params"], 1)
        port = models.QNetwork(obs_dim, act_dim)
        port.load_state_dict(q_network_params_from_jax(tree, obs_dim, act_dim, device="cpu"))
    elif kind == "twin_q":
        mod = ref_models.TwinQ()
        tree = _moved(mod.init(jax.random.PRNGKey(0), zo, jnp.zeros((1, act_dim)))["params"], 2)
        port = models.TwinQ(obs_dim, act_dim)
        port.load_state_dict(twin_q_params_from_jax(tree, obs_dim, act_dim, device="cpu"))
    else:
        mod = ref_models.SquashedGaussianActor(act_dim)
        tree = _moved(mod.init(jax.random.PRNGKey(0), zo)["params"], 3)
        port = models.SquashedGaussianActor(obs_dim, act_dim)
        port.load_state_dict(squashed_actor_params_from_jax(tree, obs_dim, act_dim,
                                                            device="cpu"))
    return mod, tree, port


@pytest.mark.parametrize("kind", ["q", "twin_q", "actor"])
def test_model_forward_matches_reference(kind):
    obs_dim, act_dim = 6, 3
    mod, tree, port = _ref_module(kind, obs_dim, act_dim)
    rng = np.random.default_rng(4)
    obs = rng.standard_normal((32, obs_dim)).astype(np.float32)
    acts = rng.standard_normal((32, act_dim)).astype(np.float32)
    args = (obs, acts) if kind == "twin_q" else (obs,)
    want = mod.apply({"params": _jax(tree)}, *map(jnp.asarray, args))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    if kind == "q":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, 1e-5, kind)
    if kind == "actor":  # the clip of log_std: drive the head past both bounds
        with torch.no_grad():
            port.Dense_3.bias.copy_(torch.tensor([50.0, -50.0, 0.0]))
            _, log_std = port(torch.from_numpy(obs))
        assert log_std[:, 0].eq(2.0).all() and log_std[:, 1].eq(-20.0).all()


@pytest.mark.parametrize("kind", ["q", "twin_q", "actor"])
def test_converters_reject_bad_trees(kind):
    convert = {"q": q_network_params_from_jax, "twin_q": twin_q_params_from_jax,
               "actor": squashed_actor_params_from_jax}[kind]
    _, tree, _ = _ref_module(kind, 6, 3)
    first = sorted(tree)[0]
    with pytest.raises(KeyError, match="missing"):
        convert({k: v for k, v in tree.items() if k != first}, 6, 3, device="cpu")
    with pytest.raises(KeyError, match="does not know"):
        convert(dict(tree, extra={"kernel": np.zeros((2, 2), np.float32)}), 6, 3,
                device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert(tree, 7, 3, device="cpu")


def test_state_dict_names_are_the_flax_tree_s():
    for kind in ("q", "twin_q", "actor"):
        _, tree, port = _ref_module(kind, 6, 3)
        assert list(port.state_dict()) == [k for k, _ in port.named_parameters()]
        assert set(port.state_dict()) == set(_flatten(tree)), kind


def test_squashed_sample_logp_matches_reference():
    """The same normal draws: actions and log-probs within 1e-5, with
    |u| up to about 30, where ``F.softplus``'s threshold would differ."""
    rng = np.random.default_rng(5)
    mean = (10 * rng.standard_normal((64, 3))).astype(np.float32)
    log_std = rng.uniform(-3, 1.5, (64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want_a, want_logp = ref_models.squashed_sample_logp(jnp.asarray(mean),
                                                        jnp.asarray(log_std), key)
    noise = np.array(jax.random.normal(key, mean.shape))
    got_a, got_logp = models.squashed_sample_logp(torch.from_numpy(mean),
                                                  torch.from_numpy(log_std),
                                                  noise=torch.from_numpy(noise))
    assert np.abs(mean + np.exp(log_std) * noise).max() > 20
    _close(got_a, want_a, 1e-5, "actions")
    _close(got_logp, want_logp, 1e-5, "logp")


def test_squashed_sample_law():
    """20,000 draws of one row from a generator: atanh(a) has the
    Gaussian's mean and std within 4.5 standard errors, and logp is the
    Gaussian's log-density of u less log(1 - tanh(u)^2)."""
    n = 20_000
    mean = torch.tensor([[0.3, -0.8]]).expand(n, 2)
    log_std = torch.tensor([[-1.0, -0.5]]).expand(n, 2)
    a, logp = models.squashed_sample_logp(mean.double(), log_std.double(),
                                          torch.Generator().manual_seed(0))
    u = torch.atanh(a)
    std = torch.exp(log_std[0].double())
    assert (u.mean(0) - mean[0]).abs().le(4.5 * std / math.sqrt(n)).all()
    assert (u.std(0) / std - 1).abs().le(4.5 / math.sqrt(2 * n)).all()
    want = (torch.distributions.Normal(mean.double(), std).log_prob(u)
            - torch.log1p(-a ** 2)).sum(-1)
    _close(logp, want, 1e-8, "logp")


def test_init_is_seeded_and_lecun():
    for init, args in ((models.init_q_network, (8, 3)), (models.init_twin_q, (8, 3)),
                       (models.init_squashed_actor, (8, 3))):
        a, b = init(*args, seed=4, device="cpu"), init(*args, seed=4, device="cpu")
        c = init(*args, seed=5, device="cpu")
        for (name, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
            assert torch.equal(p, q), name
            if name.endswith("kernel"):
                assert not torch.equal(p, r), name
                bound = 2 * math.sqrt(1 / p.shape[0]) / 0.87962566103423978
                assert p.abs().max() <= bound * (1 + 1e-6), name
            else:
                assert torch.count_nonzero(p) == 0, name


# -- PendulumEnv -----------------------------------------------------------------


@pytest.mark.parametrize("max_steps", [20, 200])
def test_pendulum_matches_gymnasium(max_steps):
    """Same seeds and actions (inside, on and past the torque bounds): obs,
    rewards, flags and their types bit for bit over several episodes."""
    ref = gym.make("Pendulum-v1", max_episode_steps=max_steps)
    port = env.PendulumEnv({"max_episode_steps": max_steps})
    for a in ("low", "high", "shape"):
        np.testing.assert_array_equal(getattr(port.action_space, a),
                                      getattr(ref.action_space, a))
        np.testing.assert_array_equal(getattr(port.observation_space, a),
                                      getattr(ref.observation_space, a))
    rng = np.random.default_rng(12)
    actions = rng.uniform(-3, 3, (700, 1)).astype(np.float32)
    actions[::5] = 2.0
    actions[2::5] = -2.0
    o_ref, _ = ref.reset(seed=3)
    o_port, _ = port.reset(seed=3)
    ends = 0
    for a in actions:
        np.testing.assert_array_equal(o_port, o_ref)
        assert o_port.dtype == o_ref.dtype == np.float32
        o_ref, r_ref, term_ref, trunc_ref, _ = ref.step(a)
        o_port, r_port, term_port, trunc_port, _ = port.step(a)
        assert (r_port, term_port, trunc_port) == (r_ref, term_ref, trunc_ref)
        assert type(r_port) is type(r_ref)
        if term_ref or trunc_ref:
            ends += 1
            o_ref, _ = ref.reset()
            o_port, _ = port.reset()
    assert ends == 700 // max_steps


def test_pendulum_rejects_bad_actions_and_options():
    port = env.PendulumEnv()
    with pytest.raises(RuntimeError, match="reset"):
        port.step(np.zeros(1, np.float32))
    port.reset(seed=0)
    for bad in (0.5, np.zeros(2, np.float32), np.zeros((1, 1)), np.array(["a"])):
        with pytest.raises(ValueError, match="invalid"):
            port.step(bad)
    port.step(np.array([5.0]))  # past the bound: clipped, as gymnasium does
    with pytest.raises(TypeError, match="render_mode"):
        env.PendulumEnv({"render_mode": "human"})
    assert env.PendulumEnv({"g": 9.81}).g == 9.81


# -- replay buffer -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_replay_buffer_matches_reference(kind):
    """One operation sequence on both buffers (adds that wrap the ring,
    sample, sample_many, size): every result equal bit for bit."""
    shape, dtype = ((), np.int64) if kind == "discrete" else ((2,), np.float32)
    bufs = [mod.ReplayBuffer(50, 3, shape, dtype) for mod in (ref_dqn, dqn)]
    rng = np.random.default_rng(9)
    for n in (7, 30, 1, 26, 40):
        acts = (rng.integers(0, 4, n) if kind == "discrete"
                else rng.standard_normal((n, 2)).astype(np.float32))
        args = (rng.standard_normal((n, 3)).astype(np.float32), acts,
                rng.standard_normal(n).astype(np.float32),
                rng.standard_normal((n, 3)).astype(np.float32),
                (rng.random(n) < 0.2).astype(np.float32))
        assert bufs[1].add(*args) == bufs[0].add(*args)
        assert bufs[1].size() == bufs[0].size()
        for got, want in ((bufs[1].sample(16, seed=n), bufs[0].sample(16, seed=n)),
                          (bufs[1].sample_many(8, 3, seed=n), bufs[0].sample_many(8, 3, seed=n))):
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])
    assert bufs[1].size() == 50


# -- DQN -----------------------------------------------------------------------------


def _dqn_batches(rng, U, B, obs_dim, act_dim):
    return {
        "obs": rng.standard_normal((U, B, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, act_dim, (U, B)),
        "rewards": rng.standard_normal((U, B)).astype(np.float32),
        "next_obs": rng.standard_normal((U, B, obs_dim)).astype(np.float32),
        "dones": (rng.random((U, B)) < 0.2).astype(np.float32),
    }


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_reference(double_q):
    """4 updates from the same online and target weights: losses and
    parameters within 1e-5; the target does not move."""
    obs_dim, act_dim = 4, 2
    cfg = dqn.DQNConfig().environment(env.CartPoleEnv).training(double_q=double_q)
    qnet = ref_models.QNetwork(act_dim)
    tree = _moved(qnet.init(jax.random.PRNGKey(1), jnp.zeros((1, obs_dim)))["params"], 1)
    target = _moved(tree, 2)
    stub = types.SimpleNamespace(config=cfg, model=qnet, tx=optax.adam(cfg.lr))
    batches = _dqn_batches(np.random.default_rng(3), 4, 64, obs_dim, act_dim)
    params, opt = _jax(tree), optax.adam(cfg.lr).init(_jax(tree))
    update = jax.jit(functools.partial(ref_dqn.DQN._update_impl, stub))
    want_losses = []
    for u in range(4):
        params, opt, loss = update(params, _jax(target), opt,
                                   {k: jnp.asarray(v[u]) for k, v in batches.items()})
        want_losses.append(float(loss))

    algo = cfg.build(device="cpu")
    algo.model.load_state_dict(q_network_params_from_jax(tree, obs_dim, act_dim, device="cpu"))
    algo.target_model.load_state_dict(q_network_params_from_jax(target, obs_dim, act_dim,
                                                                device="cpu"))
    losses = algo._update(batches)
    assert losses.shape == (4,) and algo.opt_state["count"] == 4
    _close(losses, want_losses, 1e-5, "losses")
    _params_close(dict(algo.model.named_parameters()), params, "params")
    _params_close(dict(algo.target_model.named_parameters()), _jax(target), "target")
    algo.stop()


def _ref_dqn_runner(env_spec, env_config, tree):
    runner = ref_dqn.DQNRunner(env_spec, env_config, 3, 40, 11)
    return runner, _jax(tree)


@pytest.mark.parametrize("epsilon", [1.0, 0.3])
def test_dqn_runner_matches_reference(epsilon):
    """CartPole without truncations: every transition, flag and closed
    episode equal bit for bit (exploration draws are numpy on both sides;
    the greedy actions come from the same weights)."""
    qnet = ref_models.QNetwork(2)
    tree = _moved(qnet.init(jax.random.PRNGKey(2), jnp.zeros((1, 4)))["params"], 4)
    ref, ref_params = _ref_dqn_runner("CartPole-v1", {}, tree)
    port = dqn.DQNRunner(env.CartPoleEnv, {}, 3, 40, 11)
    params = q_network_params_from_jax(tree, 4, 2, device="cpu")
    for _ in range(2):
        want = ref.sample(ref_params, epsilon)
        got = port.sample(params, epsilon)
        assert got.keys() == want.keys()
        for k, w in want.items():
            if isinstance(w, list):
                assert got[k] == w, k
            else:
                assert got[k].dtype == w.dtype, k
                np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert len(want["episode_returns"]) > 0 and want["dones"].sum() > 0
    assert next(port.model.parameters()).device.type == "cpu"


def test_dqn_runner_closes_truncated_episodes():
    """The departure from the reference: on CartPole truncated at 20
    steps, the reference's runner writes dones = 0 at a truncation and
    carries the return into the next episode (a closed episode longer than
    20 steps); the port's closes the episode there. Every other row is
    equal bit for bit."""
    tree = _moved(ref_models.QNetwork(2).init(jax.random.PRNGKey(2),
                                              jnp.zeros((1, 4)))["params"], 4)
    ref, ref_params = _ref_dqn_runner("CartPole-v1", {"max_episode_steps": 20}, tree)
    port = dqn.DQNRunner(env.CartPoleEnv, {"max_episode_steps": 20}, 3, 40, 11)
    want = ref.sample(ref_params, 1.0)
    got = port.sample(q_network_params_from_jax(tree, 4, 2, device="cpu"), 1.0)
    for k in ("obs", "actions", "rewards", "next_obs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    parted = np.nonzero(got["dones"] != want["dones"])[0]
    assert len(parted) > 0
    assert (got["dones"][parted] == 1).all() and (want["dones"][parted] == 0).all()
    assert max(want["episode_lengths"]) > 20 >= max(got["episode_lengths"])
    assert len(got["episode_returns"]) > len(want["episode_returns"])
    assert sum(got["episode_lengths"]) > sum(want["episode_lengths"])


# -- SAC -----------------------------------------------------------------------------


def _sac_setup(B=64, U=4):
    obs_dim, act_dim = 5, 2
    cfg = sac.SACConfig().environment(_Box2)
    zo, za = jnp.zeros((1, obs_dim)), jnp.zeros((1, act_dim))
    actor = ref_models.SquashedGaussianActor(act_dim)
    critic = ref_models.TwinQ()
    trees = {
        "actor": _moved(actor.init(jax.random.PRNGKey(3), zo)["params"], 5),
        "critic": _moved(critic.init(jax.random.PRNGKey(4), zo, za)["params"], 6),
    }
    trees["target_critic"] = _moved(trees["critic"], 7)
    rng = np.random.default_rng(8)
    batches = {
        "obs": rng.standard_normal((U, B, obs_dim)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (U, B, act_dim)).astype(np.float32),
        "rewards": rng.standard_normal((U, B)).astype(np.float32),
        "next_obs": rng.standard_normal((U, B, obs_dim)).astype(np.float32),
        "dones": (rng.random((U, B)) < 0.2).astype(np.float32),
    }
    return cfg, actor, critic, trees, batches, obs_dim, act_dim


def _ref_sac_update(cfg, actor, critic, trees, batches, key, log_alpha):
    stub = types.SimpleNamespace(
        config=cfg, actor=actor, critic=critic, target_entropy=-2.0,
        actor_tx=optax.adam(cfg.actor_lr), critic_tx=optax.adam(cfg.critic_lr),
        alpha_tx=optax.adam(cfg.alpha_lr))
    stub._one_update = functools.partial(ref_sac.SAC._one_update, stub)
    state = {k: _jax(v) for k, v in trees.items()}
    state["log_alpha"] = jnp.asarray(log_alpha, jnp.float32)
    opt = {"actor": stub.actor_tx.init(state["actor"]),
           "critic": stub.critic_tx.init(state["critic"]),
           "alpha": stub.alpha_tx.init(state["log_alpha"])}
    return ref_sac.SAC._update_scan_impl(stub, state, opt, key,
                                         {k: jnp.asarray(v) for k, v in batches.items()})


def _reference_noise(key, U, shape):
    """The reference's normal draws: per update, ``split(key, 3)`` into
    (key, next, current)."""
    out = []
    for _ in range(U):
        key, k_next, k_cur = jax.random.split(key, 3)
        out.append((np.asarray(jax.random.normal(k_next, shape)),
                    np.asarray(jax.random.normal(k_cur, shape))))
    return out


def _port_sac(cfg, trees, obs_dim, act_dim, log_alpha):
    algo = cfg.build(device="cpu")
    algo.actor.load_state_dict(squashed_actor_params_from_jax(trees["actor"], obs_dim,
                                                              act_dim, device="cpu"))
    for name in ("critic", "target_critic"):
        getattr(algo, name).load_state_dict(
            twin_q_params_from_jax(trees[name], obs_dim, act_dim, device="cpu"))
    with torch.no_grad():
        algo.log_alpha.fill_(log_alpha)
    return algo


def test_sac_update_matches_reference():
    """4 updates (critic, actor against the updated critic, temperature,
    polyak) with the reference's draws: all five stats and all four
    parameter sets within 1e-5."""
    cfg, actor, critic, trees, batches, obs_dim, act_dim = _sac_setup()
    key = jax.random.PRNGKey(21)
    log_alpha = float(np.log(np.float32(0.5)))
    want_state, want_opt, want_stats = _ref_sac_update(cfg, actor, critic, trees, batches,
                                                       key, log_alpha)
    algo = _port_sac(cfg, trees, obs_dim, act_dim, log_alpha)
    assert algo.target_entropy == -2.0
    stats = algo._update(batches, noises=_reference_noise(key, 4, (64, act_dim)))
    # the five stats as one tensor: the actor loss is a small difference of
    # larger terms, and the reference's own f32 value of it is 2.4e-6 from
    # an f64 run of the port (the port's f32 value 1e-7)
    _close(stats, [float(want_stats[k]) for k in sac.STAT_KEYS], 1e-5, "stats")
    for name, module in algo._modules().items():
        _params_close(dict(module.named_parameters()), want_state[name], name)
    _close(algo.log_alpha.item(), float(want_state["log_alpha"]), 1e-5, "log_alpha")
    assert {s["count"] for s in algo.opt.values()} == {4}
    for name in ("actor", "critic"):  # the moments too: no gradient leaked across
        mu = want_opt[name][0].mu
        _params_close(algo.opt[name]["mu"], mu, f"{name} mu")
    algo.stop()


def test_sac_update_noise_comes_from_a_seeded_device_generator():
    """Without ``noises`` the same iteration gives the same update, another
    iteration another one."""
    cfg, _, _, trees, batches, obs_dim, act_dim = _sac_setup(B=16, U=2)
    runs = []
    for it in (3, 3, 4):
        algo = _port_sac(cfg, trees, obs_dim, act_dim, 0.0)
        algo.iteration = it
        runs.append(algo._update(batches))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_sac_runner_matches_reference():
    """Warm-up (uniform draws from numpy on both sides) on Pendulum:
    bit for bit; then policy draws: the same keys, shapes and dtypes, and
    env actions inside the Box."""
    actor = ref_models.SquashedGaussianActor(1)
    tree = _moved(actor.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"], 9)
    ref = ref_sac.SACRunner("Pendulum-v1", {"max_episode_steps": 30}, 2, 50, 13)
    port = sac.SACRunner(env.PendulumEnv, {"max_episode_steps": 30}, 2, 50, 13)
    params = squashed_actor_params_from_jax(tree, 3, 1, device="cpu")
    want = ref.sample(_jax(tree), True)
    got = port.sample(params, True)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, list):
            assert got[k] == w, k
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert want["dones"].sum() > 0
    want, got = ref.sample(_jax(tree), False), port.sample(params, False)
    for k, w in want.items():
        if not isinstance(w, list):
            assert (got[k].dtype, got[k].shape) == (w.dtype, w.shape), k
    assert np.abs(got["actions"]).max() <= 1.0
    np.testing.assert_array_equal(got["obs"][2:], got["next_obs"][:-2])  # 2 envs, in order


# -- whole runs, checkpoints, errors ------------------------------------------------------


def _dqn_config(mod, env_spec):
    return (mod.DQNConfig().environment(env_spec)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2, rollout_fragment_length=16)
            .training(learning_starts=100, num_updates_per_iter=3, train_batch_size=16)
            .debugging(seed=0))


def test_dqn_train_on_cpu_with_the_reference_s_result(monkeypatch, tmp_path):
    in_process(monkeypatch, ref_dqn)
    ref_algo = _dqn_config(ref_dqn, "CartPole-v1").build()
    want = [ref_algo.train() for _ in range(3)]
    ref_algo.stop()
    algo = _dqn_config(dqn, env.CartPoleEnv).build(device="cpu")
    got = [algo.train() for _ in range(3)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("training_iteration", "num_env_steps_sampled", "buffer_size", "epsilon"):
            assert g[k] == w[k], k
    assert math.isnan(got[0]["loss_mean"]) and math.isnan(want[0]["loss_mean"])
    assert all(math.isfinite(g["loss_mean"]) for g in got[1:])
    assert set(algo.timers) == {"sample_s", "buffer_s", "learn_s"}
    assert algo.opt_state["count"] == 6

    algo.save(str(tmp_path / "ckpt"))
    fresh = _dqn_config(dqn, env.CartPoleEnv).build(device="cpu")
    fresh.restore(str(tmp_path / "ckpt"))
    _state_equal(fresh.state_dict(), algo.state_dict())
    assert fresh.iteration == 3
    a = algo.compute_single_action(np.zeros(4, np.float32))
    assert a in (0, 1) and fresh.compute_single_action(np.zeros(4, np.float32)) == a
    fresh.train()  # a restored learner trains on
    algo.stop()
    fresh.stop()


def _state_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _state_equal(got[k], want[k])
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert got == want


def _sac_config(mod, env_spec):
    return (mod.SACConfig().environment(env_spec, {"max_episode_steps": 20})
            .env_runners(rollout_fragment_length=16)
            .training(learning_starts=32, num_updates_per_iter=2, train_batch_size=16)
            .debugging(seed=0))


def test_sac_train_on_cpu_with_the_reference_s_result(monkeypatch, tmp_path):
    in_process(monkeypatch, ref_sac)
    ref_algo = _sac_config(ref_sac, "Pendulum-v1").build()
    want = [ref_algo.train() for _ in range(3)]
    ref_algo.stop()
    algo = _sac_config(sac, env.PendulumEnv).build(device="cpu")
    got = [algo.train() for _ in range(3)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert (g["buffer_size"], g["num_env_steps_sampled"]) == (
            w["buffer_size"], w["num_env_steps_sampled"])
    # the warm-up iterations draw from numpy: their episodes are the reference's
    assert got[0]["num_episodes"] == want[0]["num_episodes"]
    assert all(math.isfinite(got[-1][k]) for k in sac.STAT_KEYS)
    assert set(algo.timers) == {"sample_s", "buffer_s", "learn_s"}
    assert {s["count"] for s in algo.opt.values()} == {4}

    algo.save(str(tmp_path / "ckpt"))
    fresh = _sac_config(sac, env.PendulumEnv).build(device="cpu")
    fresh.restore(str(tmp_path / "ckpt"))
    _state_equal(fresh.state_dict(), algo.state_dict())
    a = fresh.compute_single_action(np.zeros(3, np.float32))
    assert a.shape == (1,) and np.abs(a).max() <= 2.0
    np.testing.assert_array_equal(a, algo.compute_single_action(np.zeros(3, np.float32)))
    fresh.train()
    algo.stop()
    fresh.stop()


def test_errors_are_the_reference_s(monkeypatch):
    with pytest.raises(ValueError, match="discrete action space"):
        dqn.DQNConfig().environment(env.PendulumEnv).build(device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        sac.SACConfig().environment(env.CartPoleEnv).build(device="cpu")
    for cfg in (dqn.DQNConfig(), sac.SACConfig()):
        with pytest.raises(ValueError, match="environment"):
            cfg.build(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (dqn.DQNConfig().environment(env.CartPoleEnv),
                sac.SACConfig().environment(env.PendulumEnv)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()


def test_configs_match_the_reference():
    for ref, port in ((ref_dqn.DQNConfig(), dqn.DQNConfig()),
                      (ref_sac.SACConfig(), sac.SACConfig())):
        assert vars(port) == vars(ref)
