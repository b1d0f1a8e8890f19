"""ray_tpu_torch.rllib (PPO) against ray_tpu.rllib, on the CPU.

Inputs come from numpy seeds and go through the reference and the port.
Model outputs, losses and gradients are held within 1e-5 of the largest
|value| of each compared tensor (both sides compute in f32: the same sums
in another order). GAE, ``gae_batch``, connectors and the CartPole
trajectories are numpy on both sides, or gymnasium's arithmetic copied
operation for operation, and must be equal bit for bit.

One learner update (4 epochs x 4 minibatches) starts from the same weights
with the reference's ``jax.random.permutation`` rows handed to the port.
Its parameters are held within 1e-5 absolute. Each of the 16 Adam steps
moves a coordinate by ``lr * m / (sqrt(v) + eps)``, at most about lr = 3e-4,
and the two sides' steps differ by a few f32 ulps of that (1e-9 in all)
while the sign of the coordinate's gradient is the same on both. A gradient
at rounding level can take either sign, and then the step can flip: a
difference of 2 lr = 6e-4, which the 1e-5 bound would catch. These batches
have no such coordinate.
"""

import math

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import ray_tpu
from ray_tpu.rllib import algorithm as ref_algorithm
from ray_tpu.rllib import connectors as ref_connectors
from ray_tpu.rllib import env as ref_env
from ray_tpu.rllib import env_runner as ref_env_runner
from ray_tpu.rllib import learner as ref_learner
from ray_tpu.rllib import models as ref_models
from ray_tpu_torch.models.convert import _flatten, actor_critic_params_from_jax
from ray_tpu_torch.rllib import algorithm, connectors, env, learner, models, weight_sync
from ray_tpu_torch.rllib.env_runner import EnvRunner

_HEADS = {"discrete": (4, 3, True), "gaussian": (5, 2, False)}  # obs_dim, action_dim, discrete
_LR = 3e-4


def _close(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _ref_tree(obs_dim, action_dim, discrete, seed=0):
    """The reference's ActorCritic tree (flax's own init), its zero-start
    leaves (biases, ``log_std``) moved off zero so a misplaced one shows."""
    _, params = ref_models.init_actor_critic(obs_dim, action_dim, discrete, seed)
    rng = np.random.default_rng(seed + 100)
    tree = {}
    for name, leaf in params.items():
        if name == "log_std":
            tree[name] = rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)
            continue
        tree[name] = {
            "kernel": np.asarray(leaf["kernel"]),
            "bias": (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32),
        }
    return tree


def _port_model(tree, obs_dim, action_dim, discrete):
    model = models.ActorCritic(obs_dim, action_dim, discrete)
    model.load_state_dict(actor_critic_params_from_jax(
        tree, obs_dim, action_dim, discrete, device="cpu"))
    return model


def _batch(obs_dim, action_dim, discrete, B, seed):
    rng = np.random.default_rng(seed)
    actions = (rng.integers(0, action_dim, size=B) if discrete
               else rng.standard_normal((B, action_dim)).astype(np.float32))
    return {
        "obs": rng.standard_normal((B, obs_dim)).astype(np.float32),
        "actions": actions,
        "logp_old": (rng.standard_normal(B) - 1.5).astype(np.float32),
        "advantages": rng.standard_normal(B).astype(np.float32),
        "returns": rng.standard_normal(B).astype(np.float32),
    }


def _ref_out(tree, obs_dim, action_dim, discrete, obs):
    model = ref_models.ActorCritic(action_dim=action_dim, discrete=discrete)
    return model.apply({"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(obs))


# -- model -------------------------------------------------------------------


@pytest.mark.parametrize("head", list(_HEADS))
def test_actor_critic_forward_matches_reference(head):
    obs_dim, action_dim, discrete = _HEADS[head]
    tree = _ref_tree(obs_dim, action_dim, discrete)
    obs = np.random.default_rng(1).standard_normal((32, obs_dim)).astype(np.float32)
    want_out, want_v = _ref_out(tree, obs_dim, action_dim, discrete, obs)
    with torch.no_grad():
        got_out, got_v = _port_model(tree, obs_dim, action_dim, discrete)(torch.from_numpy(obs))
    _close(got_v, want_v, 1e-5, "value")
    if discrete:
        _close(got_out, want_out, 1e-5, "logits")
    else:
        _close(got_out[0], want_out[0], 1e-5, "mean")
        np.testing.assert_array_equal(got_out[1].detach().numpy(), np.asarray(want_out[1]))


def test_actor_critic_params_from_jax_rejects_bad_trees():
    tree = _ref_tree(5, 2, False)
    missing = {k: v for k, v in tree.items() if k != "log_std"}
    with pytest.raises(KeyError, match="missing"):
        actor_critic_params_from_jax(missing, 5, 2, False, device="cpu")
    extra = dict(tree, Dense_4={"kernel": np.zeros((64, 1), np.float32)})
    with pytest.raises(KeyError, match="does not know"):
        actor_critic_params_from_jax(extra, 5, 2, False, device="cpu")
    with pytest.raises(KeyError, match="does not know"):  # a discrete head has no log_std
        actor_critic_params_from_jax(tree, 5, 2, True, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        actor_critic_params_from_jax(tree, 6, 2, False, device="cpu")


@pytest.mark.parametrize("head", list(_HEADS))
def test_log_prob_entropy_matches_reference(head):
    obs_dim, action_dim, discrete = _HEADS[head]
    tree = _ref_tree(obs_dim, action_dim, discrete)
    b = _batch(obs_dim, action_dim, discrete, 64, seed=2)
    out, _ = _ref_out(tree, obs_dim, action_dim, discrete, b["obs"])
    want_logp, want_ent = ref_models.log_prob_entropy(discrete, out, jnp.asarray(b["actions"]))
    with torch.no_grad():
        got_out, _ = _port_model(tree, obs_dim, action_dim, discrete)(torch.from_numpy(b["obs"]))
        got_logp, got_ent = models.log_prob_entropy(
            discrete, got_out, torch.as_tensor(b["actions"]))
    assert got_logp.shape == got_ent.shape == (64,)
    _close(got_logp, want_logp, 1e-5, "logp")
    _close(got_ent, want_ent, 1e-5, "entropy")


def _learners(head, B, mb, seed=0):
    """The reference learner and the port's (on the CPU), on the same tree."""
    obs_dim, action_dim, discrete = _HEADS[head]
    tree = _ref_tree(obs_dim, action_dim, discrete, seed)
    kw = dict(lr=_LR, num_epochs=4, minibatch_size=mb, seed=seed)
    ref = ref_learner.PPOLearner(obs_dim, action_dim, discrete, **kw)
    ref.params = jax.tree.map(jnp.asarray, tree)
    ref.opt_state = ref.tx.init(ref.params)
    port = learner.PPOLearner(obs_dim, action_dim, discrete, device="cpu", **kw)
    port.set_params(actor_critic_params_from_jax(tree, obs_dim, action_dim, discrete,
                                                 device="cpu"))
    return ref, port, _batch(obs_dim, action_dim, discrete, B, seed=seed + 3)


@pytest.mark.parametrize("head", list(_HEADS))
def test_ppo_loss_and_grads_match_reference(head):
    ref, port, b = _learners(head, 64, 64)
    (want_total, want_stats), want_grads = jax.value_and_grad(ref._loss, has_aux=True)(
        ref.params, {k: jnp.asarray(v) for k, v in b.items()})
    total, stats = port._loss({k: torch.as_tensor(v) for k, v in b.items()})
    grads = torch.autograd.grad(total, list(port.model.parameters()))
    _close(total.detach(), want_total, 1e-5, "total loss")
    for key, got in zip(learner.STAT_KEYS, stats.detach()):
        _close(got, want_stats[key], 1e-5, key)
    want = {k: np.asarray(v) for k, v in _flatten(want_grads).items()}
    for (name, _), g in zip(port.model.named_parameters(), grads):
        _close(g, want[name], 1e-5, f"grad {name}")


def _reference_perms(ref, B, mb):
    """The rows the reference's next ``update`` shuffles into (its key
    schedule: one split per update, one key per epoch)."""
    _, sub = jax.random.split(ref._key)
    n = (B // mb) * mb
    return np.stack([np.asarray(jax.random.permutation(k, B)[:n])
                     for k in jax.random.split(sub, ref.num_epochs)])


@pytest.mark.parametrize("head", list(_HEADS))
def test_learner_update_matches_reference(head):
    B, mb = 64, 16  # 4 epochs x 4 minibatches
    ref, port, b = _learners(head, B, mb)
    start = {k: v.clone() for k, v in port.get_params().items()}
    perms = _reference_perms(ref, B, mb)
    want_stats = ref.update(b)
    got_stats = port.update(b, perms=perms)
    assert port.opt_state["count"] == 16
    for key in learner.STAT_KEYS:
        _close(got_stats[key], want_stats[key], 1e-5, key)
    want = _flatten(jax.device_get(ref.params))
    for name, p in port.get_params().items():
        np.testing.assert_allclose(p.numpy(), want[name], rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(p, start[name]), name


def test_learner_shuffles_from_its_own_generator():
    """Without ``perms`` the same seed gives the same update, another seed
    another one; a ``perms`` of the wrong size raises."""
    b = _batch(4, 3, True, 64, seed=5)
    runs = []
    for seed in (0, 0, 1):
        lrn = learner.PPOLearner(4, 3, True, num_epochs=2, minibatch_size=16, seed=0,
                                 device="cpu")
        lrn._generator.manual_seed(seed + 1)
        runs.append(lrn.update(b))
    assert runs[0] == runs[1] != runs[2]
    with pytest.raises(ValueError, match="perms"):
        lrn.update(b, perms=np.zeros((2, 32), np.int64))


# -- GAE -----------------------------------------------------------------------


def _rollouts(rng, T, N, continuous):
    out = []
    for _ in range(2):
        dones = rng.random((T, N)) < 0.15
        actions = (rng.standard_normal((T, N, 2)).astype(np.float32) if continuous
                   else rng.integers(0, 2, (T, N)).astype(np.int32))
        out.append({
            "obs": rng.standard_normal((T, N, 4)).astype(np.float32),
            "actions": actions,
            "logp": rng.standard_normal((T, N)).astype(np.float32),
            "values": rng.standard_normal((T, N)).astype(np.float32),
            "rewards": rng.standard_normal((T, N)).astype(np.float32),
            "dones": dones,
            "last_values": rng.standard_normal(N).astype(np.float32),
        })
    return out


@pytest.mark.parametrize("continuous", [False, True])
def test_compute_gae_and_gae_batch_are_bitwise_equal(continuous):
    rollouts = _rollouts(np.random.default_rng(7), 12, 3, continuous)
    ro = rollouts[0]
    args = (ro["rewards"], ro["values"], ro["dones"], ro["last_values"], 0.99, 0.95)
    for got, want in zip(models.compute_gae(*args), ref_models.compute_gae(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = algorithm.gae_batch(rollouts, 0.99, 0.95)
    want = ref_algorithm.gae_batch(rollouts, 0.99, 0.95)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


# -- environments ----------------------------------------------------------------


@pytest.mark.parametrize("max_steps", [20, 500])
def test_cartpole_matches_gymnasium(max_steps):
    """Same seeds and actions: obs, rewards and flags bit for bit over several
    episodes, with resets that keep drawing from the seeded generator."""
    ref = gym.make("CartPole-v1", max_episode_steps=max_steps)
    port = env.CartPoleEnv({"max_episode_steps": max_steps})
    assert port.action_space.n == ref.action_space.n
    np.testing.assert_array_equal(port.observation_space.high, ref.observation_space.high)
    np.testing.assert_array_equal(port.observation_space.low, ref.observation_space.low)
    actions = np.random.default_rng(11).integers(0, 2, 600)
    o_ref, _ = ref.reset(seed=3)
    o_port, _ = port.reset(seed=3)
    ends = {"terminated": 0, "truncated": 0}
    for a in actions:
        np.testing.assert_array_equal(o_port, o_ref)
        assert o_port.dtype == o_ref.dtype == np.float32
        o_ref, r_ref, term_ref, trunc_ref, _ = ref.step(a)
        o_port, r_port, term_port, trunc_port, _ = port.step(a)
        assert (r_port, term_port, trunc_port) == (r_ref, term_ref, trunc_ref)
        assert type(r_port) is type(r_ref)
        if term_ref or trunc_ref:
            ends["terminated" if term_ref else "truncated"] += 1
            o_ref, _ = ref.reset()
            o_port, _ = port.reset()
    assert ends["terminated"] >= 5
    assert ends["truncated"] >= (5 if max_steps == 20 else 0)


def test_cartpole_rejects_bad_actions_and_options():
    port = env.CartPoleEnv()
    with pytest.raises(RuntimeError, match="reset"):
        port.step(0)
    port.reset(seed=0)
    for bad in (2, -1, 0.5, np.array([1])):
        with pytest.raises(ValueError, match="invalid"):
            port.step(bad)
    port.step(np.int32(1))
    with pytest.raises(TypeError, match="render_mode"):
        env.CartPoleEnv({"render_mode": "human"})


def test_vector_env_seeds_and_autoreset_match_reference():
    cfg = {"max_episode_steps": 20}
    ref = ref_env.VectorEnv([ref_env.make_env("CartPole-v1", cfg) for _ in range(3)])
    port = env.VectorEnv([env.make_env(env.CartPoleEnv, cfg) for _ in range(3)])
    got, want = port.reset(seed=5), ref.reset(seed=5)
    np.testing.assert_array_equal(got, want)
    for i in range(3):  # copy i is seeded with seed + i
        np.testing.assert_array_equal(got[i], gym.make("CartPole-v1").reset(seed=5 + i)[0])
    actions = np.random.default_rng(2).integers(0, 2, (100, 3))
    ends = 0
    for a in actions:
        got, want = port.step(a), ref.step(a)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(port.last_raw_obs, ref.last_raw_obs)
        ends += int(np.sum(want[2] | want[3]))
    assert ends >= 10  # terminations and truncations, each followed by a reset
    port.close()
    ref.close()


def _spaces():
    return {
        "gym_box": gym.spaces.Box(-1.0, 1.0, (2, 3), np.float32),
        "port_box": env.Box(-1.0, 1.0, (2, 3)),
        "gym_discrete": gym.spaces.Discrete(5),
        "port_discrete": env.Discrete(5),
    }


def test_space_dims_duck_type_both_kinds_of_space():
    sp = _spaces()
    for obs in ("gym_box", "port_box", "gym_discrete", "port_discrete"):
        for act in ("gym_box", "port_box", "gym_discrete", "port_discrete"):
            want = ref_env.space_dims(sp[obs.replace("port", "gym")], sp[act.replace("port", "gym")])
            assert env.space_dims(sp[obs], sp[act]) == want, (obs, act)
    with pytest.raises(ValueError, match="unsupported"):
        env.space_dims(gym.spaces.MultiBinary(3), sp["port_discrete"])


@pytest.mark.parametrize("kind", ["box", "discrete"])
def test_flatten_observations_matches_reference(kind):
    sp = _spaces()
    rng = np.random.default_rng(4)
    data = (rng.standard_normal((6, 2, 3)).astype(np.float32) if kind == "box"
            else rng.integers(0, 5, 6))
    want = ref_connectors.FlattenObservations()(
        data, ref_connectors.ConnectorContext(sp[f"gym_{kind}"]))
    for space in (sp[f"gym_{kind}"], sp[f"port_{kind}"]):
        got = connectors.FlattenObservations()(data, connectors.ConnectorContext(space))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_normalize_observations_matches_reference():
    rng = np.random.default_rng(6)
    ref, port = ref_connectors.NormalizeObservations(), connectors.NormalizeObservations()
    for n in (3, 7, 1):
        data = (3 + 2 * rng.standard_normal((n, 4))).astype(np.float32)
        np.testing.assert_array_equal(port(data, None), ref(data, None))


@pytest.mark.parametrize("kind", ["box", "discrete"])
def test_clip_actions_matches_reference(kind):
    sp = _spaces()
    rng = np.random.default_rng(8)
    data = (3 * rng.standard_normal((6, 2, 3)).astype(np.float32) if kind == "box"
            else rng.integers(0, 5, 6))
    want = ref_connectors.ClipActions()(
        data, ref_connectors.ConnectorContext(None, sp[f"gym_{kind}"]))
    for space in (sp[f"gym_{kind}"], sp[f"port_{kind}"]):
        got = connectors.ClipActions()(data, connectors.ConnectorContext(None, space))
        np.testing.assert_array_equal(got, want)
    if kind == "discrete":
        assert got is data  # passed through untouched


def test_connector_pipelines_compose_as_the_reference():
    double = ("double", lambda d, ctx: 2 * d)
    pipes = []
    for mod in (ref_connectors, connectors):
        pipe = mod.default_env_to_module()
        pipe.append(mod.Lambda(double[1], name=double[0]))
        pipe.prepend(mod.Lambda(lambda d, ctx: d + 1))
        pipe.insert_after(mod.FlattenObservations, mod.NormalizeObservations())
        with pytest.raises(ValueError, match="no connector"):
            pipe.insert_after(mod.ClipActions, mod.Lambda(double[1]))
        pipes.append(pipe)
    assert repr(pipes[0]) == repr(pipes[1])
    assert repr(ref_connectors.default_module_to_env()) == repr(connectors.default_module_to_env())
    data = np.random.default_rng(9).standard_normal((5, 2, 2)).astype(np.float32)
    ctx = [m.ConnectorContext(s) for m, s in ((ref_connectors, gym.spaces.Box(-1, 1, (2, 2))),
                                              (connectors, env.Box(-1, 1, (2, 2))))]
    np.testing.assert_array_equal(pipes[1](data, ctx[1]), pipes[0](data, ctx[0]))


# -- env runner ----------------------------------------------------------------


def test_env_runner_matches_reference():
    """The reference's runner samples gymnasium's CartPole; the port's model
    gives the same logp and values on its obs and actions, the port's
    CartPole replays the actions to the same obs, rewards and dones, and the
    port's runner returns the same keys, shapes and dtypes."""
    T, N, seed = 40, 3, 7
    tree = _ref_tree(4, 2, True)
    ref = ref_env_runner.EnvRunner("CartPole-v1", {}, N, T, seed)
    want = ref.sample(jax.tree.map(jnp.asarray, tree))
    assert len(want["episode_returns"]) > 0  # the replay crosses an autoreset
    model = _port_model(tree, 4, 2, True)
    with torch.no_grad():
        out, values = model(torch.from_numpy(want["obs"].reshape(T * N, 4)))
        logp, _ = models.log_prob_entropy(True, out, torch.from_numpy(
            want["actions"].reshape(T * N)))
        _, last = model(torch.from_numpy(_replay(want, seed, N)))
    _close(logp.view(T, N), want["logp"], 1e-5, "logp")
    _close(values.view(T, N), want["values"], 1e-5, "values")
    _close(last, want["last_values"], 1e-5, "last values")

    port = EnvRunner(env.CartPoleEnv, {}, N, T, seed)
    got = port.sample(model.state_dict())
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, list):
            assert isinstance(got[k], list) and {type(x) for x in got[k]} == {
                type(x) for x in w}, k
        else:
            assert (got[k].dtype, got[k].shape) == (w.dtype, w.shape), k
    assert next(port.model.parameters()).device.type == "cpu"
    np.testing.assert_array_equal(got["obs"][0], want["obs"][0])  # same seeded resets


def _replay(ro, seed, N):
    """Step the port's CartPole copies with the recorded actions, holding
    each transition to the recording; returns the obs after the last step."""
    vec = env.VectorEnv([env.make_env(env.CartPoleEnv) for _ in range(N)])
    obs = vec.reset(seed=seed)
    for t in range(ro["actions"].shape[0]):
        np.testing.assert_array_equal(obs, ro["obs"][t])
        obs, rewards, terms, truncs = vec.step(ro["actions"][t])
        np.testing.assert_array_equal(rewards, ro["rewards"][t])
        np.testing.assert_array_equal(terms | truncs, ro["dones"][t])
    return obs


# -- sampling law, init ------------------------------------------------------


def test_sample_actions_categorical_law():
    """20,000 draws of one row's action: chi-square against its softmax,
    below the 0.999 quantile (a fixed seed: the statistic is fixed too)."""
    model = models.init_actor_critic(3, 4, True, seed=1, device="cpu")
    with torch.no_grad():
        model.Dense_2.bias.copy_(torch.tensor([1.0, 0.0, -1.0, 0.5]))
        obs = torch.full((20_000, 3), 0.3)
        actions, logp, values = models.sample_actions(
            model, obs, torch.Generator().manual_seed(0))
        probs = torch.softmax(model(obs[:1])[0][0], -1).double().numpy()
    counts = np.bincount(actions.numpy(), minlength=4)
    stat = float(np.sum((counts - 20_000 * probs) ** 2 / (20_000 * probs)))
    assert stat < scipy.stats.chi2.ppf(0.999, df=3), (counts, 20_000 * probs)
    np.testing.assert_allclose(logp.numpy(), np.log(probs)[actions.numpy()], rtol=1e-5)
    assert values.shape == (20_000,)


def test_sample_actions_gaussian_law():
    """20,000 draws of one row: mean within 4.5 standard errors of the
    model's mean, std within 4.5 of its standard error (1/sqrt(2n) relative)
    of exp(log_std); logp is the Gaussian's."""
    n = 20_000
    model = models.init_actor_critic(3, 2, False, seed=2, device="cpu")
    with torch.no_grad():
        model.log_std.copy_(torch.tensor([-0.7, 0.4]))
        obs = torch.full((n, 3), -0.2)
        actions, logp, _ = models.sample_actions(model, obs, torch.Generator().manual_seed(0))
        (mean, log_std), _ = model(obs[:1])
        want = torch.distributions.Normal(mean[0], torch.exp(log_std)).log_prob(actions).sum(-1)
    std = torch.exp(log_std).double()
    a = actions.double()
    assert (a.mean(0) - mean[0]).abs().le(4.5 * std / math.sqrt(n)).all()
    assert (a.std(0) / std - 1).abs().le(4.5 / math.sqrt(2 * n)).all()
    _close(logp, want, 1e-5, "gaussian logp")


def test_init_is_flax_lecun_normal():
    """Kernels: truncated normal at +-2 of flax's stddev, mean 0 and variance
    1/fan-in within 4.5 standard errors; biases and log_std zero; the same
    seed gives the same weights."""
    fan_in = 512
    model = models.init_actor_critic(fan_in, 6, False, seed=0, device="cpu")
    w = model.Dense_0.kernel.detach().double().numpy().ravel()  # 32,768 draws
    std = math.sqrt(1 / fan_in) / 0.87962566103423978
    assert np.abs(w).max() <= 2 * std * (1 + 1e-6)
    assert abs(w.mean()) <= 4.5 * math.sqrt(1 / fan_in / w.size)
    # the variance of a sample variance: (kurtosis - 1) var^2 / n, kurtosis
    # of the normal truncated at +-2 being 2.36
    assert abs(w.var() * fan_in - 1) <= 4.5 * math.sqrt(1.36 / w.size)
    for name, p in model.named_parameters():
        if not name.endswith("kernel"):
            assert torch.count_nonzero(p) == 0, name
    again = models.init_actor_critic(fan_in, 6, False, seed=0, device="cpu")
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name


# -- the algorithm -------------------------------------------------------------


class _InProcess:
    """``ray_tpu.api``'s remote / get / kill surface, run in the caller's
    process, so that the reference's PPO trains without a cluster."""

    @staticmethod
    def remote(**_):
        def wrap(cls):
            class Actor:
                @staticmethod
                def remote(*args):
                    obj = cls(*args)
                    handle = type("Handle", (), {})()
                    for name in ("sample", "ping", "stop"):
                        method = getattr(obj, name)
                        setattr(handle, name, type("M", (), {"remote": staticmethod(method)}))
                    return handle
            return Actor
        return wrap

    @staticmethod
    def get(x):
        return x

    @staticmethod
    def kill(_):
        pass


def _config(mod, env_spec, **runners):
    kw = dict(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=16)
    kw.update(runners)
    return mod.PPOConfig().environment(env_spec).env_runners(**kw).debugging(seed=0)


def test_ppo_train_on_cpu_with_the_reference_s_result(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_algorithm, "api", _InProcess)
    monkeypatch.setattr(ray_tpu.api, "put", lambda x: x)
    ref_algo = _config(ref_algorithm, "CartPole-v1").build()
    want = [ref_algo.train() for _ in range(2)]
    ref_algo.stop()

    seen = []
    record = lambda: connectors.ConnectorPipeline(  # noqa: E731
        [connectors.Lambda(lambda d, ctx: seen.append(d.shape) or d),
         connectors.FlattenObservations()])
    algo = _config(algorithm, env.CartPoleEnv, env_to_module_connector=record).build(
        device="cpu")
    got = [algo.train() for _ in range(2)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["num_env_steps_sampled"] == w["num_env_steps_sampled"] == 32
        assert all(math.isfinite(g[k]) for k in learner.STAT_KEYS)
    assert [g["training_iteration"] for g in got] == [1, 2]
    assert set(algo.timers) == {"sample_s", "postprocess_s", "learn_s"}
    assert isinstance(algo.get_policy_params()["Dense_0.kernel"], torch.Tensor)

    algo.save(str(tmp_path / "ckpt"))
    fresh = _config(algorithm, env.CartPoleEnv).build(device="cpu")
    fresh.restore(str(tmp_path / "ckpt"))
    assert fresh.iteration == 2
    want_state, got_state = algo.learner.state_dict(), fresh.learner.state_dict()
    assert got_state["opt_state"]["count"] == want_state["opt_state"]["count"] == 8
    for part in ("params",):
        for k, v in want_state[part].items():
            assert torch.equal(got_state[part][k], v), k
    for m in ("mu", "nu"):
        for k, v in want_state["opt_state"][m].items():
            assert torch.equal(got_state["opt_state"][m][k], v), k

    n_seen = len(seen)
    action = algo.compute_single_action(np.zeros(4, np.float32))
    assert len(seen) == n_seen + 1 and seen[-1] == (1, 4)  # through the connector
    assert action.dtype == np.int32 and action in (0, 1)
    assert algo.compute_single_action(np.zeros(4, np.float32)) == action  # seeded
    algo.stop()
    fresh.stop()


class _Reach:
    """A toy continuous env: actions in [-0.5, 0.5]^2, every action the env
    receives is recorded."""

    received: list = []

    def __init__(self):
        self.observation_space = env.Box(-1.0, 1.0, (3,))
        self.action_space = env.Box(-0.5, 0.5, (2,))
        self._rng = np.random.default_rng(0)
        self._t = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._rng.uniform(-1, 1, 3).astype(np.float32), {}

    def step(self, action):
        _Reach.received.append(np.array(action))
        self._t += 1
        obs = self._rng.uniform(-1, 1, 3).astype(np.float32)
        return obs, -float(np.sum(np.square(action))), False, self._t >= 10, {}


def test_ppo_continuous_actions_are_clipped_into_the_box():
    _Reach.received = []
    algo = _config(algorithm, _Reach).build(device="cpu")
    results = [algo.train() for _ in range(2)]
    acts = np.stack(_Reach.received)
    assert acts.shape == (64, 2)
    assert np.all(np.abs(acts) <= 0.5)
    assert np.sum(np.abs(acts) == 0.5) > 0  # draws past the bounds were clipped
    assert all(math.isfinite(r[k]) for r in results for k in learner.STAT_KEYS)
    assert results[1]["num_episodes"] == 4  # 2 envs x 32 steps, 10-step episodes
    algo.stop()


def test_build_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        algorithm.PPOConfig().environment(env.CartPoleEnv).build()


@pytest.mark.parametrize("option", ["use_weight_plane", "quantized"])
def test_weight_plane_raises_until_ported(option):
    cfg = algorithm.PPOConfig().environment(env.CartPoleEnv).weight_sync(**{option: True})
    with pytest.raises(NotImplementedError, match="weights/"):
        cfg.build(device="cpu")


def test_grad_scheduler_raises_until_ported():
    """Ported with the collectives: the scheduler takes the config's
    weight-sync fields, as the reference's ``grad_scheduler_for`` does."""
    from ray_tpu_torch.collective import DEFAULT_BUCKET_BYTES

    group = object()
    sched = weight_sync.grad_scheduler_for(algorithm.PPOConfig(), group)
    assert sched.group is group and sched.overlap is False
    assert sched.bucket_bytes == DEFAULT_BUCKET_BYTES and sched.stale_grad == 0
    cfg = algorithm.PPOConfig()
    cfg.overlap_grad_sync, cfg.grad_sync_bucket_bytes = True, 1 << 16
    sched = weight_sync.grad_scheduler_for(cfg, group)
    assert sched.overlap is True and sched.bucket_bytes == 1 << 16


def test_config_methods_match_the_reference():
    """Every field of the reference's PPOConfig, with its default; the
    config methods set the same fields; a connector on a config whose runners do
    not take one raises, as in the reference."""
    ref, port = ref_algorithm.PPOConfig(), algorithm.PPOConfig()
    assert vars(port) == vars(ref)
    for cfg in (ref, port):
        cfg.env_runners(num_env_runners=3, num_envs_per_env_runner=5,
                        rollout_fragment_length=7, num_cpus_per_env_runner=0.5)
        cfg.training(lr=1e-3, num_epochs=2).resources(num_tpus_for_learner=1)
        cfg.weight_sync(overlap=True, bucket_bytes=1024).debugging(seed=9)
    assert vars(port) == vars(ref)
    with pytest.raises(ValueError, match="unknown training option"):
        port.training(nope=1)
    from ray_tpu_torch.rllib.config_base import AlgorithmConfig

    with pytest.raises(NotImplementedError, match="connector"):
        AlgorithmConfig().env_runners(env_to_module_connector=connectors.default_env_to_module)
