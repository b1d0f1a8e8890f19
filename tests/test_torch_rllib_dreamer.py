"""ray_tpu_torch.rllib DreamerV3 against ray_tpu.rllib.dreamer, on the CPU.

The reference test's tiny config (deter 32, 4 x 4 latents, hidden 32, 21
bins, seq 8, batch 4, horizon 5), f32. Parameters are the reference's
``DreamerNets.init_params`` tree with every bias and LayerNorm parameter
moved off its start (so a misplaced leaf shows), carried over by
``dreamer_params_from_jax``. Draws are the reference's, taken from
``jax.random`` on its own key schedule and handed to the port: in
``observe`` one ``split`` per step, in ``imagine`` ``split(key, horizon)``
and then ``ka, kz`` per step, in the update ``k_wm, k_im, k_crit``. Each
assert states its tolerance: both sides compute in f32, the same sums in
other orders. The buffer is numpy on both sides and must be equal bit for
bit. The reference's algorithm runs in process through a stand-in for
``ray_tpu.api``.
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
from flax import linen as nn

from ray_tpu.rllib import dreamer as ref
from ray_tpu_torch.models.convert import _GRU_LEAVES, _flatten, dreamer_params_from_jax
from ray_tpu_torch.rllib import dreamer, env
from test_torch_rllib_dqn_sac import _close, _state_equal, _unflatten

TINY = dict(deter_dim=32, stoch_groups=4, stoch_classes=4, hidden_units=32, n_bins=21,
            seq_len=8, batch_size=4, horizon=5)
# (obs_dim, act_dim, discrete): CartPole and Pendulum
KINDS = {"discrete": (4, 2, True), "continuous": (3, 1, False)}
ENVS = {"discrete": env.CartPoleEnv, "continuous": env.PendulumEnv}
G, C = TINY["stoch_groups"], TINY["stoch_classes"]


def _cfg(mod, **kw):
    return mod.DreamerV3Config().training(**{**TINY, **kw})


@functools.lru_cache(maxsize=None)
def _ref_tree(kind, seed=0):
    """The reference's init_params tree, biases and LayerNorm parameters
    moved, the slow critic apart from the critic; numpy leaves (shared
    between tests: read them, never write)."""
    obs_dim, act_dim, discrete = KINDS[kind]
    nets = ref.DreamerNets(_cfg(ref), obs_dim, act_dim, discrete)
    flat = _flatten(jax.device_get(jax.jit(nets.init_params)(jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(seed + 100)
    out = {}
    for name, leaf in flat.items():
        leaf = np.asarray(leaf)
        if name.endswith("bias"):
            leaf = (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        elif name.endswith("scale"):
            leaf = (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        elif name.startswith("slow_critic") and name.endswith("kernel"):
            leaf = leaf + (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        out[name] = leaf
    return nets, _unflatten(out)


def _port_nets(kind, tree):
    obs_dim, act_dim, discrete = KINDS[kind]
    cfg = _cfg(dreamer)
    nets = dreamer.DreamerNets(cfg, obs_dim, act_dim, discrete)
    nets.load_state_dict(dreamer_params_from_jax(tree, cfg, obs_dim, act_dim, discrete,
                                                 device="cpu"))
    return nets


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _as_reference(flat):
    """Port tensors by name -> numpy leaves under the reference's flat
    names (the fused GRU split back into its six gates)."""
    out = {}
    for name, p in flat.items():
        p = p.detach().numpy()
        prefix, _, leaf = name.rpartition(".")
        if prefix.endswith("gru"):
            gates = _GRU_LEAVES[leaf]
            out.update({f"{prefix}.{g}": part
                        for g, part in zip(gates, np.split(p, len(gates), axis=-1))})
        else:
            out[name] = p
    return out


# -- helpers ----------------------------------------------------------------------


def test_symlog_symexp_match_reference():
    x = np.array([-1e4, -100.0, -1.5, -1e-6, 0.0, 0.3, 1.0, 42.0, 3e3], np.float32)
    for fn in ("symlog", "symexp"):
        arg = x if fn == "symlog" else np.clip(x, -20, 20)
        want = np.asarray(getattr(ref, fn)(jnp.asarray(arg)))
        got = getattr(dreamer, fn)(_t(arg)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=fn)  # 8 ulps
    # the reference test's round trip: exp(x) - 1 cancels for tiny x
    np.testing.assert_allclose(dreamer.symexp(dreamer.symlog(_t(x))).numpy(), x, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n_bins", [21, 255])
def test_twohot_matches_reference(n_bins):
    """Bins within 2 f32 ulps of 20 (jnp.linspace rounds its own way);
    encodings and losses on the same bins within 1e-6 of the largest value,
    decodings within 1e-5 (symexp's exp multiplies the expectation's
    rounding by up to 20 at the end bins); targets on bin edges, between
    bins and past both ends."""
    want_bins = np.asarray(ref.twohot_bins(n_bins))
    bins = dreamer.twohot_bins(n_bins)
    np.testing.assert_allclose(bins.numpy(), want_bins, rtol=0, atol=2 * 2.0 ** -19)
    bins = _t(want_bins)
    rng = np.random.default_rng(n_bins)
    y = np.concatenate([want_bins[[0, 1, n_bins // 2, -2, -1]], [-30.0, 25.0],
                        rng.uniform(-21, 21, 57)]).astype(np.float32).reshape(8, 8)
    _close(dreamer.twohot_encode(_t(y), bins), ref.twohot_encode(jnp.asarray(y), want_bins),
           1e-6, "encode")
    logits = rng.standard_normal((8, 8, n_bins)).astype(np.float32) * 3
    _close(dreamer.twohot_decode(_t(logits), bins),
           ref.twohot_decode(jnp.asarray(logits), want_bins), 1e-5, "decode")
    raw = np.sign(y) * np.expm1(np.minimum(np.abs(y), 8))
    _close(dreamer.twohot_loss(_t(logits), _t(raw), bins),
           ref.twohot_loss(jnp.asarray(logits), jnp.asarray(raw), want_bins), 1e-6, "loss")
    enc = dreamer.twohot_encode(_t(y), bins)
    assert ((enc > 0).sum(-1) <= 2).all()
    np.testing.assert_allclose(enc.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_latent_kl_matches_reference():
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((3, 5, G, C)).astype(np.float32) * 2 for _ in range(2))
    _close(dreamer.latent_kl(_t(a), _t(b)), ref.latent_kl(jnp.asarray(a), jnp.asarray(b)),
           1e-5, "kl")
    np.testing.assert_allclose(dreamer.latent_kl(_t(a), _t(a)).numpy(), 0.0, atol=1e-6)


def test_latent_sample_matches_reference():
    """With the reference's Gumbel draws: equal one-hots (the straight-through
    value within 1e-6), and the gradient of a weighted sum within 1e-5 of
    jax.grad's; the chosen classes as the draw give the same sample."""
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((6, G, C))).astype(np.float32)
    w = rng.standard_normal((6, G * C)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax.jit(ref.latent_sample)(jnp.asarray(logits), key)
    want_grad = jax.jit(jax.grad(lambda lg: jnp.sum(w * ref.latent_sample(lg, key))))(
        jnp.asarray(logits))
    noise = np.asarray(jax.random.gumbel(key, logits.shape))
    x = _t(logits).requires_grad_(True)
    got = dreamer.latent_sample(x, draw=_t(noise))
    (grad,) = torch.autograd.grad((_t(w) * got).sum(), x)
    np.testing.assert_array_equal(np.round(got.detach().numpy()), np.round(np.asarray(want)))
    _close(got.detach(), want, 1e-6, "sample")
    _close(grad, want_grad, 1e-5, "grad")
    idx = torch.from_numpy(np.asarray(want).reshape(6, G, C).argmax(-1))
    np.testing.assert_array_equal(dreamer.latent_sample(_t(logits), draw=idx).numpy(),
                                  dreamer.latent_sample(_t(logits), draw=_t(noise)).numpy())
    # the port's own draws: one-hot rows over each group
    rows = dreamer.latent_sample(_t(logits), torch.Generator().manual_seed(0)).reshape(6, G, C)
    np.testing.assert_allclose(rows.sum(-1).numpy(), 1.0, atol=1e-6)


def test_gumbel_law():
    """20,000 draws: the mean and variance of a standard Gumbel (Euler's
    gamma, pi^2 / 6) within 4.5 standard errors."""
    n = 20_000
    g = dreamer.gumbel((n,), torch.Generator().manual_seed(0), dtype=torch.float64)
    assert abs(g.mean().item() - 0.5772156649) <= 4.5 * math.pi / math.sqrt(6 * n)
    assert abs(g.var().item() / (math.pi ** 2 / 6) - 1) <= 4.5 * math.sqrt(2.4 / n) * 2


# -- networks ------------------------------------------------------------------------


def test_gru_cell_matches_flax():
    """The port's fused cell on the reference tree's gates against
    flax.linen.GRUCell, output and input gradients within 1e-5."""
    _, tree = _ref_tree("discrete")
    nets = _port_nets("discrete", tree)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((5, 32)).astype(np.float32)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    cell = nn.GRUCell(features=32)

    def f(h, x):
        return cell.apply({"params": _jax(tree["wm"]["gru"])}, h, x)[0]

    want = jax.jit(f)(jnp.asarray(h), jnp.asarray(x))
    gh, gx = jax.jit(jax.grad(lambda h, x: jnp.sum(jnp.sin(f(h, x))), (0, 1)))(
        jnp.asarray(h), jnp.asarray(x))
    th, tx = _t(h).requires_grad_(True), _t(x).requires_grad_(True)
    got = nets.wm.gru(tx, th)
    dh, dx = torch.autograd.grad(torch.sin(got).sum(), (th, tx))
    _close(got.detach(), want, 1e-5, "h'")
    _close(dh, gh, 1e-5, "dh")
    _close(dx, gx, 1e-5, "dx")


@pytest.mark.parametrize("kind", list(KINDS))
def test_actor_sample_matches_reference(kind):
    ref_nets, tree = _ref_tree(kind)
    nets = _port_nets(kind, tree)
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((16, ref_nets.feat_dim)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jax.jit(ref_nets.actor_sample)(_jax(tree["actor"]), jnp.asarray(feat), key)
    draw = (jax.random.gumbel if KINDS[kind][2] else jax.random.normal)(key, (16, KINDS[kind][1]))
    with torch.no_grad():
        got = nets.actor_sample(_t(feat), draw=_t(draw))
    for g, w, what in zip(got, want, ("action", "logp", "entropy")):
        assert g.shape == w.shape, what
        _close(g, w, 1e-5, what)
    if kind == "continuous":  # log_std clipped to [-5, 2]
        with torch.no_grad():
            nets.actor.Dense_3.bias.fill_(50.0)
            assert nets.actor(_t(feat))[1].eq(2.0).all()
            nets.actor.Dense_3.bias.fill_(-50.0)
            assert nets.actor(_t(feat))[1].eq(-5.0).all()


@functools.partial(jax.jit, static_argnums=(1, 2))
def _observe_keys(key, T, B):
    """observe's latent draws: one ``split`` a step."""
    out = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        out.append(jax.random.gumbel(sub, (B, G, C)))
    return out


def _observe_draws(key, T, B):
    return [np.asarray(d) for d in _observe_keys(key, T, B)]


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _imagine_keys(key, H, N, kind):
    """imagine's draws: ``split(key, H)``, then ``ka, kz`` a step."""
    act_dim, discrete = KINDS[kind][1], KINDS[kind][2]
    out = []
    for key_t in jax.random.split(key, H):
        ka, kz = jax.random.split(key_t)
        a = (jax.random.gumbel if discrete else jax.random.normal)(ka, (N, act_dim))
        out.append((a, jax.random.gumbel(kz, (N, G, C))))
    return out


def _imagine_draws(key, H, N, kind):
    return [tuple(np.asarray(d) for d in pair) for pair in _imagine_keys(key, H, N, kind)]


def _batch(kind, B, T, seed):
    obs_dim, act_dim, discrete = KINDS[kind]
    rng = np.random.default_rng(seed)
    if discrete:
        action = np.eye(act_dim, dtype=np.float32)[rng.integers(0, act_dim, (B, T))]
    else:
        action = rng.uniform(-1, 1, (B, T, act_dim)).astype(np.float32)
    is_first = rng.random((B, T)) < 0.15
    is_first[:, 0] = True
    return {
        "obs": (2 * rng.standard_normal((B, T, obs_dim))).astype(np.float32),
        "action": action,
        "reward": rng.standard_normal((B, T)).astype(np.float32),
        "is_first": is_first,
        "is_terminal": rng.random((B, T)) < 0.1,
    }


def test_observe_matches_reference():
    ref_nets, tree = _ref_tree("discrete")
    nets = _port_nets("discrete", tree)
    b = _batch("discrete", 4, 8, 7)
    key = jax.random.PRNGKey(8)
    want = jax.jit(ref_nets.observe)(_jax(tree["wm"]), jnp.asarray(b["obs"]),
                                     jnp.asarray(b["action"]), jnp.asarray(b["is_first"]), key)
    with torch.no_grad():
        got = nets.observe(_t(b["obs"]), _t(b["action"]), _t(b["is_first"]),
                           draws=[_t(d) for d in _observe_draws(key, 8, 4)])
    for g, w, what in zip(got, want, ("deter", "post", "prior", "stoch")):
        assert g.shape == w.shape, what
        _close(g, w, 1e-5, what)


@pytest.mark.parametrize("kind", list(KINDS))
def test_imagine_matches_reference(kind):
    ref_nets, tree = _ref_tree(kind)
    nets = _port_nets(kind, tree)
    rng = np.random.default_rng(9)
    N, H = 12, 5
    deter = rng.standard_normal((N, 32)).astype(np.float32)
    stoch = np.eye(C, dtype=np.float32)[rng.integers(0, C, (N, G))].reshape(N, G * C)
    key = jax.random.PRNGKey(10)
    want = jax.jit(ref_nets.imagine, static_argnums=3)(_jax(tree), jnp.asarray(deter),
                                                        jnp.asarray(stoch), H, key)
    with torch.no_grad():
        got = nets.imagine(_t(deter), _t(stoch), H,
                           draws=[[_t(d) for d in p] for p in _imagine_draws(key, H, N, kind)])
    for g, w, what in zip(got, want, ("feats", "actions", "logps", "ents")):
        assert g.shape == w.shape, what
        _close(g, w, 1e-5, what)


def test_lambda_returns_match_reference():
    """The reference's scan within 1e-6 of the largest return (the port
    adds the discounted terms in another order)."""
    cfg = _cfg(ref)
    rng = np.random.default_rng(0)
    H, N = 6, 3
    reward = rng.normal(size=(H + 1, N)).astype(np.float32)
    cont = rng.uniform(0.5, 1.0, size=(H + 1, N)).astype(np.float32)
    value = rng.normal(size=(H + 1, N)).astype(np.float32)
    want = ref.DreamerV3._lambda_returns(types.SimpleNamespace(config=cfg),
                                         *map(jnp.asarray, (reward, cont, value)))
    got = dreamer.DreamerV3._lambda_returns(types.SimpleNamespace(config=_cfg(dreamer)),
                                            *map(_t, (reward, cont, value)))
    assert got.shape == (H, N)
    _close(got, want, 1e-6, "returns")


# -- the update -------------------------------------------------------------------------


def _ref_update_fn(kind):
    cfg = _cfg(ref)
    obs_dim, act_dim, discrete = KINDS[kind]
    clip = optax.clip_by_global_norm(cfg.grad_clip)
    stub = types.SimpleNamespace(
        config=cfg, nets=ref.DreamerNets(cfg, obs_dim, act_dim, discrete),
        world_tx=optax.chain(clip, optax.adam(cfg.world_lr)),
        actor_tx=optax.chain(clip, optax.adam(cfg.actor_lr)),
        critic_tx=optax.chain(clip, optax.adam(cfg.critic_lr)))
    stub._world_loss = functools.partial(ref.DreamerV3._world_loss, stub)
    stub._lambda_returns = functools.partial(ref.DreamerV3._lambda_returns, stub)
    return stub, jax.jit(functools.partial(ref.DreamerV3._update_impl, stub))


def _update_draws(key, kind, B, T, H):
    k_wm, k_im, _ = jax.random.split(key, 3)
    return {"observe": _observe_draws(k_wm, T, B),
            "imagine": _imagine_draws(k_im, H, B * T, kind)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_update_matches_reference(kind):
    """Two full updates from the same parameters and batches, with the
    reference's draws: after each, every parameter, Adam moment and count,
    retnorm and stat against the reference's jitted ``_update_impl``.
    Parameters within 5e-6 absolute (a step moves each by up to lr, 4e-4,
    whatever its gradient's size; the largest error seen is 1.4e-6), each
    stat within 1e-4 of its value (1e-6 absolute near 0; the largest seen
    2e-6, the imagined return's mean, a sum of signed terms, 1.6e-5),
    retnorm within 1e-6, moments within 1e-4 of the largest |value| of
    each tensor."""
    stub, update = _ref_update_fn(kind)
    _, tree = _ref_tree(kind)
    params = _jax(tree)
    opt = {"wm": stub.world_tx.init(params["wm"]), "actor": stub.actor_tx.init(params["actor"]),
           "critic": stub.critic_tx.init(params["critic"])}
    retnorm = jnp.asarray(1.0, jnp.float32)
    algo = _cfg(dreamer).environment(ENVS[kind]).debugging(seed=0).build(device="cpu")
    algo.nets.load_state_dict(dreamer_params_from_jax(tree, algo.config, *KINDS[kind],
                                                      device="cpu"))
    B, T, H = TINY["batch_size"], TINY["seq_len"], TINY["horizon"]
    for it in range(2):
        batch = _batch(kind, B, T, 20 + it)
        key = jax.random.PRNGKey(30 + it)
        params, opt, retnorm, want = update(params, opt, retnorm,
                                            {k: jnp.asarray(v) for k, v in batch.items()}, key)
        got = algo._update(batch, draws=_update_draws(key, kind, B, T, H))
        assert set(dreamer.STAT_KEYS) == set(want)
        np.testing.assert_allclose(got.numpy(), [float(want[k]) for k in dreamer.STAT_KEYS],
                                   rtol=1e-4, atol=1e-6, err_msg=f"stats {it}")
        assert float(want["kl_dyn"]) >= 1.0 and got[4].item() >= 1.0  # the free-nats floor
        _close(algo.retnorm, retnorm, 1e-6, f"retnorm {it}")
        port = _as_reference(algo.nets.state_dict())
        want_flat = {k: np.asarray(v) for k, v in _flatten(jax.device_get(params)).items()}
        assert set(port) == set(want_flat)
        for name, w in want_flat.items():
            np.testing.assert_allclose(port[name], w, rtol=0, atol=5e-6,
                                       err_msg=f"{name} after {it + 1}")
        for name in ("wm", "actor", "critic"):
            adam = opt[name][1][0]
            assert algo.opt[name]["count"] == int(adam.count) == it + 1
            for moment in ("mu", "nu"):
                got_m = _as_reference({f"{name}.{k}": v
                                       for k, v in algo.opt[name][moment].items()})
                want_m = _flatten(jax.device_get({name: getattr(adam, moment)}))
                assert set(got_m) == set(want_m)
                for k, w in want_m.items():
                    _close(got_m[k], w, 1e-4, f"{name} {moment} {k} after {it + 1}")
    algo.stop()


def test_update_draws_come_from_a_seeded_generator():
    """Without ``draws`` the same iteration gives the same update, another
    iteration another one."""
    b = _batch("discrete", 4, 8, 3)
    runs = []
    for it in (2, 2, 3):
        algo = _cfg(dreamer).environment(env.CartPoleEnv).debugging(seed=1).build(device="cpu")
        algo.iteration = it
        runs.append(algo._update(b))
        algo.stop()
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# -- buffer, runner ------------------------------------------------------------------------


def test_sequence_buffer_matches_reference():
    """One operation sequence (lanes of different lengths, an empty lane,
    a wrap of the ring, an add longer than a slot's ring) on both
    buffers: sizes and every sampled batch equal bit for bit."""
    bufs = [mod.SequenceReplayBuffer(60, 3, 4, 2) for mod in (ref, dreamer)]
    rng = np.random.default_rng(11)
    assert bufs[1].sample(2, 5, seed=0) is None and bufs[0].sample(2, 5, seed=0) is None

    def lane(n):
        return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
                "action": rng.standard_normal((n, 2)).astype(np.float32),
                "reward": rng.standard_normal(n).astype(np.float32),
                "is_first": rng.random(n) < 0.2, "is_terminal": rng.random(n) < 0.1}

    for step, lengths in enumerate(((7, 3, 0), (9, 12, 4), (15, 2, 30), (6, 6, 6), (1, 25, 3))):
        seqs = [lane(n) for n in lengths]
        sizes = [b.add([0, 1, 2], seqs) for b in bufs]
        assert sizes[0] == sizes[1] == bufs[1].size()
        for L in (3, 8):
            want, got = (b.sample(5, L, seed=step * 10 + L) for b in bufs)
            assert (want is None) == (got is None)
            if want is None:
                continue
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert bufs[1].size() == 60


def _runner_params(runner):
    return {name: dict(getattr(runner.nets, name).named_parameters()) for name in ("wm", "actor")}


def test_runner_arrival_alignment():
    """Rollout records follow the arrival convention: records with
    is_first carry zero in-action/reward, episode ends append a terminal
    arrival record (the pre-auto-reset obs), and action[t] is the action
    that led INTO obs_t (the reference test's asserts, on the port's
    CartPoleEnv)."""
    cfg = _cfg(dreamer)
    runner = dreamer.DreamerRunner(env.CartPoleEnv, {}, 2, 64, seed=0,
                                   net_kwargs=cfg._net_kwargs())
    out = runner.sample(_runner_params(runner))
    assert len(out["sequences"]) == 2
    saw_terminal = False
    for seq in out["sequences"]:
        T = len(seq["reward"])
        assert T >= 64  # one arrival per step + terminal extras
        assert seq["is_first"][0]
        np.testing.assert_array_equal(seq["action"][0], 0.0)
        assert seq["reward"][0] == 0.0
        assert seq["obs"].dtype == np.float32 and seq["action"].shape == (T, 2)
        for t in range(T):
            if seq["is_first"][t]:
                np.testing.assert_array_equal(seq["action"][t], 0.0)
                assert seq["reward"][t] == 0.0
                assert not seq["is_terminal"][t]
            if seq["is_terminal"][t]:
                saw_terminal = True
                assert np.abs(seq["action"][t]).sum() > 0
                if t + 1 < T:
                    assert seq["is_first"][t + 1]
    assert saw_terminal
    assert len(out["episode_returns"]) > 0
    assert all(p.device.type == "cpu" for p in runner.nets.parameters())
    runner.stop()


def test_runner_acts_in_the_box_and_draws_from_its_seed():
    """Pendulum: actions recorded in [-1, 1] (tanh space), two runners of
    one seed equal bit for bit, another seed another rollout."""
    cfg = _cfg(dreamer)
    outs = []
    for seed in (3, 3, 4):
        runner = dreamer.DreamerRunner(env.PendulumEnv, {"max_episode_steps": 20}, 1, 30, seed,
                                       cfg._net_kwargs())
        outs.append(runner.sample(_runner_params(dreamer.DreamerRunner(
            env.PendulumEnv, {}, 1, 1, 0, cfg._net_kwargs())))["sequences"][0])
    assert np.abs(outs[0]["action"]).max() <= 1.0
    assert outs[0]["is_terminal"].sum() == 0 and len(outs[0]["reward"]) == 30 + 1
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert not np.array_equal(outs[0]["action"], outs[2]["action"])


# -- whole runs, checkpoints, errors --------------------------------------------------------


def _train_config(mod, env_spec, **kw):
    return (_cfg(mod, learning_starts=32, buffer_capacity=2048, **kw)
            .environment(env_spec)
            .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .debugging(seed=0))


_RESULT_KEYS = {"training_iteration", "episode_return_mean", "num_episodes", "buffer_size",
                "num_env_steps_sampled", "time_this_iter_s"}


def test_train_on_cpu_discrete_and_checkpoint(tmp_path):
    """CartPole: learning engages, stats finite, kl_dyn at the free-nats
    floor or above; save/restore bit for bit with the optimizer state (the
    departure from the reference); a restored learner trains on."""
    algo = _train_config(dreamer, env.CartPoleEnv).build(device="cpu")
    results = [algo.train() for _ in range(3)]
    learned = [r for r in results if "wm_loss" in r]
    assert len(learned) == 3
    for r in learned:
        assert set(r) == _RESULT_KEYS | set(dreamer.STAT_KEYS)
        assert all(math.isfinite(r[k]) for k in dreamer.STAT_KEYS)
        assert r["kl_dyn"] >= 1.0 - 1e-5
    assert set(algo.timers) == {"sample_s", "buffer_s", "learn_s"}
    assert {s["count"] for s in algo.opt.values()} == {3}
    assert algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1)

    algo.save(str(tmp_path / "ckpt"))
    fresh = _train_config(dreamer, env.CartPoleEnv).build(device="cpu")
    fresh.restore(str(tmp_path / "ckpt"))
    _state_equal(fresh.state_dict(), algo.state_dict())
    assert fresh.iteration == 3 and fresh.opt["wm"]["count"] == 3
    assert not fresh.nets.slow_critic.Dense_0.kernel.requires_grad
    assert fresh.train()["training_iteration"] == 4
    algo.stop()
    fresh.stop()


def test_reference_restore_drops_the_optimizer_state(tmp_path):
    """The pinned departure, the reference's side: its save keeps no Adam
    state and its restore re-initialises all three (counts back to 0); the
    port's keeps them (the test above)."""
    _, tree = _ref_tree("discrete")
    stub, _ = _ref_update_fn("discrete")
    params = _jax(tree)
    stub.params, stub.retnorm, stub.iteration = params, jnp.asarray(2.0), 3
    stub.opt = jax.tree.map(lambda x: x + 1, {
        "wm": stub.world_tx.init(params["wm"]), "actor": stub.actor_tx.init(params["actor"]),
        "critic": stub.critic_tx.init(params["critic"])})
    ref.DreamerV3.save(stub, str(tmp_path / "ckpt"))
    ref.DreamerV3.restore(stub, str(tmp_path / "ckpt"))
    assert stub.iteration == 3 and float(stub.retnorm) == 2.0
    assert {int(stub.opt[k][1][0].count) for k in stub.opt} == {0}


def test_train_on_cpu_continuous():
    """Pendulum: learning engages, stats finite, the deployed action inside
    the env's [-2, 2]."""
    algo = (_cfg(dreamer, learning_starts=24, buffer_capacity=1024, batch_size=2, horizon=4)
            .environment(env.PendulumEnv)
            .env_runners(num_env_runners=1, num_envs_per_env_runner=1,
                         rollout_fragment_length=24)
            .debugging(seed=3).build(device="cpu"))
    result = None
    for _ in range(2):
        result = algo.train()
    assert "wm_loss" in result and all(math.isfinite(result[k]) for k in dreamer.STAT_KEYS)
    a = algo.compute_single_action(np.zeros(3, np.float32))
    assert a.shape == (1,) and -2.0 <= float(a[0]) <= 2.0
    algo.stop()


def test_compute_single_action_matches_reference_with_its_draw():
    """The reference draws the latent from PRNGKey(0), the port from a
    generator seeded 0 (the pinned departure): given the reference's draw,
    the port's action is the reference's; without it, the port's own fixed
    draw gives the same action every call."""
    ref_nets, tree = _ref_tree("discrete")
    algo = _train_config(dreamer, env.CartPoleEnv).build(device="cpu")
    algo.nets.load_state_dict(dreamer_params_from_jax(tree, algo.config, *KINDS["discrete"],
                                                      device="cpu"))
    stub = types.SimpleNamespace(nets=ref_nets, params=_jax(tree), config=_cfg(ref),
                                 _obs_space=algo._obs_space)
    draw = np.asarray(jax.random.gumbel(jax.random.PRNGKey(0), (1, G, C)))
    for obs in np.random.default_rng(6).standard_normal((4, 4)).astype(np.float32):
        want = ref.DreamerV3.compute_single_action(stub, obs)
        assert algo.compute_single_action(obs, draw=draw) == want
        assert algo.compute_single_action(obs) == algo.compute_single_action(obs)
    algo.stop()


def test_device_placement_and_no_card(monkeypatch):
    """build(device="cpu") puts every learner tensor on the CPU and the
    runners' nets stay on the host; build() without a card raises."""
    algo = _train_config(dreamer, env.CartPoleEnv).build(device="cpu")
    tensors = [*algo.nets.parameters(), algo.retnorm,
               *(t for s in algo.opt.values() for m in ("mu", "nu") for t in s[m].values())]
    assert all(t.device.type == "cpu" for t in tensors)
    assert all(p.device.type == "cpu" for r in algo.runners for p in r.nets.parameters())
    algo.stop()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _train_config(dreamer, env.CartPoleEnv).build()


def test_config_matches_the_reference():
    assert vars(dreamer.DreamerV3Config()) == vars(ref.DreamerV3Config())
    assert dreamer.DreamerV3Config()._net_kwargs() == ref.DreamerV3Config()._net_kwargs()
    with pytest.raises(NotImplementedError, match="connector"):
        dreamer.DreamerV3Config().env_runners(env_to_module_connector=lambda: None)
    with pytest.raises(ValueError, match="environment"):
        dreamer.DreamerV3Config().build(device="cpu")


def test_converter_rejects_bad_trees():
    _, tree = _ref_tree("discrete")
    cfg = _cfg(dreamer)
    args = (cfg, 4, 2, True)
    got = dreamer_params_from_jax(tree, *args, device="cpu")
    assert set(got) == set(dreamer.DreamerNets(*args).state_dict())
    flat = _flatten(tree)
    for drop in ("wm.gru.hz.kernel", "actor.Dense_2.bias"):
        with pytest.raises(KeyError, match="missing"):
            dreamer_params_from_jax(_unflatten({k: v for k, v in flat.items() if k != drop}),
                                    *args, device="cpu")
    with pytest.raises(KeyError, match="does not know"):
        dreamer_params_from_jax(_unflatten({**flat, "wm.gru.hr.bias": np.zeros(32, np.float32)}),
                                *args, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        dreamer_params_from_jax(tree, cfg, 5, 2, True, device="cpu")


def test_init_is_seeded_and_flax_like():
    """Same seed, same weights; lecun-normal kernels within their
    truncation, orthogonal recurrent gates, zero biases, unit LayerNorm
    scales, the slow critic a copy of the critic."""
    args = (_cfg(dreamer), 4, 2, True)
    a, b, c = (dreamer.DreamerNets(*args).init_params(s) for s in (4, 4, 5))
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(p, q), name
        if name.endswith("kernel") or name.endswith("kernel_i"):
            assert not torch.equal(p, r), name
            bound = 2 * math.sqrt(1 / p.shape[0]) / 0.87962566103423978
            assert p.abs().max() <= bound * (1 + 1e-6), name
        elif name.endswith("scale"):
            assert p.eq(1).all(), name
        elif "bias" in name:
            assert p.eq(0).all(), name
    for gate in a.wm.gru.kernel_h.detach().chunk(3, 1):
        torch.testing.assert_close(gate.T @ gate, torch.eye(32), rtol=0, atol=1e-5)
    _state_equal(a.slow_critic.state_dict(), a.critic.state_dict())
