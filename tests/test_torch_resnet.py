"""ray_tpu_torch's ResNet and its trainer example against ray_tpu's, on the CPU.

The reference's tiny ResNet trees (the shapes of its ``init_train_state``)
are filled with random values from a numpy seed, the zero- and one-start
tensors (``bn3.scale``, the biases, the running statistics) included, and
carried into the port by ``resnet_params_from_jax``. Both sides then take the
same numpy images. Tolerances are relative to the largest |value| of the
compared tensor: 1e-5 where both sides compute in f32 (the same sums in
another order, through 4 convolutions and 5 BatchNorms in a row), 2e-2 with
bf16 activations (each conv and norm output rounded to bf16, 8 bits, by
each side from f32 values that differ in their last bits, so an output
can sit one bf16 step, 2^-8 relative, away, and a few such steps add up
through the blocks).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import resnet as jres
from ray_tpu_torch.models import resnet as tres
from ray_tpu_torch.models.convert import _flatten, _load, resnet_params_from_jax
from ray_tpu_torch.train import ScalingConfig, session
from ray_tpu_torch.train.examples import resnet as example

_DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _random_tree(shapes, rng):
    """numpy values for a tree of the reference's shapes (from
    ``jax.eval_shape`` of its initialiser): conv and dense kernels normal
    with variance 1/fan-in (fan-in: every axis but the last), BatchNorm
    scale and running var in [0.5, 1.5], biases and running means
    normal(0, 0.1). No leaf keeps its zero or one start (``bn3.scale``, the
    biases, the running statistics), so a dropped or misplaced term shows."""
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = _random_tree(val, rng)
        elif key in ("scale", "var"):
            out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
        elif key in ("bias", "mean"):
            out[key] = (0.1 * rng.standard_normal(val.shape)).astype(np.float32)
        else:
            fan_in = int(np.prod(val.shape[:-1]))
            out[key] = (rng.standard_normal(val.shape) / np.sqrt(fan_in)).astype(np.float32)
    return out


def _reference_state(jcfg, seed=3):
    """The reference's ``init_train_state`` trees for ``jcfg``, with
    :func:`_random_tree` values."""
    params, stats = jax.eval_shape(
        lambda r: jres.init_train_state(jcfg, r, image_size=32), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return _random_tree(params, rng), _random_tree(stats, rng)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _flat_np(tree):
    return {k: np.asarray(v, np.float32) for k, v in _flatten(tree).items()}


def _load_stats(jstats):
    return {k: torch.from_numpy(v) for k, v in _flat_np(jstats).items()}


@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_train_and_eval_forward_match_reference(dtype):
    jdt, tdt, rel = _DTYPES[dtype]
    jcfg = jres.ResNetConfig.tiny(dtype=jdt)
    tcfg = tres.ResNetConfig.tiny(dtype=tdt)
    jparams, jstats = _reference_state(jcfg)
    params, stats = resnet_params_from_jax(jparams, jstats, tcfg, device="cpu")
    images = np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(np.float32)

    jlogits, jnew = jax.jit(jres.apply_train, static_argnums=0)(
        jcfg, jparams, jstats, jnp.asarray(images))
    logits, new = tres.apply_train(tcfg, params, stats, torch.from_numpy(images))
    assert logits.shape == (3, 10) and logits.dtype == torch.float32
    _close(logits.detach(), jlogits, rel, "train logits")
    jnew = _flat_np(jnew)
    assert new.keys() == jnew.keys()
    for name, want in jnew.items():
        _close(new[name], want, rel, name)
    moved = max(float((new[k] - stats[k]).abs().max()) for k in new)
    assert moved > 1e-3  # the statistics were updated, and the inputs were not
    assert all(torch.equal(stats[k], _load_stats(jstats)[k]) for k in stats)

    jeval = jax.jit(lambda v, x: jres.ResNet(jcfg).apply(v, x, train=False))(
        {"params": jparams, "batch_stats": jstats}, jnp.asarray(images))
    with torch.no_grad():
        got = tres.build_resnet(tcfg, params, stats)(torch.from_numpy(images), train=False)
    _close(got, jeval, rel, "eval logits")
    assert np.abs(np.asarray(jeval) - np.asarray(jlogits)).max() > 10 * rel * np.abs(jeval).max()


@pytest.mark.parametrize("size", [8, 9], ids=["even", "odd"])
def test_stride2_block_pads_as_xla_same(size):
    """The bottleneck's stride-2 3x3 conv pads (0, 1) over an even size and
    (1, 1) over an odd one, as the reference's ``padding="SAME"``."""
    assert tres.same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    assert tres.same_pads(size, 1, 2) == (0, 0)
    jcfg = jres.ResNetConfig.tiny(dtype=jnp.float32)
    tcfg = tres.ResNetConfig.tiny(dtype=torch.float32)
    x = np.random.default_rng(5).standard_normal((2, size, size, 16)).astype(np.float32)
    jblock = jres.Bottleneck(jcfg, features=8, strides=2)
    variables = jax.eval_shape(lambda r: jblock.init(r, jnp.asarray(x), train=False),
                               jax.random.PRNGKey(1))
    rng = np.random.default_rng(6)
    jvars = {name: _random_tree(tree, rng) for name, tree in variables.items()}
    jout, _ = jax.jit(lambda v, x_: jblock.apply(v, x_, train=True, mutable=["batch_stats"]))(
        jvars, jnp.asarray(x))
    jparams = jvars["params"]
    block = tres.Bottleneck(tcfg, in_ch=16, features=8, strides=2)
    want = {k: v.shape for k, v in block.named_parameters()}
    block.load_state_dict(_load(_flatten(jparams), want, torch.float32, torch.device("cpu")),
                          strict=False)
    out = block(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    assert out.shape == (2, 32, (size + 1) // 2, (size + 1) // 2)
    _close(out.detach().permute(0, 2, 3, 1), jout, 1e-5, f"block at {size}")


def test_sgd_momentum_steps_match_optax():
    """Three of the port's steps against three of the reference's, built as
    train/examples/resnet.py builds its ``train_step``: parameters, running
    statistics and losses."""
    lr = 0.05
    jcfg = jres.ResNetConfig.tiny(dtype=jnp.float32)
    tcfg = tres.ResNetConfig.tiny(dtype=torch.float32)
    jparams, jstats = _reference_state(jcfg)
    params, stats = resnet_params_from_jax(jparams, jstats, tcfg, device="cpu")
    model = tres.build_resnet(tcfg, params, stats)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    tx = optax.sgd(lr, momentum=0.9)
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    opt_state = tx.init(jparams)

    @jax.jit
    def train_step(p, s, o, images, labels):
        def loss_fn(p_):
            logits, new_s = jres.apply_train(jcfg, p_, s, images)
            return jres.cross_entropy(logits, labels), new_s

        (loss, new_s), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), new_s, o, loss

    rng = np.random.default_rng(7)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    for _ in range(3):
        images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
        labels = rng.integers(0, 10, (4,)).astype(np.int32)
        jparams, jstats, opt_state, jloss = train_step(
            jparams, jstats, opt_state, jnp.asarray(images), jnp.asarray(labels))
        loss = example.train_step(model, optimizer, torch.from_numpy(images),
                                  torch.from_numpy(labels).long())
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    # an element moves by lr x (its trace), so after three steps the two
    # sides part by the gradients' f32 difference times a few lr
    want_params, want_stats = resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), jax.tree_util.tree_map(np.asarray, jstats),
        tcfg, device="cpu")
    for name, want in want_params.items():
        _close(model.get_parameter(name).detach(), want, 1e-5, name)
    for name, want in want_stats.items():
        _close(model.get_buffer(name), want, 1e-5, name)
    moved = max(float((p.detach() - start[k]).abs().max()) for k, p in model.named_parameters())
    assert moved > 10 * lr * 1e-3  # the comparison is not of unmoved weights


def test_param_counts():
    """ResNet-50 has the canonical ~25.6 M parameters (the reference's own
    bound, tests/test_resnet.py); 50/101/152 equal torchvision's published
    v1.5 counts (the same architecture: no conv bias, BN affine, a biased
    head), and tiny's tree equals the reference's."""
    def count(cfg):
        return sum(math.prod(shape) for shape in tres.shapes(cfg)[0].values())

    n50 = count(tres.ResNetConfig.resnet50())
    assert 25_400_000 < n50 < 25_800_000
    assert n50 == 25_557_032
    assert count(tres.ResNetConfig.resnet101()) == 44_549_160
    assert count(tres.ResNetConfig.resnet152()) == 60_192_808
    jcfg = jres.ResNetConfig.tiny()
    jparams, jstats = jax.eval_shape(
        lambda r: jres.init_train_state(jcfg, r, image_size=32), jax.random.PRNGKey(0))
    param_want, stat_want = tres.shapes(tres.ResNetConfig.tiny())
    assert sorted(_flatten(jparams)) == sorted(param_want)
    assert sorted(_flatten(jstats)) == sorted(stat_want)


def test_init_train_state_follows_the_reference_initialisers():
    cfg = tres.ResNetConfig.tiny()
    params, stats = tres.init_train_state(cfg, device="cpu")
    assert all(params[k].is_contiguous(memory_format=torch.channels_last)
               for k in params if params[k].dim() == 4)
    assert not params["stage0_block0.bn3.scale"].any()
    assert bool((params["stage0_block0.bn1.scale"] == 1).all())
    assert not params["head.bias"].any()
    assert all(not v.any() for k, v in stats.items() if k.endswith(".mean"))
    assert all(bool((v == 1).all()) for k, v in stats.items() if k.endswith(".var"))
    # lecun normal: std sqrt(1 / fan_in), fan_in = kh * kw * in = 7 * 7 * 3
    std = params["stem_conv.kernel"].std().item()
    assert 0.7 * (1 / 147) ** 0.5 < std < 1.3 * (1 / 147) ** 0.5


def test_converter_rejects_missing_and_unknown_keys():
    jcfg = jres.ResNetConfig.tiny()
    tcfg = tres.ResNetConfig.tiny()
    jparams, jstats = _reference_state(jcfg)
    extra = dict(jparams, extra={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError, match="does not know"):
        resnet_params_from_jax(extra, jstats, tcfg, device="cpu")
    short = {k: v for k, v in jparams.items() if k != "stem_conv"}
    with pytest.raises(KeyError, match="missing"):
        resnet_params_from_jax(short, jstats, tcfg, device="cpu")
    short_stats = {k: v for k, v in jstats.items() if k != "stem_bn"}
    with pytest.raises(KeyError, match="batch statistics missing"):
        resnet_params_from_jax(jparams, short_stats, tcfg, device="cpu")


def test_make_trainer_fits_tiny_on_cpu(tmp_path, monkeypatch):
    """The reference's trainer test (tests/test_resnet.py), with no cluster."""
    monkeypatch.setenv("RAY_TPU_STORAGE_PATH", str(tmp_path))
    result = example.make_trainer(train_config={
        "model": "tiny", "epochs": 2, "steps_per_epoch": 2, "batch_per_worker": 4,
        "image_size": 32, "lr": 0.05, "device": "cpu",
    }).fit()
    assert result.error is None
    assert result.metrics["epoch"] == 1
    assert [m["epoch"] for m in result.metrics_history] == [0, 1]
    assert all(np.isfinite(m["loss"]) and m["rank"] == 0 for m in result.metrics_history)


def test_trainer_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_STORAGE_PATH", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    result = example.make_trainer(train_config={"model": "tiny"}).fit()
    assert isinstance(result.error, RuntimeError) and "no CUDA device" in str(result.error)
    # more workers are accepted, but the loop refuses a world size > 1 until
    # a sync-BN is ported (each rank would normalise its own shard)
    assert example.make_trainer(num_workers=2).scaling_config.num_workers == 2
    session.set_context(session.TrainContext(
        world_rank=0, local_rank=0, node_rank=0, world_size=2, local_world_size=2,
        experiment_name="sync-bn", run_dir=str(tmp_path)))
    try:
        with pytest.raises(NotImplementedError, match="sync-BN"):
            example.train_loop_per_worker({"model": "tiny", "device": "cpu"})
    finally:
        session.set_context(None)
    assert example.make_trainer().scaling_config == ScalingConfig(num_workers=1)
