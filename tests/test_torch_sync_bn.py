"""Sync-BN data parallelism of the port against the reference, on the CPU.

The reference shards a batch over a ``dp`` mesh and XLA makes BatchNorm's
plain means global (``ray_tpu/models/resnet.py:11-14``) and transposes its
collectives in the backward. The port runs a gang of two spawned gloo ranks
(``resources_per_worker={"CPU": 1}``), each on its half of a global batch
made from numpy seeds, and holds them to one process on the whole batch:

- ``collective.functional``: ``all_reduce_sum`` and ``all_gather_cat``
  and their gradients against the same function of the stacked inputs;
- one sync-BN ``BatchNorm`` against flax's ``nn.BatchNorm`` on the global
  batch: output, running statistics, input and parameter gradients;
- the tiny f32 ResNet, 3 SGD momentum steps through the example's
  ``train_step`` and ``DataParallelMean`` against the reference's
  ``apply_train`` + ``optax.sgd(momentum=0.9)`` on the global batch, the
  ranks bit-identical to each other;
- ``make_trainer(num_workers=2).fit()``.

Tolerances are relative to the largest |value| of the compared tensor:
1e-5 for f32 (the same sums in another order; the sync-BN's statistics are
the mean of the ranks' means), as tests/test_torch_resnet.py.

The workers import this module by name, so it imports neither ``jax`` nor
``ray_tpu`` at its top.
"""

import multiprocessing
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import train
from ray_tpu_torch.train import collective as tcol
from ray_tpu_torch.train.examples import resnet as example

_DEADLINE_S = 150.0
_LR = 0.05
_RANKS = 2
_CPU = {"CPU": 1}
_REL = 1e-5


def _fit(trainer):
    """``trainer.fit()`` within the deadline; past it every worker is
    killed and the test fails."""
    box = []
    thread = threading.Thread(target=lambda: box.append(trainer.fit()), daemon=True)
    thread.start()
    thread.join(_DEADLINE_S)
    if thread.is_alive():
        for child in multiprocessing.active_children():
            child.kill()
        thread.join(10)
        pytest.fail(f"fit() did not finish in {_DEADLINE_S} s; its workers were killed")
    assert not multiprocessing.active_children()
    return box[0]


def _trainer(loop, config, storage, **kw):
    return train.DataParallelTrainer(
        loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(_RANKS, _CPU),
        run_config=train.RunConfig(name="sync-bn", storage_path=storage),
        backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)), **kw)


def _close(got, want, what, rel=_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _sync_bn_loop(config):
    """Each rank: the functional collectives, one BatchNorm and three
    ResNet steps on its rows; everything reported."""
    from torch import nn

    from ray_tpu_torch.collective.functional import all_gather_cat, all_reduce_sum
    from ray_tpu_torch.models import resnet as tres
    from ray_tpu_torch.models.convert import resnet_params_from_jax

    torch.set_num_threads(1)
    ctx = train.get_context()
    r, world = ctx.world_rank, ctx.world_size
    group = tcol.tensor_group()
    out = {"rank": r}

    x = torch.from_numpy(config["x"][r]).requires_grad_(True)
    y = all_reduce_sum(x, group)
    (y * torch.from_numpy(config["w"][r])).sum().backward()
    out.update(ar_y=y.detach().numpy(), ar_grad=x.grad.numpy())
    x = torch.from_numpy(config["x"][r]).requires_grad_(True)
    z = all_gather_cat(x, group, 1)
    (z * torch.from_numpy(config["v"][r])).sum().backward()
    out.update(ag_z=z.detach().numpy(), ag_grad=x.grad.numpy())

    bn_cfg = config["bn"]
    bn = tres.BatchNorm(bn_cfg["scale"].shape[0], torch.float32, torch.float32, group)
    bn.scale = nn.Parameter(torch.from_numpy(bn_cfg["scale"]))
    bn.bias = nn.Parameter(torch.from_numpy(bn_cfg["bias"]))
    bn.mean.copy_(torch.from_numpy(bn_cfg["mean"]))
    bn.var.copy_(torch.from_numpy(bn_cfg["var"]))
    rows = slice(r * len(bn_cfg["x"]) // world, (r + 1) * len(bn_cfg["x"]) // world)
    xb = torch.from_numpy(bn_cfg["x"][rows]).requires_grad_(True)
    yb = bn(xb.permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    (yb * torch.from_numpy(bn_cfg["g"][rows])).sum().backward()
    out["bn"] = dict(y=yb.detach().numpy(), dx=xb.grad.numpy(), dscale=bn.scale.grad.numpy(),
                     dbias=bn.bias.grad.numpy(), mean=bn.mean.numpy().copy(),
                     var=bn.var.numpy().copy())

    tcfg = tres.ResNetConfig.tiny(dtype=torch.float32)
    params, stats = resnet_params_from_jax(config["params"], config["stats"], tcfg, device="cpu")
    model = tres.build_resnet(tcfg, params, stats, group=group)
    optimizer = torch.optim.SGD(model.parameters(), lr=_LR, momentum=0.9)
    reduce = tcol.DataParallelMean(world)
    losses = []
    for images, labels in config["batches"]:
        b = len(images) // world
        loss = example.train_step(model, optimizer, torch.from_numpy(images[r * b:(r + 1) * b]),
                                  torch.from_numpy(labels[r * b:(r + 1) * b]).long(), reduce)
        losses.append(tcol.gang_mean(loss))
    out["losses"] = losses
    out["params"] = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    out["stats"] = {k: v.numpy().copy() for k, v in model.batch_stats().items()}
    train.report(out)


def _random_tree(shapes, rng):
    """numpy values for a tree of the reference's shapes, as
    tests/test_torch_resnet.py draws them: no leaf keeps its zero or one
    start."""
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


@pytest.fixture(scope="module")
def gang():
    """The gang's reports by rank, and the config they ran on; the
    reference computes while the gang runs."""
    import jax

    from ray_tpu.models import resnet as jres

    rng = np.random.default_rng(21)
    jcfg = jres.ResNetConfig.tiny(dtype=jax.numpy.float32)
    pshapes, sshapes = jax.eval_shape(
        lambda k: jres.init_train_state(jcfg, k, image_size=32), jax.random.PRNGKey(0))
    channels = 6
    config = {
        "x": rng.standard_normal((_RANKS, 3, 4)).astype(np.float32),
        "w": rng.standard_normal((_RANKS, 3, 4)).astype(np.float32),
        "v": rng.standard_normal((_RANKS, 3, 4 * _RANKS)).astype(np.float32),
        "bn": {"x": (1.5 * rng.standard_normal((4, 5, 5, channels)) + 0.3).astype(np.float32),
               "g": rng.standard_normal((4, 5, 5, channels)).astype(np.float32),
               "scale": rng.uniform(0.5, 1.5, channels).astype(np.float32),
               "bias": (0.1 * rng.standard_normal(channels)).astype(np.float32),
               "mean": (0.1 * rng.standard_normal(channels)).astype(np.float32),
               "var": rng.uniform(0.5, 1.5, channels).astype(np.float32)},
        "params": _random_tree(pshapes, rng),
        "stats": _random_tree(sshapes, rng),
        "batches": [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                     rng.integers(0, 10, (4,)).astype(np.int32)) for _ in range(3)],
    }
    with tempfile.TemporaryDirectory() as storage:
        result = _fit(_trainer(_sync_bn_loop, config, storage))
    assert result.error is None, result.error
    reports = {m["rank"]: m for m in result.metrics_history}
    assert sorted(reports) == list(range(_RANKS))
    return reports, config


def test_all_reduce_sum_and_all_gather_cat_gradients(gang):
    """Against the one-process function of the stacked inputs: every value
    and gradient equal (gloo sums in rank order, as ``x0 + x1``)."""
    reports, config = gang
    x = torch.from_numpy(config["x"]).requires_grad_(True)
    y = x.sum(0)
    sum((y * torch.from_numpy(w)).sum() for w in config["w"]).backward()
    ar_grad = x.grad.numpy()
    x = torch.from_numpy(config["x"]).requires_grad_(True)
    z = torch.cat(list(x), dim=1)
    sum((z * torch.from_numpy(v)).sum() for v in config["v"]).backward()
    for r, m in reports.items():
        np.testing.assert_array_equal(m["ar_y"], y.detach().numpy())
        np.testing.assert_array_equal(m["ar_grad"], ar_grad[r])
        np.testing.assert_array_equal(m["ag_z"], z.detach().numpy())
        np.testing.assert_array_equal(m["ag_grad"], x.grad.numpy()[r])


def test_sync_batchnorm_matches_reference_on_the_global_batch(gang):
    """Two ranks' sync-BN against flax ``nn.BatchNorm`` on the whole batch
    (loss: the sum of y * g over it): each rank's rows of the output and of
    the input gradient, the ranks' parameter gradients summed, and every
    rank's running statistics."""
    import jax
    import jax.numpy as jnp
    import flax.linen as fnn

    reports, config = gang
    cfg = config["bn"]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.float32, param_dtype=jnp.float32)
    stats = {"mean": jnp.asarray(cfg["mean"]), "var": jnp.asarray(cfg["var"])}

    def loss(x, params):
        y, new = bn.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
        return (y * cfg["g"]).sum(), (y, new["batch_stats"])

    params = {"scale": jnp.asarray(cfg["scale"]), "bias": jnp.asarray(cfg["bias"])}
    (_, (y, new)), (dx, dparams) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cfg["x"]), params)
    rows = len(cfg["x"]) // _RANKS
    for r, m in reports.items():
        part = slice(r * rows, (r + 1) * rows)
        _close(m["bn"]["y"], np.asarray(y)[part], f"rank {r} output")
        _close(m["bn"]["dx"], np.asarray(dx)[part], f"rank {r} input gradient")
        _close(m["bn"]["mean"], new["mean"], f"rank {r} running mean")
        _close(m["bn"]["var"], new["var"], f"rank {r} running var")
        np.testing.assert_array_equal(m["bn"]["mean"], reports[0]["bn"]["mean"])
        np.testing.assert_array_equal(m["bn"]["var"], reports[0]["bn"]["var"])
    for name in ("scale", "bias"):
        _close(sum(m["bn"][f"d{name}"] for m in reports.values()), dparams[name],
               f"{name} gradient")
    # the statistics are the global batch's, not a rank's own
    own = cfg["x"][:rows].mean(axis=(0, 1, 2))
    assert np.abs(own - np.asarray(new["mean"]) * 10 + cfg["mean"] * 9).max() > 1e-2


def test_tiny_resnet_sgd_steps_match_reference_on_the_global_batch(gang):
    """Three steps of the port at 2 ranks (2 rows each) against three of
    the reference's on the batch of 4, built as its example builds
    ``train_step``: the gang's reported losses, every parameter and running
    statistic."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import resnet as jres
    from ray_tpu_torch.models import resnet as tres
    from ray_tpu_torch.models.convert import resnet_params_from_jax

    reports, config = gang
    jcfg = jres.ResNetConfig.tiny(dtype=jnp.float32)
    tx = optax.sgd(_LR, momentum=0.9)
    jparams = jax.tree_util.tree_map(jnp.asarray, config["params"])
    jstats = jax.tree_util.tree_map(jnp.asarray, config["stats"])
    opt_state = tx.init(jparams)

    @jax.jit
    def train_step(p, s, o, images, labels):
        def loss_fn(p_):
            logits, new_s = jres.apply_train(jcfg, p_, s, images)
            return jres.cross_entropy(logits, labels), new_s

        (loss, new_s), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), new_s, o, loss

    jlosses = []
    for images, labels in config["batches"]:
        jparams, jstats, opt_state, jloss = train_step(
            jparams, jstats, opt_state, jnp.asarray(images), jnp.asarray(labels))
        jlosses.append(float(jloss))
    tcfg = tres.ResNetConfig.tiny(dtype=torch.float32)
    want_params, want_stats = resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), jax.tree_util.tree_map(np.asarray, jstats),
        tcfg, device="cpu")
    start, _ = resnet_params_from_jax(config["params"], config["stats"], tcfg, device="cpu")
    for r, m in reports.items():
        for got, want in zip(m["losses"], jlosses):
            assert abs(got - want) <= _REL * abs(want)
        for name, want in want_params.items():
            _close(m["params"][name], want, f"rank {r} {name}")
        for name, want in want_stats.items():
            _close(m["stats"][name], want, f"rank {r} {name}")
    moved = max(np.abs(reports[0]["params"][k] - v.numpy()).max() for k, v in start.items())
    assert moved > 1e-2  # the steps moved the parameters


def test_ranks_stay_bit_identical(gang):
    reports, _ = gang
    for m in reports.values():
        assert m["losses"] == reports[0]["losses"]
        for part in ("params", "stats"):
            for name, a in m[part].items():
                np.testing.assert_array_equal(a, reports[0][part][name])


def test_make_trainer_fits_two_gloo_workers(tmp_path):
    """The example's own loop at 2 workers on the CPU, 2 epochs of 2 steps
    with overlapped gradient buckets: every rank reports the gang's one
    loss a epoch."""
    trainer = example.make_trainer(
        num_workers=2, resources_per_worker=_CPU,
        backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)),
        train_config={"model": "tiny", "device": "cpu", "epochs": 2, "steps_per_epoch": 2,
                      "batch_per_worker": 2, "lr": 0.05},
        overlap=True)
    trainer.run_config = train.RunConfig(name="resnet-dp", storage_path=str(tmp_path))
    start = time.monotonic()
    result = _fit(trainer)
    assert result.error is None, result.error
    assert time.monotonic() - start < _DEADLINE_S
    by_epoch = {}
    for m in result.metrics_history:
        by_epoch.setdefault(m["epoch"], {})[m["rank"]] = m["loss"]
    assert sorted(by_epoch) == [0, 1]
    for losses in by_epoch.values():
        assert sorted(losses) == [0, 1] and losses[0] == losses[1] and np.isfinite(losses[0])
