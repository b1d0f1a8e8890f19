"""The ViT over a mesh of the port against the reference's, on the CPU.

The reference trains ViT on an 8-device mesh, ``dp=2 x fsdp=2 x tp=2``
(tests/test_vit.py): one GSPMD program over its parameters placed by
``param_shardings``, ``constrain`` on the activations. The port runs one
gang of eight spawned gloo ranks (``train.DataParallelTrainer``), each a
process holding its block of every parameter and its rows of the global
batch, in four rounds over the gang's ranks: the target mesh on all
eight; ``dp=2 x tp=2`` and ``fsdp=2 x tp=2`` on four each; ``tp=2``,
``fsdp=2``, ``dp=2`` and ``ep=2`` (an axis the ViT does not split) on two
each; ``dcn=2 x dp=2 x fsdp=2`` on all eight. Every round's groups are
formed by every rank in one order (``Mesh.form_groups`` over the gang's
ranks; the full-gang meshes' by ``train.collective.gang_mesh``).

The tiny f32 config (2 layers, 4 heads of 16, 10 classes, 17 tokens) with
the reference's tree filled from a numpy seed (the biases, ``head`` and
``cls_token`` included), a global batch of 8 images. Each rank's logits,
its loss and its gradient blocks (after ``model.fsdp.sync_gradients``) are
held against the reference's ``jax.value_and_grad`` of
``classification_loss(config, mesh, ...)`` jitted on the target mesh,
computed while the gang runs. GSPMD gives one function on any mesh, so its
numbers on the target mesh are the sub-meshes' too. Tolerances, relative to
the largest |value| of the whole tensor, as tests/test_torch_vit.py's f32
ones: logits and the loss 1e-5, gradients 1e-4 (``wk.bias``'s true
gradient is 0: softmax cancels it; there 1e-5 of ``wk.kernel``'s). The
ranks that hold one block hold one gradient, bit for bit: a parameter
replicated over ``tp`` is not reduced over it, the Megatron pair makes its
gradient whole on every rank.

The workers import this module by name, so it imports neither ``jax`` nor
``ray_tpu`` at its top.
"""

import multiprocessing
import tempfile
import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch import train
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel.mesh import BATCH_AXES, make_mesh

_DEADLINE_S = 150.0
_RANKS = 8
_BATCH = 8
# rounds of (name, axes, the gang's ranks it spans); the rounds run in turn
_ROUNDS = [
    [("dp2_fsdp2_tp2", {"dp": 2, "fsdp": 2, "tp": 2}, list(range(8)))],
    [("dp2_tp2", {"dp": 2, "fsdp": 1, "tp": 2}, [0, 1, 2, 3]),
     ("fsdp2_tp2", {"fsdp": 2, "tp": 2}, [4, 5, 6, 7])],
    [("tp2", {"fsdp": 1, "tp": 2}, [0, 1]), ("fsdp2", {"fsdp": 2}, [2, 3]),
     ("dp2", {"dp": 2, "fsdp": 1}, [4, 5]), ("ep2", {"ep": 2, "fsdp": 1}, [6, 7])],
    # every data axis: an fsdp block's gradient is summed over dcn x dp
    [("dcn2_dp2_fsdp2", {"dcn": 2, "dp": 2, "fsdp": 2}, list(range(8)))],
]
_MESHES = {name: (axes, ranks) for rnd in _ROUNDS for name, axes, ranks in rnd}


def _tiny():
    return tvit.ViTConfig.tiny(dtype=torch.float32)


def _batch(seed=19):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((_BATCH, 32, 32, 3)).astype(np.float32)
    return images, rng.integers(0, 10, (_BATCH,)).astype(np.int32)


def _vit_loop(config):
    """Each round: form every mesh's groups (all ranks, one order), then on
    the rank's own mesh: logits, loss, the synced gradients."""
    from ray_tpu_torch.models.convert import vit_params_from_jax
    from ray_tpu_torch.train import collective as tcol

    torch.set_num_threads(1)
    rank = train.get_context().world_rank
    tcfg = _tiny()
    params = vit_params_from_jax(config["params"], tcfg, device="cpu")
    images, labels = (torch.from_numpy(a) for a in _batch())
    for rnd in _ROUNDS:
        own = None
        for name, axes, ranks in rnd:
            if len(ranks) == _RANKS:
                mesh = tcol.gang_mesh("cpu", **axes)
            else:
                mesh = make_mesh(devices=["cpu"] * len(ranks), **axes).form_groups(
                    "gloo", world_ranks=ranks, name=name)
            if mesh is not None:
                own = name, mesh
        name, mesh = own
        model = tvit.build_vit(tcfg, params, mesh)
        shard = mesh.axes_index(BATCH_AXES)
        rows = slice(shard * _BATCH // mesh.axes_size(BATCH_AXES),
                     (shard + 1) * _BATCH // mesh.axes_size(BATCH_AXES))
        with torch.no_grad():
            logits = model(images[rows])
        loss = tvit.classification_loss(tcfg, mesh, model, images[rows], labels[rows])
        loss.backward()
        model.fsdp.sync_gradients(model.named_parameters())
        train.report({"rank": rank, "mesh": name, "mesh_rank": mesh.rank, "rows": rows,
                      "logits": logits.numpy(), "loss": loss.item(),
                      "reported": tcol.gang_mean(loss, mesh) if len(rnd) == 1 else None,
                      "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
                      "block_shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}})


def _reference_tree(jcfg):
    import jax

    from ray_tpu.models import vit as jvit
    from ray_tpu.parallel.sharding import unbox_params

    shapes = jax.eval_shape(lambda r: unbox_params(jvit.init_params(jcfg, r)),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(18)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key == "scale":
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif key == "bias":
                out[key] = (0.1 * rng.standard_normal(val.shape)).astype(np.float32)
            else:
                fan_in = int(np.prod(val.shape[:-1]))
                out[key] = (rng.standard_normal(val.shape) / np.sqrt(fan_in)).astype(np.float32)
        return out

    return fill(shapes)


@pytest.fixture(scope="module")
def vit_run():
    """The gang's reports, and the reference's logits, loss, gradients and
    parameter specs on the target mesh, computed while the gang runs."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import vit as jvit
    from ray_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ray_tpu.parallel.sharding import param_shardings as jax_param_shardings
    from ray_tpu_torch.models.convert import _flatten

    jcfg = jvit.ViTConfig.tiny(dtype=jnp.float32)
    params = _reference_tree(jcfg)
    box = []
    with tempfile.TemporaryDirectory() as storage:
        trainer = train.DataParallelTrainer(
            _vit_loop, train_loop_config={"params": params},
            scaling_config=train.ScalingConfig(_RANKS, {"CPU": 1}),
            run_config=train.RunConfig(name="vit-mesh", storage_path=storage),
            backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)))
        thread = threading.Thread(target=lambda: box.append(trainer.fit()), daemon=True)
        thread.start()

        mesh = jax_make_mesh(num_devices=8, dp=2, fsdp=2, tp=2)
        shardings = jax_param_shardings(mesh, jvit.init_params(jcfg, jax.random.PRNGKey(0)))
        placed = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params), shardings)
        images, labels = (jnp.asarray(a) for a in _batch())

        @jax.jit
        def run(p):
            logits = jvit.ViT(jcfg, mesh).apply({"params": p}, images)
            loss, grads = jax.value_and_grad(
                lambda q: jvit.classification_loss(jcfg, mesh, q, images, labels))(p)
            return logits, loss, grads

        logits, loss, grads = run(placed)
        specs = {k: tuple(v.spec) for k, v in _flatten(shardings).items()}
        reference = dict(logits=np.asarray(logits), loss=float(loss), specs=specs,
                         grads=jax.tree_util.tree_map(np.asarray, grads), params=params)
        thread.join(_DEADLINE_S)
        if thread.is_alive():
            for child in multiprocessing.active_children():
                child.kill()
            thread.join(10)
            pytest.fail(f"fit() did not finish in {_DEADLINE_S} s; its workers were killed")
    assert not multiprocessing.active_children()
    result = box[0]
    assert result.error is None, result.error
    reports = {}
    for m in result.metrics_history:
        reports.setdefault(m["mesh"], {})[m["mesh_rank"]] = m
    for name, (axes, ranks) in _MESHES.items():
        assert sorted(reports[name]) == list(range(len(ranks))), name
    return reports, reference


def _close(got, want, rel, what, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _layout(name):
    from ray_tpu_torch.parallel.sharding import param_shardings, vit_logical_axes

    axes, ranks = _MESHES[name]
    mesh = make_mesh(devices=["cpu"] * len(ranks), **axes)
    return mesh, param_shardings(mesh, tvit.param_shapes(_tiny()), None, vit_logical_axes)


def test_parameter_specs_are_the_references(vit_run):
    """Every parameter's spec on the target mesh is the reference's
    ``param_shardings``' (the patch kernel's axes permuted from flax's HWIO
    to the port's OIHW), with the same entry for a dimension left whole."""
    _, reference = vit_run
    _, shardings = _layout("dp2_fsdp2_tp2")
    for name, sharding in shardings.items():
        want = reference["specs"][name]
        if name == "patch_embed.kernel":
            want = tuple(want[i] for i in (3, 2, 0, 1))
        got = tuple(sharding.spec) + (None,) * (len(want) - len(sharding.spec))
        assert got == want + (None,) * (len(got) - len(want)), name


@pytest.mark.parametrize("name", list(_MESHES))
def test_logits_loss_and_gradients_match_the_reference(vit_run, name):
    """Each rank's logits are its rows of the reference's, its loss the
    global batch's, and its gradient blocks the reference's gradients'
    blocks; the ranks holding one block hold one gradient, bit for bit."""
    from ray_tpu_torch.models.convert import vit_params_from_jax

    reports, reference = vit_run
    tcfg = _tiny()
    want = vit_params_from_jax(reference["grads"], tcfg, device="cpu")
    mesh, shardings = _layout(name)
    held = {}
    for r, m in reports[name].items():
        _close(m["logits"], reference["logits"][m["rows"]], 1e-5, f"{name} rank {r} logits",
               np.abs(reference["logits"]).max())
        assert abs(m["loss"] - reference["loss"]) <= 1e-5 * abs(reference["loss"])
        if m["reported"] is not None:
            assert abs(m["reported"] - reference["loss"]) <= 1e-5 * abs(reference["loss"])
        for pname, g in m["grads"].items():
            index = shardings[pname].index(want[pname].shape, r)
            block = want[pname][index].numpy()
            assert g.shape == block.shape == m["block_shapes"][pname], pname
            if pname.endswith("wk.bias"):
                scale = float(want[pname.replace("bias", "kernel")].abs().max())
                assert np.abs(g).max() <= 1e-5 * scale, (name, r, pname)
            else:
                _close(g, block, 1e-4, f"{name} rank {r} {pname}",
                       float(want[pname].abs().max()))
            key = (pname, tuple((s.start, s.stop) for s in index))
            if key in held:
                np.testing.assert_array_equal(g, held[key], err_msg=f"{name} {pname}")
            held[key] = g


def test_blocks_are_the_rule_tables_share(vit_run):
    """At dp=2 x fsdp=2 x tp=2 a rank holds exactly the rule table's share:
    the kernels a quarter (fsdp x tp), the head a quarter, the patch kernel,
    ``cls_token`` and ``pos_embed`` a half (fsdp), biases and LayerNorms
    whole."""
    reports, _ = vit_run
    shapes = tvit.param_shapes(_tiny())
    for m in reports["dp2_fsdp2_tp2"].values():
        for pname, shape in m["block_shapes"].items():
            share = int(np.prod(shape)) / int(np.prod(shapes[pname]))
            if pname.endswith("kernel") and pname != "patch_embed.kernel" or pname == "head":
                assert share == 0.25, pname
            elif pname in ("patch_embed.kernel", "cls_token", "pos_embed"):
                assert share == 0.5, pname
            else:
                assert share == 1.0, pname


def test_sequence_and_pipeline_axes_raise():
    """What still raises: ``pp > 1`` (no model of the reference pipelines,
    ROADMAP kept item 33), beside ``sp`` too, at the model and at the loss;
    a mesh without its groups, ``sp`` (trained in
    tests/test_torch_sp_models.py) and ``tp`` alike; an ``sp`` that leaves
    a rank no position."""
    cfg = _tiny()
    params = tvit.init_params(cfg, device="cpu")
    images, labels = torch.zeros(1, 32, 32, 3), torch.zeros(1, dtype=torch.long)
    for axes in ({"pp": 2, "fsdp": 1}, {"pp": 2, "sp": 2, "fsdp": 1}):
        mesh = make_mesh(devices=["cpu"] * int(np.prod(list(axes.values()))), **axes).bind(0)
        with pytest.raises(NotImplementedError, match="item 33"):
            tvit.ViT(cfg, mesh)
        with pytest.raises(NotImplementedError, match="item 33"):
            tvit.classification_loss(cfg, mesh, params, images, labels)
    for axes in ({"tp": 2, "fsdp": 1}, {"sp": 2, "fsdp": 1}, {"sp": 2, "tp": 2, "fsdp": 1}):
        mesh = make_mesh(devices=["cpu"] * int(np.prod(list(axes.values()))), **axes).bind(0)
        with pytest.raises(ValueError, match="form_groups"):
            tvit.ViT(cfg, mesh)
    tiny = tvit.ViTConfig.tiny(image_size=8)  # one patch and the cls token: 2 positions
    with pytest.raises(ValueError, match="without any"):
        tvit.ViT(tiny, make_mesh(devices=["cpu"] * 4, sp=4, fsdp=1).bind(0, {"sp": _Stand(4)}))


class _Stand:
    """A stand-in group for paths that reach no collective."""

    def __init__(self, world_size, rank=0):
        self.world_size, self.rank = world_size, rank
