"""The MoE transformer over a mesh of the port against the reference's, on
the CPU.

The reference holds its MoE's sharded loss at ``fsdp=2 x ep=2 x tp=2``
against one device (tests/test_parallel_ext.py): one GSPMD program whose
routing is the global batch's (``ray_tpu/parallel/expert.py:34-88``). The
port runs one gang of eight spawned gloo ranks (``train.DataParallelTrainer``)
in two rounds: the target mesh on all eight (with remat: every block and
its gathers run again in the backward, and its routing with them); then
``ep=2``, ``tp=2``, ``fsdp=2`` and ``fsdp=2`` again at a capacity factor of
0.5, on two ranks each. At that factor the experts overflow (more than a
tenth of the choices drop), so a routing local to each rank's tokens (its
own capacity, or its own slots) gives other drops and other numbers: the
mutation was run, and fails ``test_routing_is_the_global_batchs`` and
``test_logits_loss_and_gradients_match_the_reference`` (CHANGES.md).

``MoEConfig.tiny(n_kv_heads=2)`` in f32 (GQA: 4 query heads over 2 KV
heads, 4 experts, k = 2) with the reference's tree filled from a numpy seed,
a global batch of 4 x 16 tokens. Each rank reports its logits, the aux
losses, its loss, its gradient blocks (after ``model.fsdp.sync_gradients``)
and each layer's routing of its tokens (expert, slot, kept), held against
the reference's ``jax.value_and_grad`` of ``next_token_loss(config, mesh,
...)`` jitted on the target mesh (``MoETransformer(config, mesh)``: ring
attention under ``shard_map`` at sp = 1) and the reference's
``top_k_gating`` of each layer's router input taken from its
intermediates; GSPMD gives one function on any mesh, so its numbers on the
target mesh are the sub-meshes' too. Tolerances, as
tests/test_torch_moe.py's f32 ones, relative to the largest |value| of the
whole tensor: logits 1e-5, aux losses and the loss 1e-5 relative, gradients
1e-4; the routing exactly. The ranks that hold one block hold one
gradient, bit for bit.

The workers import this module by name, so it imports neither ``jax`` nor
``ray_tpu`` at its top.
"""

import dataclasses
import multiprocessing
import tempfile
import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch import train
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.parallel.mesh import BATCH_AXES, make_mesh

_DEADLINE_S = 150.0
_RANKS = 8
_TOKENS = (4, 16)
_OVERFLOW = 0.5
_ROUNDS = [
    [("fsdp2_ep2_tp2", {"fsdp": 2, "ep": 2, "tp": 2}, list(range(8)), {"remat": True})],
    [("ep2", {"ep": 2, "fsdp": 1}, [0, 1], {}), ("tp2", {"tp": 2, "fsdp": 1}, [2, 3], {}),
     ("fsdp2", {"fsdp": 2}, [4, 5], {}),
     ("fsdp2_overflow", {"fsdp": 2}, [6, 7], {"capacity_factor": _OVERFLOW})],
]
_MESHES = {name: (axes, ranks, kw) for rnd in _ROUNDS for name, axes, ranks, kw in rnd}


def _tiny(**kw):
    return tmoe.MoEConfig.tiny(n_kv_heads=2, dtype=torch.float32, **kw)


def _tokens(seed=31):
    return np.random.default_rng(seed).integers(0, 256, _TOKENS).astype(np.int64)


def _moe_loop(config):
    """Each round: form every mesh's groups (all ranks, one order), then on
    the rank's own mesh: logits, aux, loss, the routing it recorded, the
    synced gradients."""
    from ray_tpu_torch.models.convert import moe_params_from_jax
    from ray_tpu_torch.train import collective as tcol

    torch.set_num_threads(1)
    rank = train.get_context().world_rank
    tokens = torch.from_numpy(_tokens())
    routings = []
    route = tmoe.route

    def recording(*args, **kwargs):
        out = route(*args, **kwargs)
        routings.append(out)
        return out

    tmoe.route = recording
    for rnd in _ROUNDS:
        own = None
        for name, axes, ranks, kw in rnd:
            if len(ranks) == _RANKS:
                mesh = tcol.gang_mesh("cpu", **axes)
            else:
                mesh = make_mesh(devices=["cpu"] * len(ranks), **axes).form_groups(
                    "gloo", world_ranks=ranks, name=name)
            if mesh is not None:
                own = name, mesh, kw
        name, mesh, kw = own
        tcfg = _tiny(**kw)
        params = moe_params_from_jax(config["params"], tcfg, device="cpu")
        model = tmoe.build_moe(tcfg, params, trainable=True, mesh=mesh)
        n = mesh.axes_size(BATCH_AXES)
        shard = mesh.axes_index(BATCH_AXES)
        rows = slice(shard * _TOKENS[0] // n, (shard + 1) * _TOKENS[0] // n)
        with torch.no_grad():
            logits, aux = model(tokens[rows])
        routings.clear()
        loss = tmoe.next_token_loss(tcfg, mesh, model, tokens[rows])
        forward_routes = [(r.expert.numpy(), r.slot.numpy(), r.keep.numpy())
                          for r in routings[:tcfg.n_layers]]
        loss.backward()
        # the backward recomputes the blocks last layer first
        recomputed = [(r.expert.numpy(), r.slot.numpy(), r.keep.numpy())
                      for r in reversed(routings[tcfg.n_layers:])]
        model.fsdp.sync_gradients(model.named_parameters())
        train.report({"rank": rank, "mesh": name, "mesh_rank": mesh.rank, "rows": rows,
                      "logits": logits.numpy(), "aux": aux.numpy(), "loss": loss.item(),
                      "routes": forward_routes, "recomputed": recomputed,
                      "grads": {n_: p.grad.numpy().copy() for n_, p in model.named_parameters()},
                      "block_shapes": {n_: tuple(p.shape) for n_, p in model.named_parameters()}})


def _reference_tree(jcfg):
    import jax

    from ray_tpu.models import moe as jmoe
    from ray_tpu.parallel.sharding import unbox_params

    shapes = jax.eval_shape(lambda r: unbox_params(jmoe.init_params(jcfg, r)),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(30)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key.endswith("norm"):
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            else:
                fan_in = int(np.prod(val.shape[:-1]))
                out[key] = (rng.standard_normal(val.shape) / np.sqrt(fan_in)).astype(np.float32)
        return out

    return fill(shapes)


def _reference_run(jcfg, mesh, shardings, params, tokens):
    """The reference's logits, sown aux, loss, gradients and each layer's
    dispatch (from its router input, rebuilt from the intermediates as
    ``MoEBlock`` computes it) on the mesh."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe
    from ray_tpu.ops.rmsnorm import rmsnorm
    from ray_tpu.parallel.expert import expert_capacity, top_k_gating

    placed = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params), shardings)

    @jax.jit
    def run(p, t):
        logits, state = jmoe.MoETransformer(jcfg, mesh).apply(
            {"params": p}, t, capture_intermediates=True, mutable=["intermediates", "losses"])
        loss, grads = jax.value_and_grad(lambda q: jmoe.next_token_loss(jcfg, mesh, q, t))(p)
        inter = state["intermediates"]
        x = p["embed"].astype(jcfg.dtype)[t]
        b, s = t.shape
        capacity = expert_capacity(b * s, jcfg.n_experts, jcfg.capacity_factor,
                                   jcfg.experts_per_token)
        dispatch = []
        for i in range(jcfg.n_layers):
            layer = p[f"layer_{i}"]
            h = x + inter[f"layer_{i}"]["attn"]["__call__"][0]
            ffn_in = rmsnorm(h, layer["ffn_norm"].astype(h.dtype), jcfg.norm_eps)
            tok = ffn_in.reshape(b * s, -1)
            router_logits = tok.astype(jnp.float32) @ layer["moe"]["router"].astype(jnp.float32)
            dispatch.append(top_k_gating(router_logits, capacity, jcfg.experts_per_token)[0])
            x = inter[f"layer_{i}"]["__call__"][0]
        aux = [state["losses"][f"layer_{i}"]["moe"]["router_aux"][0]
               for i in range(jcfg.n_layers)]
        return logits, jnp.stack(aux), loss, grads, jnp.stack(dispatch)

    logits, aux, loss, grads, dispatch = run(placed, jnp.asarray(tokens, jnp.int32))
    return dict(logits=np.asarray(logits), aux=np.asarray(aux), loss=float(loss),
                grads=jax.tree_util.tree_map(np.asarray, grads), dispatch=np.asarray(dispatch))


@pytest.fixture(scope="module")
def moe_run():
    """The gang's reports, and the reference's numbers on the target mesh at
    both capacity factors, computed while the gang runs."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe
    from ray_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ray_tpu.parallel.sharding import param_shardings as jax_param_shardings
    from ray_tpu_torch.models.convert import _flatten

    jcfg = jmoe.MoEConfig.tiny(n_kv_heads=2, dtype=jnp.float32)
    params = _reference_tree(jcfg)
    box = []
    with tempfile.TemporaryDirectory() as storage:
        trainer = train.DataParallelTrainer(
            _moe_loop, train_loop_config={"params": params},
            scaling_config=train.ScalingConfig(_RANKS, {"CPU": 1}),
            run_config=train.RunConfig(name="moe-mesh", storage_path=storage),
            backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)))
        thread = threading.Thread(target=lambda: box.append(trainer.fit()), daemon=True)
        thread.start()

        mesh = jax_make_mesh(8, fsdp=2, ep=2, tp=2)
        shardings = jax_param_shardings(mesh, jmoe.init_params(jcfg, jax.random.PRNGKey(0)))
        reference = {factor: _reference_run(dataclasses.replace(jcfg, capacity_factor=factor),
                                            mesh, shardings, params, _tokens())
                     for factor in (jcfg.capacity_factor, _OVERFLOW)}
        specs = {k: tuple(v.spec) for k, v in _flatten(shardings).items()}
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
    for name, (axes, ranks, _) in _MESHES.items():
        assert sorted(reports[name]) == list(range(len(ranks))), name
    return reports, reference, specs


def _close(got, want, rel, what, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _layout(name):
    from ray_tpu_torch.parallel.sharding import moe_logical_axes, param_shardings

    axes, ranks, kw = _MESHES[name]
    mesh = make_mesh(devices=["cpu"] * len(ranks), **axes)
    return mesh, param_shardings(mesh, tmoe.param_shapes(_tiny(**kw)), None, moe_logical_axes)


def _factor(name):
    return _MESHES[name][2].get("capacity_factor", _tiny().capacity_factor)


def test_parameter_specs_are_the_references(moe_run):
    """Every parameter's spec on the target mesh is the reference's
    ``param_shardings``'."""
    _, _, specs = moe_run
    _, shardings = _layout("fsdp2_ep2_tp2")
    assert sorted(shardings) == sorted(specs)
    for name, sharding in shardings.items():
        got, want = tuple(sharding.spec), specs[name]
        n = max(len(got), len(want))
        assert got + (None,) * (n - len(got)) == want + (None,) * (n - len(want)), name


@pytest.mark.parametrize("name", list(_MESHES))
def test_routing_is_the_global_batchs(moe_run, name):
    """Each layer's routing of a rank's tokens (expert and slot of every kept
    choice) is the reference's dispatch of those tokens within the global
    batch, exactly; the remat recompute routes as the forward; and at the
    overflow factor choices drop (the case that local routing fails)."""
    reports, reference, _ = moe_run
    want = reference[_factor(name)]["dispatch"]  # (layers, T, E, C)
    t = _TOKENS[1]
    dropped = 0
    for r, m in reports[name].items():
        rows = m["rows"]
        for i, (expert, slot, keep) in enumerate(m["routes"]):
            got = np.zeros((expert.shape[0],) + want.shape[2:], np.float32)
            tok = np.nonzero(keep)[0]
            got[tok, expert[keep], slot[keep]] = 1.0
            np.testing.assert_array_equal(got, want[i, rows.start * t:rows.stop * t],
                                          err_msg=f"{name} rank {r} layer {i}")
            dropped += int((~keep).sum())
        for fwd, again in zip(m["routes"], m["recomputed"]):
            for a, b in zip(fwd, again):
                np.testing.assert_array_equal(a, b)
        if name == "fsdp2_ep2_tp2":
            assert len(m["recomputed"]) == len(m["routes"])  # remat recomputed each layer
    if name == "fsdp2_overflow":
        assert dropped > 0.1 * sum(k.size for m in reports[name].values()
                                   for _, _, k in m["routes"])


@pytest.mark.parametrize("name", list(_MESHES))
def test_logits_loss_and_gradients_match_the_reference(moe_run, name):
    """Each rank's logits are its rows of the reference's, its aux losses and
    loss the global batch's, and its gradient blocks the reference's
    gradients' blocks; the ranks holding one block hold one gradient, bit for
    bit (a parameter replicated over ``tp`` or ``ep`` is not reduced over
    it)."""
    from ray_tpu_torch.models.convert import moe_params_from_jax

    reports, reference, _ = moe_run
    ref = reference[_factor(name)]
    tcfg = _tiny(**_MESHES[name][2])
    want = moe_params_from_jax(ref["grads"], tcfg, device="cpu")
    _, shardings = _layout(name)
    held = {}
    for r, m in reports[name].items():
        _close(m["logits"], ref["logits"][m["rows"]], 1e-5, f"{name} rank {r} logits",
               np.abs(ref["logits"]).max())
        np.testing.assert_allclose(m["aux"], ref["aux"], rtol=1e-5, atol=0)
        assert abs(m["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        for pname, g in m["grads"].items():
            index = shardings[pname].index(want[pname].shape, r)
            block = want[pname][index].numpy()
            assert g.shape == block.shape == m["block_shapes"][pname], pname
            _close(g, block, 1e-4, f"{name} rank {r} {pname}", float(want[pname].abs().max()))
            key = (pname, tuple((s.start, s.stop) for s in index))
            if key in held:
                np.testing.assert_array_equal(g, held[key], err_msg=f"{name} {pname}")
            held[key] = g


def test_blocks_are_the_rule_tables_share(moe_run):
    """At fsdp=2 x ep=2 x tp=2 a rank holds exactly the rule table's share:
    the experts an eighth, the attention kernels, ``embed`` and ``lm_head`` a
    quarter (fsdp x tp), the router a quarter (fsdp x ep), the norms a half
    (fsdp)."""
    reports, _, _ = moe_run
    shapes = tmoe.param_shapes(_tiny())
    for m in reports["fsdp2_ep2_tp2"].values():
        for pname, shape in m["block_shapes"].items():
            share = int(np.prod(shape)) / int(np.prod(shapes[pname]))
            if pname.endswith(("w_gate", "w_up", "w_down")):
                assert share == 0.125, pname
            elif pname.endswith("norm"):
                assert share == 0.5, pname
            else:
                assert share == 0.25, pname


def test_sequence_and_pipeline_axes_raise():
    """What still raises: ``pp > 1`` (no model of the reference pipelines,
    ROADMAP kept item 33), beside ``sp`` too, at the model and at the loss;
    a mesh without its groups (``sp``, trained in
    tests/test_torch_sp_models.py, and ``ep`` alike); a sequence that
    ``sp`` does not divide, before any collective."""
    cfg = _tiny()
    tokens = torch.zeros(1, 8, dtype=torch.long)
    for axes in ({"pp": 2, "fsdp": 1}, {"pp": 2, "sp": 2, "ep": 2, "fsdp": 1}):
        mesh = make_mesh(devices=["cpu"] * int(np.prod(list(axes.values()))), **axes).bind(0)
        with pytest.raises(NotImplementedError, match="item 33"):
            tmoe.MoETransformer(cfg, mesh)
        with pytest.raises(NotImplementedError, match="item 33"):
            tmoe.next_token_loss(cfg, mesh, {}, tokens)
    for axes in ({"ep": 2, "fsdp": 1}, {"sp": 2, "fsdp": 1}, {"sp": 2, "ep": 2, "fsdp": 1}):
        mesh = make_mesh(devices=["cpu"] * int(np.prod(list(axes.values()))), **axes).bind(0)
        with pytest.raises(ValueError, match="form_groups"):
            tmoe.MoETransformer(cfg, mesh)

    class _Stand:  # the sp group of a path that reaches no collective
        world_size, rank = 2, 0

    mesh = make_mesh(devices=["cpu"] * 2, sp=2, fsdp=1).bind(0, {"sp": _Stand()})
    model = tmoe.build_moe(cfg, tmoe.init_params(cfg, device="cpu"), mesh=mesh)
    with torch.no_grad(), pytest.raises(ValueError, match="divide over sp=2"):
        model(torch.zeros(1, 15, dtype=torch.long))
