"""The ViT and the MoE under sequence parallelism against the reference's,
on the CPU.

The reference's ViT and MoE take ``sp`` over its mesh: GSPMD partitions
the ViT's sequence (padding its odd 17 or 197 positions; its
``device_put`` refuses ``pos_embed`` there, so it runs on unplaced
parameters) and the MoE's Llama attention runs the ring. The port runs
one gang of eight spawned gloo ranks (``train.DataParallelTrainer``) in
rounds over the gang's ranks (every round's groups formed by every rank in
one order):

- the ViT (``ViTConfig.tiny``, f32, 2 layers, 4 heads of 16) at an odd
  length (17 tokens) and an even one (10 tokens, ``image_size=24``), each
  at ``dp2 x sp2 x tp2``, ``sp2`` and ``fsdp2 x sp2``, on a global batch
  of 8 images;
- the MoE (``MoEConfig.tiny(n_kv_heads=2)``, f32, GQA, 4 experts, k = 2)
  at ``capacity_factor=0.5`` (choices drop) on a global batch of 4 x 16
  tokens, at ``sp2 x ep2 x tp2`` (4 rows a data shard), ``fsdp2 x sp2 x
  ep2`` (2 rows) and ``sp2``: each sequence shard's tokens interleave with
  the other's in the global ``(b, s)`` order.

Each rank's logits, loss and gradient blocks (after
``model.fsdp.sync_gradients``) are held against the reference's
``jax.value_and_grad`` of ``classification_loss`` / ``next_token_loss``
jitted on its 8-device host mesh (``dp2 x sp2 x tp2`` and ``sp2 x ep2 x
tp2``; GSPMD gives one function on any mesh, so those numbers are every
sub-mesh's), on the reference's tree filled from a numpy seed. Tolerances,
relative to the largest |value| of the whole tensor, as the models' own
f32 tests: logits and the loss 1e-5, gradient blocks 1e-4 (the ViT's
``wk.bias``, whose true gradient is 0, 1e-5 of ``wk.kernel``'s). The
ranks that hold one block hold it bit for bit. The MoE's routing of each
layer (expert, slot and kept flag of every choice) equals the reference's
``top_k_gating`` dispatch of the global batch exactly.

``route`` alone, over stand-in groups of threads: without ``sp`` the same
bits as the per-rank offsets it took before sequence parallelism; with it,
the global batch's routing at several layouts.

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
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel.mesh import BATCH_AXES, make_mesh

_DEADLINE_S = 200.0
_RANKS = 8
_IMAGES = 8
_TOKENS = (4, 16)
_FACTOR = 0.5
_ODD, _EVEN = 32, 24  # image sizes: 17 and 10 tokens at patch 8
_ALL = list(range(8))
# rounds of (name, model, axes, the gang's ranks it spans, model keywords)
_ROUNDS = [
    [("vit17_dp2_sp2_tp2", "vit", {"dp": 2, "sp": 2, "tp": 2, "fsdp": 1}, _ALL,
      {"image_size": _ODD})],
    [("vit10_dp2_sp2_tp2", "vit", {"dp": 2, "sp": 2, "tp": 2, "fsdp": 1}, _ALL,
      {"image_size": _EVEN})],
    [("vit17_sp2", "vit", {"sp": 2, "fsdp": 1}, [0, 1], {"image_size": _ODD}),
     ("vit10_sp2", "vit", {"sp": 2, "fsdp": 1}, [2, 3], {"image_size": _EVEN}),
     ("vit17_fsdp2_sp2", "vit", {"fsdp": 2, "sp": 2}, [4, 5, 6, 7], {"image_size": _ODD})],
    [("vit10_fsdp2_sp2", "vit", {"fsdp": 2, "sp": 2}, [0, 1, 2, 3], {"image_size": _EVEN}),
     ("moe_sp2", "moe", {"sp": 2, "fsdp": 1}, [4, 5], {}),
     ("moe_fsdp2", "moe", {"fsdp": 2}, [6, 7], {})],
    [("moe_sp2_ep2_tp2", "moe", {"sp": 2, "ep": 2, "tp": 2, "fsdp": 1}, _ALL,
      {"remat": True})],
    [("moe_fsdp2_sp2_ep2", "moe", {"fsdp": 2, "sp": 2, "ep": 2}, _ALL, {})],
]
_MESHES = {name: (model, axes, ranks, kw) for rnd in _ROUNDS
           for name, model, axes, ranks, kw in rnd}


def _vit_cfg(**kw):
    return tvit.ViTConfig.tiny(dtype=torch.float32, **kw)


def _moe_cfg(**kw):
    return tmoe.MoEConfig.tiny(n_kv_heads=2, dtype=torch.float32, capacity_factor=_FACTOR, **kw)


def _images(size, seed=23):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((_IMAGES, size, size, 3)).astype(np.float32)
    return images, rng.integers(0, 10, (_IMAGES,)).astype(np.int32)


def _tokens(seed=29):
    return np.random.default_rng(seed).integers(0, 256, _TOKENS).astype(np.int64)


def _form(rnd):
    from ray_tpu_torch.train import collective as tcol

    own = None
    for name, model, axes, ranks, kw in rnd:
        if len(ranks) == _RANKS:
            mesh = tcol.gang_mesh("cpu", **axes)
        else:
            mesh = make_mesh(devices=["cpu"] * len(ranks), **axes).form_groups(
                "gloo", world_ranks=ranks, name=name)
        if mesh is not None:
            own = name, model, mesh, kw
    return own


def _vit_job(config, mesh, kw):
    from ray_tpu_torch.models.convert import vit_params_from_jax

    size = kw["image_size"]
    tcfg = _vit_cfg(**kw)
    model = tvit.build_vit(tcfg, vit_params_from_jax(config["vit"][size], tcfg, device="cpu"),
                           mesh)
    images, labels = (torch.from_numpy(a) for a in _images(size))
    n, shard = mesh.axes_size(BATCH_AXES), mesh.axes_index(BATCH_AXES)
    rows = slice(shard * _IMAGES // n, (shard + 1) * _IMAGES // n)
    with torch.no_grad():
        logits = model(images[rows])
    loss = tvit.classification_loss(tcfg, mesh, model, images[rows], labels[rows])
    loss.backward()
    full_pos = model.fsdp.full("pos_embed", model.pos_embed.detach())
    return model, dict(rows=rows, logits=logits.numpy(), loss=loss.item(),
                       positions=model.positions, full_pos=full_pos.numpy())


def _moe_job(config, mesh, kw):
    from ray_tpu_torch.models.convert import moe_params_from_jax

    tcfg = _moe_cfg(**kw)
    model = tmoe.build_moe(tcfg, moe_params_from_jax(config["moe"], tcfg, device="cpu"),
                           trainable=True, mesh=mesh)
    tokens = torch.from_numpy(_tokens())
    n, shard = mesh.axes_size(BATCH_AXES), mesh.axes_index(BATCH_AXES)
    rows = slice(shard * _TOKENS[0] // n, (shard + 1) * _TOKENS[0] // n)
    routings = []
    route = tmoe.route

    def recording(*args, **kwargs):
        out = route(*args, **kwargs)
        routings.append(out)
        return out

    tmoe.route = recording
    try:
        with torch.no_grad():
            logits, aux = model(tokens[rows])
        routings.clear()
        loss = tmoe.next_token_loss(tcfg, mesh, model, tokens[rows])
        routes = [(r.expert.numpy(), r.slot.numpy(), r.keep.numpy())
                  for r in routings[:tcfg.n_layers]]
        loss.backward()
    finally:
        tmoe.route = route
    s = _TOKENS[1] // mesh.shape["sp"]
    seq = slice(mesh.coords()["sp"] * s, (mesh.coords()["sp"] + 1) * s)
    return model, dict(rows=rows, seq=seq, logits=logits.numpy(), aux=aux.numpy(),
                       loss=loss.item(), routes=routes)


def _sp_loop(config):
    """Each round: form every mesh's groups (all ranks, one order), then on
    the rank's own mesh: logits, loss, the synced gradient blocks (and the
    MoE's routing of each layer)."""
    torch.set_num_threads(1)
    rank = train.get_context().world_rank
    for rnd in _ROUNDS:
        name, kind, mesh, kw = _form(rnd)
        model, out = (_vit_job if kind == "vit" else _moe_job)(config, mesh, kw)
        model.fsdp.sync_gradients(model.named_parameters())
        train.report({"rank": rank, "mesh": name, "mesh_rank": mesh.rank, **out,
                      "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
                      "block_shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}})


def _fill(tree, rng):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _fill(val, rng)
        elif key in ("scale",) or key.endswith("norm"):
            out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
        elif key == "bias":
            out[key] = (0.1 * rng.standard_normal(val.shape)).astype(np.float32)
        else:
            fan_in = int(np.prod(val.shape[:-1]))
            out[key] = (rng.standard_normal(val.shape) / np.sqrt(fan_in)).astype(np.float32)
    return out


def _reference_vit(size):
    """The reference's tree for the ViT at ``size``, its logits, loss and
    gradients jitted on ``dp2 x sp2 x tp2`` (on unplaced parameters: its
    ``device_put`` refuses ``pos_embed`` at 17 tokens), and its
    ``pos_embed`` shards where it places them (10 tokens)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import vit as jvit
    from ray_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ray_tpu.parallel.sharding import param_shardings as jax_param_shardings
    from ray_tpu.parallel.sharding import unbox_params

    jcfg = jvit.ViTConfig.tiny(dtype=jnp.float32, image_size=size)
    shapes = jax.eval_shape(lambda r: unbox_params(jvit.init_params(jcfg, r)),
                            jax.random.PRNGKey(0))
    params = _fill(shapes, np.random.default_rng(size))
    mesh = jax_make_mesh(num_devices=8, dp=2, sp=2, tp=2, fsdp=1)
    images, labels = (jnp.asarray(a) for a in _images(size))

    @jax.jit
    def run(p):
        logits = jvit.ViT(jcfg, mesh).apply({"params": p}, images)
        loss, grads = jax.value_and_grad(
            lambda q: jvit.classification_loss(jcfg, mesh, q, images, labels))(p)
        return logits, loss, grads

    logits, loss, grads = run(jax.tree_util.tree_map(jnp.asarray, params))
    shardings = jax_param_shardings(mesh, jvit.init_params(jcfg, jax.random.PRNGKey(0)))
    spec = tuple(shardings["pos_embed"].spec)
    try:
        placed = jax.device_put(jnp.asarray(params["pos_embed"]), shardings["pos_embed"])
        shards = [(sh.device.id, tuple((i.start, i.stop) for i in sh.index))
                  for sh in placed.addressable_shards]
    except ValueError:
        shards = None
    return dict(params=params, logits=np.asarray(logits), loss=float(loss),
                grads=jax.tree_util.tree_map(np.asarray, grads), pos_spec=spec,
                pos_shards=shards, mesh_devices=[d.id for d in mesh.devices.flat])


def _reference_moe():
    """The reference's MoE tree, logits, sown aux, loss, gradients and each
    layer's dispatch of the global batch (from its router input, rebuilt
    from the intermediates), jitted on ``sp2 x ep2 x tp2``."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe
    from ray_tpu.ops.rmsnorm import rmsnorm
    from ray_tpu.parallel.expert import expert_capacity, top_k_gating
    from ray_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ray_tpu.parallel.sharding import unbox_params

    jcfg = jmoe.MoEConfig.tiny(n_kv_heads=2, dtype=jnp.float32, capacity_factor=_FACTOR)
    shapes = jax.eval_shape(lambda r: unbox_params(jmoe.init_params(jcfg, r)),
                            jax.random.PRNGKey(0))
    params = _fill(shapes, np.random.default_rng(30))
    mesh = jax_make_mesh(num_devices=8, sp=2, ep=2, tp=2, fsdp=1)
    tokens = jnp.asarray(_tokens(), jnp.int32)

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
            router_logits = (ffn_in.reshape(b * s, -1).astype(jnp.float32)
                             @ layer["moe"]["router"].astype(jnp.float32))
            dispatch.append(top_k_gating(router_logits, capacity, jcfg.experts_per_token)[0])
            x = inter[f"layer_{i}"]["__call__"][0]
        aux = [state["losses"][f"layer_{i}"]["moe"]["router_aux"][0]
               for i in range(jcfg.n_layers)]
        return logits, jnp.stack(aux), loss, grads, jnp.stack(dispatch)

    logits, aux, loss, grads, dispatch = run(jax.tree_util.tree_map(jnp.asarray, params), tokens)
    return dict(params=params, logits=np.asarray(logits), aux=np.asarray(aux), loss=float(loss),
                grads=jax.tree_util.tree_map(np.asarray, grads), dispatch=np.asarray(dispatch))


@pytest.fixture(scope="module")
def sp_run():
    """The gang's reports by mesh and mesh rank, and the reference's
    numbers, computed before the gang starts (the gang needs the trees)."""
    reference = {"vit": {size: _reference_vit(size) for size in (_ODD, _EVEN)},
                 "moe": _reference_moe()}
    config = {"vit": {size: r["params"] for size, r in reference["vit"].items()},
              "moe": reference["moe"]["params"]}
    box = []
    with tempfile.TemporaryDirectory() as storage:
        trainer = train.DataParallelTrainer(
            _sp_loop, train_loop_config=config,
            scaling_config=train.ScalingConfig(_RANKS, {"CPU": 1}),
            run_config=train.RunConfig(name="sp-models", storage_path=storage),
            backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)))
        thread = threading.Thread(target=lambda: box.append(trainer.fit()), daemon=True)
        thread.start()
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
    for name, (_, _, ranks, _) in _MESHES.items():
        assert sorted(reports[name]) == list(range(len(ranks))), name
    return reports, reference


def _close(got, want, rel, what, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _shardings(name):
    from ray_tpu_torch.parallel.sharding import (
        moe_logical_axes, param_shardings, vit_logical_axes)

    kind, axes, ranks, kw = _MESHES[name]
    mesh = make_mesh(devices=["cpu"] * len(ranks), **axes)
    if kind == "vit":
        return param_shardings(mesh, tvit.param_shapes(_vit_cfg(**kw)), None, vit_logical_axes)
    return param_shardings(mesh, tmoe.param_shapes(_moe_cfg(**kw)), None, moe_logical_axes)


def _gradient_blocks(name, reports, want):
    """Each rank's gradient blocks against the reference's blocks (1e-4 of
    the largest |value|; the ViT's ``wk.bias``, whose true gradient is 0:
    softmax cancels it, 1e-5 of ``wk.kernel``'s), the blocks' shapes, and
    bit-identical blocks on the ranks that hold one."""
    shardings = _shardings(name)
    held = {}
    for r, m in reports[name].items():
        for pname, g in m["grads"].items():
            index = shardings[pname].index(want[pname].shape, r)
            block = want[pname][index].numpy()
            assert g.shape == block.shape == m["block_shapes"][pname], (name, pname)
            scale = float(want[pname].abs().max())
            if pname.endswith("wk.bias"):
                scale = 0.1 * float(want[pname.replace("bias", "kernel")].abs().max())
            _close(g, block, 1e-4, f"{name} rank {r} {pname}", scale)
            key = (pname, tuple((s.start, s.stop) for s in index))
            if key in held:
                np.testing.assert_array_equal(g, held[key], err_msg=f"{name} {pname}")
            held[key] = g


_VIT = [n for n, (k, *_) in _MESHES.items() if k == "vit"]
_MOE = [n for n, (k, *_) in _MESHES.items() if k == "moe"]


@pytest.mark.parametrize("name", _VIT)
def test_vit_logits_loss_and_gradients_match_the_reference(sp_run, name):
    """Every rank's logits are its data shard's rows of the reference's (the
    sp ranks of a shard bit for bit alike), its loss the global batch's
    mean over images (a shard counted once), its gradient blocks the
    reference's blocks, ``pos_embed``'s the rows of the rank's positions;
    ``FSDP.full`` gathers ``pos_embed`` whole from the padded blocks."""
    from ray_tpu_torch.models.convert import vit_params_from_jax

    reports, reference = sp_run
    size = _MESHES[name][3]["image_size"]
    ref = reference["vit"][size]
    want = vit_params_from_jax(ref["grads"], _vit_cfg(image_size=size), device="cpu")
    shards = {}
    for r, m in reports[name].items():
        _close(m["logits"], ref["logits"][m["rows"]], 1e-5, f"{name} rank {r} logits",
               np.abs(ref["logits"]).max())
        assert abs(m["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]), (name, m["loss"])
        np.testing.assert_array_equal(m["full_pos"], ref["params"]["pos_embed"])
        first = shards.setdefault(m["rows"].start, m)
        np.testing.assert_array_equal(m["logits"], first["logits"])
        assert m["loss"] == first["loss"]
    _gradient_blocks(name, reports, want)


@pytest.mark.parametrize("size", [_ODD, _EVEN])
def test_vit_positions_are_the_padded_layout(sp_run, size):
    """At 17 tokens a rank holds rows [9r, min(17, 9(r + 1))): 9 and 8; at
    10, 5 and 5, which are the reference's own ``pos_embed`` shards (its
    ``device_put`` places them there, and refuses at 17). The spec is the
    reference's, ``(None, 'sp', 'fsdp')``."""
    reports, reference = sp_run
    ref = reference["vit"][size]
    assert ref["pos_spec"] == (None, "sp", "fsdp")
    n = (size // 8) ** 2 + 1
    c = -(-n // 2)
    for name in _VIT:
        if _MESHES[name][3]["image_size"] != size:
            continue
        mesh = make_mesh(devices=["cpu"] * len(_MESHES[name][2]), **_MESHES[name][1])
        for r, m in reports[name].items():
            s = mesh.coords(r)["sp"]
            assert tuple(m["positions"]) == (s * c, min(n, (s + 1) * c) - s * c)
            assert m["block_shapes"]["pos_embed"][1] == m["positions"][1]
    if size == _ODD:
        assert ref["pos_shards"] is None  # the reference refuses the placement
    else:
        jmesh = make_mesh(devices=["cpu"] * 8, dp=2, sp=2, tp=2, fsdp=1)
        for device, index in ref["pos_shards"]:
            r = ref["mesh_devices"].index(device)
            s = jmesh.coords(r)["sp"]
            assert index[1] == (s * c, (s + 1) * c)


@pytest.mark.parametrize("name", _MOE)
def test_moe_logits_loss_and_gradients_match_the_reference(sp_run, name):
    """Every rank's logits are its rows and sequence shard of the
    reference's, its aux losses and loss the global batch's, its gradient
    blocks the reference's blocks."""
    from ray_tpu_torch.models.convert import moe_params_from_jax

    reports, reference = sp_run
    ref = reference["moe"]
    want = moe_params_from_jax(ref["grads"], _moe_cfg(), device="cpu")
    for r, m in reports[name].items():
        _close(m["logits"], ref["logits"][m["rows"], m["seq"]], 1e-5,
               f"{name} rank {r} logits", np.abs(ref["logits"]).max())
        np.testing.assert_allclose(m["aux"], ref["aux"], rtol=1e-5, atol=0)
        assert abs(m["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]), (name, m["loss"])
    _gradient_blocks(name, reports, want)


@pytest.mark.parametrize("name", _MOE)
def test_moe_routing_is_the_global_batchs(sp_run, name):
    """Each layer's routing of a rank's tokens (its rows at its positions)
    is the reference's dispatch of those tokens within the global batch,
    exactly, and choices drop (more than a tenth of them) and interleave."""
    reports, reference = sp_run
    want = reference["moe"]["dispatch"]  # (layers, T, E, C), T in (b, s) order
    b, s = _TOKENS
    dropped = total = 0
    for r, m in reports[name].items():
        idx = (np.arange(b)[m["rows"], None] * s + np.arange(s)[None, m["seq"]]).reshape(-1)
        for i, (expert, slot, keep) in enumerate(m["routes"]):
            got = np.zeros((expert.shape[0],) + want.shape[2:], np.float32)
            tok = np.nonzero(keep)[0]
            got[tok, expert[keep], slot[keep]] = 1.0
            np.testing.assert_array_equal(got, want[i, idx], err_msg=f"{name} rank {r} layer {i}")
            dropped += int((~keep).sum())
            total += keep.size
    assert dropped > 0.1 * total


# -- route over stand-in groups of threads ---------------------------------------


class _ThreadGroup:
    """``world_size`` threads as one group: ``allgather_cat`` and
    ``allreduce_`` meet at a barrier (for ``route`` alone)."""

    def __init__(self, world_size):
        self.world_size = world_size
        self._barrier = threading.Barrier(world_size)
        self._box = [None] * world_size

    def member(self, rank):
        group = self

        class Member:
            world_size = group.world_size

            def __init__(self):
                self.rank = rank

            def _meet(self, x):
                group._box[rank] = x
                group._barrier.wait()
                parts = list(group._box)
                group._barrier.wait()
                return parts

            def allgather_cat(self, x, dim=-1):
                return torch.cat(self._meet(x.clone()), dim=dim)

            def allreduce_(self, x):
                parts = self._meet(x.clone())
                out = parts[0].clone()
                for p in parts[1:]:
                    out += p
                return x.copy_(out)

        return Member()


def _run_members(n, fn):
    group, out, errors = _ThreadGroup(n), [None] * n, []

    def run(r):
        try:
            out[r] = fn(group.member(r), r)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
            group._barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return out


def _per_rank_route(logits, capacity, k, group):
    """``route(group=)`` as it stood before sequence parallelism: per-rank
    counts, each rank's tokens one block after the earlier ranks'."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    masked, ids, passes = probs, torch.arange(e)[:, None], []
    for _ in range(k):
        idx = masked.argmax(dim=-1)
        gate = masked.gather(-1, idx[:, None])[:, 0]
        chosen = idx[None, :] == ids
        masked = masked.masked_fill(chosen.t(), 0.0)
        passes.append((idx, gate, chosen))
    totals = torch.stack([chosen.sum(dim=1) for _, _, chosen in passes])
    every = group.allgather_cat(totals[None], dim=0)
    n, offsets, totals = every.shape[0], every[:group.rank].sum(dim=0), every.sum(dim=0)
    filled = torch.zeros(e, dtype=torch.long)
    slots, keeps, gates = [], [], []
    for i, (idx, gate, chosen) in enumerate(passes):
        slot = chosen.cumsum(dim=1).gather(0, idx[None, :])[0] - 1 + filled[idx]
        slot = slot + offsets[i][idx]
        keep = slot < capacity
        filled = filled + torch.minimum((capacity - filled).clamp_min(0), totals[i])
        slots.append(slot)
        keeps.append(keep)
        gates.append(gate * keep)
    kept = torch.stack(gates, dim=1)
    weight = kept / kept.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    share = e * torch.sum(filled.float() / (t * n) * (probs.sum(dim=0) / (t * n)))
    return (torch.stack([p[0] for p in passes], 1), torch.stack(slots, 1),
            torch.stack(keeps, 1), weight, group.allreduce_(share.reshape(1))[0])


def test_route_without_sp_is_the_same_bits_as_before():
    """Four data shards' routing at a dropping capacity: expert, slot, kept
    flag, weight and aux loss equal, bit for bit, the per-rank offsets of
    ``route`` before sequence parallelism."""
    from ray_tpu_torch.parallel.expert import route

    logits = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 24, 6))
                              .astype(np.float32))

    def both(group, r):
        got = route(logits[r], 5, k=2, group=group)
        return (got.expert, got.slot, got.keep, got.weight, got.aux_loss), \
            _per_rank_route(logits[r], 5, 2, group)

    for got, want in _run_members(4, both):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shards,sp,rows", [(1, 2, 3), (2, 2, 2), (2, 3, 1), (1, 4, 2)])
def test_route_under_sp_is_the_global_batchs(shards, sp, rows):
    """Ranks of ``shards`` data shards x ``sp`` sequence shards, ``rows``
    rows each: every rank's routing of its tokens (expert, slot, kept
    flag, weight) is the one-rank routing of the global (b, s) batch's
    tokens, exactly, and its aux loss the global one within f32 rounding
    (1e-6 relative; the sums run in another order); choices drop."""
    from ray_tpu_torch.parallel.expert import route

    b, s, e, cap = shards * rows, 6 * sp, 4, 7
    logits = torch.from_numpy(np.random.default_rng(shards * 10 + sp)
                              .standard_normal((b, s, e)).astype(np.float32))
    whole = route(logits.reshape(-1, e), cap, k=2)
    local = s // sp

    def mine(group, r):
        shard, q = divmod(r, sp)
        block = logits[shard * rows:(shard + 1) * rows, q * local:(q + 1) * local]
        return route(block.reshape(-1, e), cap, k=2, group=group, seq_shards=sp, rows=rows)

    outs = _run_members(shards * sp, mine)
    index = torch.arange(b * s).view(b, s)
    for r, got in enumerate(outs):
        shard, q = divmod(r, sp)
        idx = index[shard * rows:(shard + 1) * rows, q * local:(q + 1) * local].reshape(-1)
        for field in ("expert", "slot", "keep", "weight"):
            assert torch.equal(getattr(got, field), getattr(whole, field)[idx]), (r, field)
        assert abs(got.aux_loss.item() - whole.aux_loss.item()) <= 1e-6 * whole.aux_loss.item()
    assert not bool(whole.keep.all())


def test_padded_layout_checkpoints_and_restores_onto_other_meshes(tmp_path):
    """The ViT's parameters at ``fsdp2 x sp2`` and 17 tokens (``pos_embed``
    split 9 / 8 over sp), each rank's blocks saved in turn in one process
    (the port's format, ROADMAP kept item 30), restore bit for bit whole, at
    ``sp=3`` (6 / 6 / 5 rows) and at one rank; a block of a dimension other
    than sp's that does not divide still raises."""
    from ray_tpu_torch.parallel.sharding import P, param_shardings, vit_logical_axes
    from ray_tpu_torch.train import restore_sharded, save_sharded

    cfg = _vit_cfg(image_size=_ODD)
    params = tvit.init_params(cfg, device="cpu")
    params["pos_embed"].copy_(torch.arange(params["pos_embed"].numel()).view_as(
        params["pos_embed"]))
    shapes = tvit.param_shapes(cfg)
    mesh = make_mesh(devices=["cpu"] * 4, fsdp=2, sp=2)
    path = str(tmp_path / "ckpt")
    rows = []
    for r in range(4):
        shardings = param_shardings(mesh.bind(r), shapes, None, vit_logical_axes)
        blocks = {k: shardings[k].shard(v) for k, v in params.items()}
        rows.append(blocks["pos_embed"].shape[1])
        save_sharded(path, blocks, shardings)
    assert rows == [9, 8, 9, 8]
    whole = restore_sharded(path)
    for k, v in params.items():
        assert torch.equal(whole[k], v), k
    other = make_mesh(devices=["cpu"] * 3, sp=3, fsdp=1)
    got = []
    for r in range(3):
        shardings = param_shardings(other.bind(r), shapes, None, vit_logical_axes)
        block = restore_sharded(path, shardings=shardings)["pos_embed"]
        assert torch.equal(block, shardings["pos_embed"].shard(params["pos_embed"]))
        got.append(block.shape[1])
    assert got == [6, 6, 5]
    with pytest.raises(ValueError, match="divisible by 2"):
        param_shardings(mesh, {"w": torch.Size([17, 4])}, None, {"w": ("embed", None)})[
            "w"].index((17, 4))
    assert param_shardings(mesh, {"w": torch.Size([4, 17])}, None, {"w": (None, "seq")})[
        "w"].spec == P(None, "sp")
