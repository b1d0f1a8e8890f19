"""The gang's sub-groups and the Megatron pair of the port, on the CPU.

One gang of eight spawned gloo ranks (``train.DataParallelTrainer``, about
20 s) forms, through ``train.collective.gang_mesh`` and
``Mesh.form_groups``, the sub-groups of the reference tests' meshes
(``dp=2 x fsdp=2 x tp=2``, ``fsdp=2 x ep=2 x tp=2``) and of two others
(``dcn=2 x dp=2 x fsdp=2``, where every combination of ``GROUP_COMBOS``
has a group of its own, and ``fsdp=2 x tp=2`` over ranks 4-7 of the
gang), and reports each group's members and rank. Held against the mesh's
coordinates computed here: a rank's group along some axes is the ranks
that differ from it along those axes alone, in rank order, and its rank in
it is its row-major index over them.

On the gang's ``tp`` lines of two ranks: ``copy_to_group`` and
``gather_from_group`` against the analytic gradients of a loss every rank
computes alike (``L = sum(c * gather(x))``, ``L = sum(c * copy(x))``
with a rank's own weights), and ``all_gather_cat``'s reduce-scatter
backward under such a replicated loss: twice the gradient, the reason the
slice backward exists. In process: ``constrain``'s contract on a rank's
block, and the FSDP layout of a block split over ``fsdp`` and ``tp``.

The workers import this module by name, so it imports neither ``jax`` nor
``ray_tpu`` at its top.
"""

import multiprocessing
import tempfile

import numpy as np
import pytest
import torch

from ray_tpu_torch import train
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, BATCH_AXES, GROUP_COMBOS, make_mesh

_DEADLINE_S = 120.0
_RANKS = 8
# name -> (axes, the gang's ranks it spans)
_MESHES = {
    "dp2_fsdp2_tp2": ({"dp": 2, "fsdp": 2, "tp": 2}, list(range(8))),
    "fsdp2_ep2_tp2": ({"fsdp": 2, "ep": 2, "tp": 2}, list(range(8))),
    "dcn2_dp2_fsdp2": ({"dcn": 2, "dp": 2, "fsdp": 2}, list(range(8))),
    "fsdp2_tp2_upper": ({"fsdp": 2, "tp": 2}, [4, 5, 6, 7]),
}


def _group_report(group):
    import torch.distributed as dist

    return {"members": dist.get_process_group_ranks(group.process_group), "rank": group.rank,
            "world_size": group.world_size}


def _functional(mesh):
    """The pair and the gathers on the rank's tp group of two: each rank's
    x and c from its own seed; returns the gradients."""
    from ray_tpu_torch.collective.functional import (
        all_gather_cat, copy_to_group, gather_from_group)

    group = mesh.group("tp")
    g = torch.Generator().manual_seed(100 + mesh.rank)
    x = torch.randn(3, 4, generator=g, dtype=torch.float64)
    c_same = torch.arange(24, dtype=torch.float64).reshape(3, 8) / 7.0  # alike on every rank
    c_own = torch.randn(3, 4, generator=g, dtype=torch.float64)
    out = {"x": x.numpy(), "c_own": c_own.numpy()}
    for name, fn in (("gather", gather_from_group), ("cat", all_gather_cat)):
        leaf = x.clone().requires_grad_(True)
        (c_same * fn(leaf, group, 1)).sum().backward()
        out[name] = leaf.grad.numpy()
    leaf = x.clone().requires_grad_(True)
    (c_own * copy_to_group(leaf, group)).sum().backward()
    out["copy"] = leaf.grad.numpy()
    return out


def _groups_loop(config):
    torch.set_num_threads(1)
    from ray_tpu_torch.train import collective as tcol

    rank = train.get_context().world_rank
    gang = tcol.gang_mesh("cpu", **_MESHES["dp2_fsdp2_tp2"][0])
    reports = {}
    for name, (axes, ranks) in _MESHES.items():
        if name == "dp2_fsdp2_tp2":
            mesh = gang
        else:
            mesh = make_mesh(devices=["cpu"] * len(ranks), **axes).form_groups(
                "gloo", world_ranks=ranks, name=name)
        if mesh is None:
            assert rank not in ranks
            continue
        groups = {}
        for key in [a for a in AXIS_ORDER] + list(GROUP_COMBOS):
            group = mesh.group(key)
            if group is not None:
                groups[key if isinstance(key, str) else ",".join(key)] = _group_report(group)
        reports[name] = {"mesh_rank": mesh.rank, "groups": groups}
    functional = _functional(gang)
    whole = tcol.gang_mesh("cpu", fsdp=_RANKS)
    train.report({"rank": rank, "meshes": reports, "functional": functional,
                  "data_group_is_new": gang.group(BATCH_AXES) is not tcol.tensor_group(),
                  "whole_line_is_tensor_group": whole.group("fsdp") is tcol.tensor_group()})


@pytest.fixture(scope="module")
def gang():
    with tempfile.TemporaryDirectory() as storage:
        result = train.DataParallelTrainer(
            _groups_loop, train_loop_config={},
            scaling_config=train.ScalingConfig(_RANKS, {"CPU": 1}),
            run_config=train.RunConfig(name="mesh-groups", storage_path=storage),
            backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S))).fit()
    assert not multiprocessing.active_children()
    assert result.error is None, result.error
    reports = {m["rank"]: m for m in result.metrics_history}
    assert sorted(reports) == list(range(_RANKS))
    return reports


def _expected(axes, ranks, key_axes):
    """{gang rank: (members in gang ranks, rank)} of the group along
    ``key_axes``, from the mesh's coordinates."""
    mesh = make_mesh(devices=["cpu"] * len(ranks), **axes)
    out = {}
    for r in range(mesh.size):
        c = mesh.coords(r)
        same = [q for q in range(mesh.size)
                if all(mesh.coords(q)[a] == c[a] for a in AXIS_ORDER if a not in key_axes)]
        index = 0
        for a in AXIS_ORDER:
            if a in key_axes:
                index = index * mesh.shape[a] + c[a]
        out[ranks[r]] = ([ranks[q] for q in same], index)
    return out


@pytest.mark.parametrize("name", list(_MESHES))
def test_each_group_is_its_line_of_the_mesh(gang, name):
    """Every axis past 1 and each combination with two or more axes past 1
    has a group on every rank of the mesh, whose members are the ranks that
    differ along those axes alone and whose rank is the rank's coordinate
    along them (row-major); a combination with one axis past 1 is that
    axis's group; ranks outside the mesh get none."""
    axes, ranks = _MESHES[name]
    shape = make_mesh(devices=["cpu"] * len(ranks), **axes).shape
    keys = [(a, (a,)) for a in AXIS_ORDER if shape[a] > 1]
    for combo in GROUP_COMBOS:
        live = tuple(a for a in combo if shape[a] > 1)
        if len(live) > 1:
            keys.append((",".join(combo), live))
    for r in range(_RANKS):
        if r not in ranks:
            assert name not in gang[r]["meshes"]
            continue
        got = gang[r]["meshes"][name]
        assert got["mesh_rank"] == ranks.index(r)
        for label, key in keys:
            members, index = _expected(axes, ranks, key)[r]
            report = got["groups"][label]
            assert report["members"] == members, (name, r, key)
            assert report["rank"] == index and report["world_size"] == len(members)
        for combo in GROUP_COMBOS:
            live = [a for a in combo if shape[a] > 1]
            label = ",".join(combo)
            if len(live) == 1:
                assert got["groups"][label] == got["groups"][live[0]]
            elif not live:
                assert label not in got["groups"]


def test_a_line_of_the_whole_gang_is_the_tensor_group(gang):
    """At dp=2 x fsdp=2 x tp=2 no line is the whole gang, so every group is
    a new one; at fsdp=8 the line is the whole gang, and ``gang_mesh`` hands
    out the run's tensor group for it (no new process group)."""
    assert all(m["data_group_is_new"] for m in gang.values())
    assert all(m["whole_line_is_tensor_group"] for m in gang.values())


def test_copy_and_gather_gradients_are_megatrons(gang):
    """On each tp pair (ranks 2j, 2j + 1), in f64: ``gather_from_group``'s
    gradient of ``sum(c * gather(x))``, c alike on both ranks, is the rank's
    slice of c; ``all_gather_cat``'s is twice that (the ranks' equal
    cotangents summed by its reduce-scatter: right for an FSDP shard, twice
    the gradient here); ``copy_to_group``'s of ``sum(c_r * x)``, c_r each
    rank's own, is the sum of both ranks' c (exactly: two f64 terms)."""
    c_same = np.arange(24, dtype=np.float64).reshape(3, 8) / 7.0
    for j in range(_RANKS // 2):
        pair = [gang[2 * j]["functional"], gang[2 * j + 1]["functional"]]
        for t, f in enumerate(pair):
            own = c_same[:, 4 * t:4 * t + 4]
            np.testing.assert_array_equal(f["gather"], own)
            np.testing.assert_array_equal(f["cat"], 2 * own)
            np.testing.assert_array_equal(f["copy"], pair[0]["c_own"] + pair[1]["c_own"])


def test_constrain_contract():
    """``constrain`` on a rank's block (its batch shard, replicated along
    every other axis): the identity on the first dimension when the spec's
    data axes are the mesh's; the rank's slice along an axis that is not a
    data axis; an error for a batch split otherwise, data axes off the first
    dimension, data and other axes on one dimension, or a dimension the
    axes do not divide."""
    from ray_tpu_torch.parallel.sharding import constrain

    x = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    for r in range(4):
        mesh = make_mesh(devices=["cpu"] * 4, dp=2, fsdp=1, tp=2).bind(r)
        assert constrain(x, mesh, "batch", "seq", None) is x  # sp = 1: nothing to do
        got = constrain(x, mesh, "batch", "heads", None)  # heads -> tp
        t = mesh.coords()["tp"]
        assert torch.equal(got, x[:, 3 * t:3 * t + 3])
        with pytest.raises(ValueError, match="first dimension"):
            constrain(x, mesh, None, "seq", None)  # the batch is split over dp
        with pytest.raises(ValueError, match="data axes"):
            constrain(x, mesh, "batch", "batch", None)
        with pytest.raises(ValueError, match="divide"):
            constrain(x[:, :, :3], mesh, "batch", None, "mlp")
    sp = make_mesh(devices=["cpu"] * 4, fsdp=2, sp=2).bind(3)
    np.testing.assert_array_equal(constrain(x, sp, "batch", "seq", None).numpy(),
                                  x[:, 3:].numpy())
    rules = [("batch", ("dp", "tp"))]
    mesh = make_mesh(devices=["cpu"] * 4, dp=2, fsdp=1, tp=2).bind(0)
    with pytest.raises(ValueError, match="first dimension"):
        constrain(x, mesh, "batch", rules=rules)
    gradient = torch.ones(2, 6, 4, requires_grad=True)
    constrain(gradient, make_mesh(devices=["cpu"] * 2, tp=2).bind(1), None, "heads").sum().backward()
    assert torch.equal(gradient.grad[:, :3], torch.zeros(2, 3, 4))
    assert torch.equal(gradient.grad[:, 3:], torch.ones(2, 3, 4))


class _Stand:
    """A stand-in group for a layout that reaches no collective."""

    def __init__(self, world_size):
        self.world_size = world_size


def test_fsdp_layout_of_a_block_split_over_fsdp_and_tp():
    """A (8, 6) kernel of axes (embed, heads) on fsdp=2 x tp=2: each rank
    holds its (4, 3) block under the whole spec, only the fsdp dimension is
    gathered (a module built at the tp block's widths, (8, 3), is given the
    (4, 3) block's), a replicated bias is held whole, and a spec that puts
    fsdp beside tp on one dimension raises."""
    from ray_tpu_torch.parallel.fsdp import FSDP
    from ray_tpu_torch.parallel.sharding import NamedSharding, P

    full = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    shapes = {"w": full.shape, "b": torch.Size([6])}
    axes = {"w": ("embed", "heads"), "b": None}
    for r in range(4):
        mesh = make_mesh(devices=["cpu"] * 4, fsdp=2, tp=2).bind(r, {"fsdp": _Stand(2)})
        layout = FSDP.for_model(mesh, shapes, axes)
        c = mesh.coords()
        assert torch.equal(layout.shard("w", full),
                           full[4 * c["fsdp"]:4 * c["fsdp"] + 4, 3 * c["tp"]:3 * c["tp"] + 3])
        bias = full[0].clone()
        assert layout.dims == {"w": 0} and layout.shard("b", bias) is bias
        module = torch.nn.Module()  # built at the gathered widths: the tp block
        module.w = torch.nn.Parameter(torch.empty(8, 3))
        module.b = torch.nn.Parameter(torch.empty(6))
        layout.localize(module)
        assert module.w.shape == (4, 3) and module.b.shape == (6,) and module.fsdp is layout
    with pytest.raises(NotImplementedError, match="fsdp alone"):
        FSDP(mesh, {"w": NamedSharding(mesh, P(("fsdp", "tp"), None))})
