"""The port's sharded checkpoint against the reference's, on the CPU: the
three cases of tests/test_sharded_checkpoint.py, with the port's ranks
called one after another in this process (each writes only its own
blocks, as each process of a gang would).

The reference's state is an (8, 8) f32 array laid out ``P("dp", "tp")`` on
a 4 x 2 mesh of host devices, and a step count. The port's ranks hold the
same blocks (rank r is the mesh's r-th device in row-major order, as the
reference's ``reshape``); a restore onto a 2 x 4 mesh with ``P(None, "tp")``
gives each rank the block the reference's restore puts on that device,
and a checkpoint of fsdp=2 blocks restores at fsdp=1 and fsdp=4. The
formats differ (orbax against ``torch.save``), so each side reads only its
own.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding as JaxNamedSharding, PartitionSpec as JaxP

from ray_tpu.train import restore_sharded as jax_restore_sharded
from ray_tpu.train import save_sharded as jax_save_sharded
from ray_tpu_torch.parallel.mesh import make_mesh
from ray_tpu_torch.parallel.sharding import NamedSharding, P
from ray_tpu_torch.train import ShardedCheckpointWriter, restore_sharded, save_sharded

_W = np.arange(64, dtype=np.float32).reshape(8, 8)


def _save_every_rank(path, w, mesh, spec, step=3, save=save_sharded):
    for rank in range(mesh.size):
        sharding = NamedSharding(mesh.bind(rank), spec)
        save(path, {"w": sharding.shard(w), "step": step}, {"w": sharding})


@pytest.fixture
def state_and_mesh(tmp_path):
    mesh = make_mesh(devices=["cpu"] * 8, dp=4, fsdp=1, tp=2)
    return torch.from_numpy(_W.copy()), mesh, str(tmp_path / "ckpt")


def test_save_restore_roundtrip(state_and_mesh):
    w, mesh, path = state_and_mesh
    _save_every_rank(path, w, mesh, P("dp", "tp"))
    restored = restore_sharded(path)
    np.testing.assert_array_equal(restored["w"].numpy(), _W)
    assert restored["step"] == 3
    with open(os.path.join(path, "sharded_state", "manifest.json")) as f:
        leaf = json.load(f)["leaves"]["w"]
    # every block written once, by the rank that holds it
    assert leaf["shape"] == [8, 8] and leaf["spec"] == ["dp", "tp"]
    assert [s["rank"] for s in leaf["shards"]] == list(range(8))
    assert sorted(os.listdir(os.path.join(path, "sharded_state"))) == (
        ["manifest.json"] + [f"rank{r:05d}.pt" for r in range(8)])


def test_restore_onto_different_mesh(state_and_mesh, tmp_path):
    """A checkpoint from the 4 x 2 mesh restores onto a 2 x 4 mesh with
    another partitioning: each rank's block is the one the reference's
    restore places on that device."""
    w, mesh, path = state_and_mesh
    _save_every_rank(path, w, mesh, P("dp", "tp"))
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("dp", "tp"))
    jpath = str(tmp_path / "jax")
    jax_save_sharded(jpath, {"w": jax.device_put(jnp.asarray(_W), JaxNamedSharding(
        jmesh, JaxP("dp", "tp"))), "step": jnp.asarray(3)})
    jmesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "tp"))
    jrestored = jax_restore_sharded(jpath, shardings={
        "w": JaxNamedSharding(jmesh2, JaxP(None, "tp")), "step": JaxNamedSharding(jmesh2, JaxP())})
    shards = {s.device.id: np.asarray(s.data) for s in jrestored["w"].addressable_shards}
    mesh2 = make_mesh(devices=["cpu"] * 8, dp=2, fsdp=1, tp=4)
    for rank in range(8):
        sharding = NamedSharding(mesh2.bind(rank), P(None, "tp"))
        restored = restore_sharded(path, shardings={"w": sharding})
        np.testing.assert_array_equal(restored["w"].numpy(), shards[rank])
        assert restored["step"] == int(jrestored["step"]) == 3
        assert restored["w"].shape == (8, 2)


@pytest.mark.parametrize("to", [1, 4])
def test_restore_fsdp2_onto_another_fsdp_size(tmp_path, to):
    """fsdp=2 blocks of a (16, 8) tensor split on its first dimension
    restore at fsdp=1 (whole) and fsdp=4 (quarters), with the target's
    dtype."""
    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "fsdp2")
    _save_every_rank(path, w, make_mesh(devices=["cpu"] * 2, fsdp=2), P("fsdp", None))
    mesh = make_mesh(devices=["cpu"] * to, fsdp=to)
    for rank in range(to):
        sharding = NamedSharding(mesh.bind(rank), P("fsdp", None))
        got = restore_sharded(path, target={"w": torch.empty(0, dtype=torch.float64)},
                              shardings={"w": sharding})
        assert set(got) == {"w"} and got["w"].dtype == torch.float64
        np.testing.assert_array_equal(got["w"].numpy(), sharding.shard(w).double().numpy())


def test_async_writer_overlaps(state_and_mesh):
    """``save`` returns with the blocks copied: an in-place update right
    after it (as AdamW's) does not reach the checkpoint; a second save
    after ``wait`` writes the new state."""
    w, mesh, path = state_and_mesh
    writers = [ShardedCheckpointWriter() for _ in range(mesh.size)]
    try:
        for rank, writer in enumerate(writers):
            sharding = NamedSharding(mesh.bind(rank), P("dp", "tp"))
            writer.save(path, {"w": sharding.shard(w), "step": 3}, {"w": sharding})
        w.mul_(2)  # in place, while the writes may still run
        for writer in writers:
            writer.wait()
        np.testing.assert_array_equal(restore_sharded(path)["w"].numpy(), _W)
        shutil.rmtree(path, ignore_errors=True)
        for rank, writer in enumerate(writers):
            sharding = NamedSharding(mesh.bind(rank), P("dp", "tp"))
            writer.save(path, {"w": sharding.shard(w), "step": 4}, {"w": sharding})
    finally:
        for writer in writers:
            writer.close()
    restored = restore_sharded(path)
    np.testing.assert_array_equal(restored["w"].numpy(), _W * 2)
    assert restored["step"] == 4


def test_a_missing_block_or_tensor_raises(state_and_mesh):
    w, mesh, path = state_and_mesh
    with pytest.raises(FileNotFoundError, match="no sharded state"):
        restore_sharded(path)
    sharding = NamedSharding(mesh.bind(0), P("dp", "tp"))
    save_sharded(path, {"w": sharding.shard(w)}, {"w": sharding})  # rank 0 alone
    with pytest.raises(FileNotFoundError):
        restore_sharded(path)
    with pytest.raises(KeyError, match="no 'v'"):
        restore_sharded(path, target={"v": torch.empty(0)})
    with pytest.raises(KeyError, match="name no tensor"):
        save_sharded(path, {"w": w}, {"x": sharding})
