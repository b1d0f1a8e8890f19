"""Ring and Ulysses attention of the port against the reference, on the CPU.

The reference runs ``ray_tpu.parallel.ring_attention`` /
``ray_tpu.parallel.ulysses`` under ``shard_map`` over 2 and 4 of the
conftest's virtual CPU devices, with Pallas in interpret mode. The port
runs one gang of four spawned gloo ranks (``resources_per_worker={"CPU":
1}``): ranks 0 and 1 also form a group of two, so each op runs at 2 and at
4 ranks, every rank on its contiguous shard of a sequence made from numpy
seeds, the plain versions of K2-K4 under each block. Held:

- the group ops under them: ``ring_shift`` of tensors of two dtypes,
  ``collective.functional.all_to_all`` and its gradient (the inverse
  all-to-all), and ``sum_of_ranks``, whose gradient is each rank's own;
- ring forward o and q/k/v gradients in f32 and bf16, with GQA, at 2 and
  4 ranks, against the reference's; Ulysses likewise, and its
  ``ValueError`` for heads the ranks do not divide;
- ``_merge`` of a skipped hop (o = 0, lse = -inf) and of a fully masked
  row of K2 (o = 0, lse = -1e30, ROADMAP kept item 4) leaving o and lse as
  they were, bit for bit, so a skipped hop need launch nothing;
- the ring of one rank (or none) is ``flash_attention(causal=True)``, bit
  for bit.

Each tolerance is stated at its assert. The workers import this module by
name, so it imports neither ``jax`` nor ``ray_tpu`` at its top.
"""

import math
import multiprocessing
import tempfile
import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch import train
from ray_tpu_torch.collective.functional import sum_of_ranks
from ray_tpu_torch.ops.flash_attention import flash_attention, flash_attention_with_lse
from ray_tpu_torch.parallel.ring_attention import _merge, ring_attention
from ray_tpu_torch.parallel.ulysses import ulysses_attention
from ray_tpu_torch.train import collective as tcol

_DEADLINE_S = 150.0
_RANKS = 4
_CPU = {"CPU": 1}

# (op, ranks, dtype, batch, heads, kv heads, global seq, head dim): each of
# ranks, dtype and GQA appears both ways for the ring
_CASES = {
    "ring_n2_f32": ("ring", 2, "f32", 2, 4, 4, 64, 16),
    "ring_n4_f32_gqa": ("ring", 4, "f32", 1, 4, 2, 64, 16),
    "ring_n2_bf16_gqa": ("ring", 2, "bf16", 1, 4, 2, 64, 32),
    "ring_n4_bf16": ("ring", 4, "bf16", 2, 2, 2, 64, 16),
    "ulysses_n2_f32_gqa": ("ulysses", 2, "f32", 1, 4, 2, 32, 16),
    "ulysses_n4_bf16": ("ulysses", 4, "bf16", 2, 4, 4, 32, 16),
}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(case):
    """q, k, v and the output cotangent of a case, f32 numpy, from its seed."""
    _, _, _, b, h, hk, s, d = _CASES[case]
    rng = np.random.default_rng(sorted(_CASES).index(case) + 31)
    shapes = ((b, h, s, d), (b, hk, s, d), (b, hk, s, d), (b, h, s, d))
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


def _as(a, dtype):
    return torch.from_numpy(a).to(_TORCH[dtype])


def _ring_loop(config):
    """Each rank: the group ops at 4 ranks, then every case at the ranks it
    has (ranks 0 and 1 also in their group of two); all reported."""
    import torch.distributed as dist

    from ray_tpu_torch.collective.functional import all_to_all
    from ray_tpu_torch.collective.gloo_group import GlooGroup

    torch.set_num_threads(1)
    r = train.get_context().world_rank
    groups = {_RANKS: tcol.tensor_group()}
    pair = dist.new_group([0, 1], backend="gloo")  # every rank takes part
    if r < 2:
        groups[2] = GlooGroup(2, r, "ring-pair", process_group=pair)
    group = groups[_RANKS]
    out = {"rank": r}

    a, b = (torch.from_numpy(x[r]) for x in config["shift"])
    got = group.ring_shift([a, b.to(torch.bfloat16)]).wait()
    out["shift"] = [got[0].numpy(), got[1].float().numpy(), str(got[1].dtype)]
    x = torch.from_numpy(config["a2a"][r]).requires_grad_(True)
    y = all_to_all(x, group, split_dim=1, concat_dim=2)
    (y * torch.from_numpy(config["a2a_w"][r])).sum().backward()
    out["a2a"] = [y.detach().numpy(), x.grad.numpy()]
    x = torch.from_numpy(config["shift"][0][r]).requires_grad_(True)
    total = sum_of_ranks(x.sum(), group)
    (3.0 * total).backward()
    out["sum"] = [total.item(), x.grad.numpy()]

    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    for case, (op, n, dtype, *_) in _CASES.items():
        if r >= n:
            continue
        q, k, v, w = _inputs(case)
        s = q.shape[2] // n
        rows = slice(r * s, (r + 1) * s)
        ql, kl, vl = (_as(t[:, :, rows], dtype).requires_grad_(True) for t in (q, k, v))
        o = fns[op](ql, kl, vl, group=groups[n])
        (o.float() * torch.from_numpy(w[:, :, rows])).sum().backward()
        out[case] = [t.detach().float().numpy() for t in (o, ql.grad, kl.grad, vl.grad)]
        out[case + "_dtypes"] = [str(t.dtype) for t in (o, ql.grad, kl.grad, vl.grad)]
    train.report(out)


def _reference_case(case):
    """The reference op under shard_map on the first n virtual devices: o
    and the q, k, v gradients of sum(o * w), f32 numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as JaxP

    from ray_tpu._internal.jax_compat import shard_map
    from ray_tpu.parallel.ring_attention import ring_attention as jax_ring
    from ray_tpu.parallel.ulysses import ulysses_attention as jax_ulysses

    op, n, dtype, *_ = _CASES[case]
    fn = {"ring": jax_ring, "ulysses": jax_ulysses}[op]
    jdtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    spec = JaxP(None, None, "sp", None)
    sharded = shard_map(lambda q, k, v: fn(q, k, v, axis_name="sp"),
                        mesh=Mesh(np.array(jax.devices()[:n]), ("sp",)),
                        in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    q, k, v, w = _inputs(case)

    @jax.jit
    def run(q, k, v, w):
        o, vjp = jax.vjp(sharded, q, k, v)
        return (o, *vjp(w.astype(o.dtype)))

    got = run(*(jnp.asarray(t, jdtype) for t in (q, k, v)), jnp.asarray(w))
    return [np.asarray(t.astype(jnp.float32)) for t in got]


@pytest.fixture(scope="module")
def gang():
    """The gang's reports by rank, the config they ran on and the
    reference's results by case, computed while the gang runs."""
    rng = np.random.default_rng(30)
    config = {
        "shift": [rng.standard_normal((_RANKS, 3, 4)).astype(np.float32),
                  rng.standard_normal((_RANKS, 5)).astype(np.float32)],
        "a2a": rng.standard_normal((_RANKS, 2, 8, 3)).astype(np.float32),
        "a2a_w": rng.standard_normal((_RANKS, 2, 2, 12)).astype(np.float32),
    }
    box = []
    with tempfile.TemporaryDirectory() as storage:
        trainer = train.DataParallelTrainer(
            _ring_loop, train_loop_config=config,
            scaling_config=train.ScalingConfig(_RANKS, _CPU),
            run_config=train.RunConfig(name="ring", storage_path=storage),
            backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)))
        thread = threading.Thread(target=lambda: box.append(trainer.fit()), daemon=True)
        thread.start()
        reference = {case: _reference_case(case) for case in _CASES}
        thread.join(_DEADLINE_S)
        if thread.is_alive():
            for child in multiprocessing.active_children():
                child.kill()
            thread.join(10)
            pytest.fail(f"fit() did not finish in {_DEADLINE_S} s; its workers were killed")
    assert not multiprocessing.active_children()
    result = box[0]
    assert result.error is None, result.error
    reports = {m["rank"]: m for m in result.metrics_history}
    assert sorted(reports) == list(range(_RANKS))
    return reports, config, reference


def test_ring_shift_hands_each_rank_the_previous_rank_s_tensors(gang):
    """Both tensors of the hop arrive from rank - 1, exactly, in their own
    dtypes (the bf16 one rounded once, on its sender)."""
    reports, config, _ = gang
    a, b = config["shift"]
    for r, m in reports.items():
        prev = (r - 1) % _RANKS
        np.testing.assert_array_equal(m["shift"][0], a[prev])
        np.testing.assert_array_equal(
            m["shift"][1], torch.from_numpy(b[prev]).to(torch.bfloat16).float().numpy())
        assert m["shift"][2] == "torch.bfloat16"


def test_all_to_all_and_its_gradient(gang):
    """``lax.all_to_all(tiled=True)``: rank r's output is block r (along
    dim 1) of every rank's input, concatenated along dim 2 in rank order;
    its gradient is the inverse all-to-all of the cotangents (a
    permutation: exact)."""
    reports, config, _ = gang
    x, w = config["a2a"], config["a2a_w"]
    blocks = [np.split(x[j], _RANKS, axis=1) for j in range(_RANKS)]
    for r, m in reports.items():
        want = np.concatenate([blocks[j][r] for j in range(_RANKS)], axis=2)
        np.testing.assert_array_equal(m["a2a"][0], want)
        grad = np.concatenate([np.split(w[j], _RANKS, axis=2)[r] for j in range(_RANKS)], axis=1)
        np.testing.assert_array_equal(m["a2a"][1], grad)


def test_sum_of_ranks_gives_each_rank_its_own_gradient(gang):
    """The value is the sum over the ranks (gloo adds in rank order, in
    f32); the gradient of 3 x the sum by a rank's own term is 3, not 3 x
    the world size (what an all-reduced cotangent would give)."""
    reports, config, _ = gang
    total = np.float32(0)
    for x in config["shift"][0]:
        total = np.float32(total + x.sum(dtype=np.float32))
    for m in reports.values():
        assert m["sum"][0] == pytest.approx(float(total), rel=1e-6)
        np.testing.assert_array_equal(m["sum"][1], np.full((3, 4), 3.0, np.float32))


def _close(got, want, tol, what):
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("case", list(_CASES))
def test_sequence_parallel_attention_matches_reference(gang, case):
    """Each rank's rows of o and its shards of the q, k, v gradients
    against the reference's under shard_map on as many devices, in the
    inputs' dtype."""
    reports, _, reference = gang
    op, n, dtype, *_ = _CASES[case]
    ranks = [reports[r] for r in range(n)]
    for m in ranks:
        assert m[case + "_dtypes"] == [str(_TORCH[dtype])] * 4
    for i, what in enumerate(("o", "dq", "dk", "dv")):
        got = np.concatenate([m[case][i] for m in ranks], axis=2)
        want = reference[case][i]
        scale = np.abs(want).max()
        if dtype == "f32":
            # the same blockwise arithmetic in another summation order (the
            # port's plain blocks against the Pallas kernels' tiles)
            tol = 1e-5 * scale
        else:
            # bf16 results rounded at other places: the port's plain blocks
            # round each block's o and gradient once, the Pallas kernels
            # also round P (and dS) to bf16 first; each ring hop adds one
            # rounding to o (the merge) and to dq, dk and dv (their sums).
            # n + 1 bf16 ulps (2^-8 relative) of the largest value
            tol = (n + 1) * 2.0 ** -8 * scale
        _close(got, want, tol, f"{case} {what}")


def test_ulysses_refuses_heads_the_ranks_do_not_divide():
    """Three heads over two ranks: both packages raise ``ValueError`` before
    any collective."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as JaxP

    from ray_tpu._internal.jax_compat import shard_map
    from ray_tpu.parallel.ulysses import ulysses_attention as jax_ulysses

    class _TwoRanks:  # no collective is reached
        world_size, rank = 2, 0

    q = np.zeros((1, 3, 8, 16), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(*(torch.from_numpy(q),) * 3, group=_TwoRanks())
    spec = JaxP(None, None, "sp", None)
    with pytest.raises(ValueError, match="divisible"):
        shard_map(lambda a, b, c: jax_ulysses(a, b, c, axis_name="sp"),
                  mesh=Mesh(np.array(jax.devices()[:2]), ("sp",)),
                  in_specs=(spec,) * 3, out_specs=spec,
                  check_vma=False)(*(jnp.asarray(np.zeros((1, 3, 16, 16), np.float32)),) * 3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_merge_of_a_skipped_hop_or_a_masked_row_changes_nothing(dtype):
    """A skipped hop (o = 0, lse = -inf, the reference's ``_skip``) and a
    fully masked row of K2 (o = 0, lse = -1e30, kept item 4) both leave o
    and lse bit for bit: the port's skipped hop launches nothing and merges
    nothing. Two finite partials merge as the reference's ``_merge``."""
    import jax.numpy as jnp

    from ray_tpu.parallel.ring_attention import _merge as jax_merge

    rng = np.random.default_rng(33)
    o = _as(rng.standard_normal((2, 3, 8, 16)).astype(np.float32), dtype)
    lse = torch.from_numpy(rng.standard_normal((2, 3, 8)).astype(np.float32) * 4)
    for empty in (float("-inf"), -1e30):
        o2, lse2 = _merge(o, lse, torch.zeros_like(o), torch.full_like(lse, empty))
        assert o2.dtype == o.dtype and torch.equal(o2, o)
        assert torch.equal(lse2, lse)
    other = _as(rng.standard_normal((2, 3, 8, 16)).astype(np.float32), dtype)
    lse_other = torch.from_numpy(rng.standard_normal((2, 3, 8)).astype(np.float32) * 4)
    got, got_lse = _merge(o, lse, other, lse_other)
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want, want_lse = jax_merge(*(jnp.asarray(t.float().numpy(), d) for t, d in (
        (o, jdtype), (lse, jnp.float32), (other, jdtype), (lse_other, jnp.float32))))
    # f32 exp/log of two frameworks: a few f32 ulps; the bf16 output rounds
    # once from f32, so at most one bf16 ulp (2^-8 relative) apart
    tol = 1e-6 if dtype == "f32" else 2.0 ** -8
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           tol * np.abs(np.asarray(want.astype(jnp.float32))).max(), "merged o")
    _close(got_lse.numpy(), np.asarray(want_lse), 1e-6 * np.abs(np.asarray(want_lse)).max(),
           "merged lse")


def test_ring_of_one_rank_is_flash_attention():
    """``group=None`` and a group of one rank take ``flash_attention(causal=
    True)``: o and every gradient equal, bit for bit (GQA included)."""

    class _OneRank:  # a one-rank ring makes no hop
        world_size, rank = 1, 0

    rng = np.random.default_rng(34)
    q, w = (torch.from_numpy(rng.standard_normal((1, 4, 24, 16)).astype(np.float32))
            for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 24, 16)).astype(np.float32))
            for _ in range(2))
    outs = []
    for fn in (lambda *a: flash_attention(*a, causal=True),
               lambda *a: ring_attention(*a, group=None),
               lambda *a: ring_attention(*a, group=_OneRank())):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves)
        (o * w).sum().backward()
        outs.append([o.detach()] + [t.grad for t in leaves])
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert torch.equal(a, b)
    # and the sm_scale default is the flash default, 1/sqrt(d)
    o, _ = flash_attention_with_lse(q, k, v, causal=True, sm_scale=1 / math.sqrt(16))
    assert torch.equal(o, outs[0][0])
