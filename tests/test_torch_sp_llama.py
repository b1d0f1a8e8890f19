"""Sequence-parallel Llama of the port against the reference, on the CPU.

The reference's full forward runs ring attention under any mesh
(``ray_tpu/models/llama.py:248-261``), and ``next_token_loss`` under
``make_mesh(num_devices=2, sp=2, fsdp=1)`` is the loss of the whole
sequence, its gradient GSPMD's sum over the replicated parameters. The
port runs a gang of two spawned gloo ranks, each with a ``Llama(config,
mesh)`` over ``train.collective.gang_mesh("cpu", sp=2)`` bound to its sp
group: the tiny f32 model (2 layers, LoRA rank 4 on wq/wk/wv/wo, remat,
so every block's ring runs again in the backward), the reference's
weights carried over by ``params_from_jax``, global tokens from numpy
seeds. Held:

- each rank's logits shard (its half of the positions) against the
  reference's logits under the mesh;
- the loss every rank returns against the reference's, and the ranks'
  LoRA gradients summed against ``jax.grad`` (their scale pinned: each
  rank's alone is not the gradient);
- 3 AdamW steps through the LoRA loop's ``lora_train_step`` with the
  gradients summed by ``train.collective.reduce_gradients``, against the
  reference's jitted steps under the same mesh; the ranks bit-identical.

In process: a mesh with sp = 1 is ``mesh=None`` bit for bit; decode mode
never takes the ring; the refusals (sp beside another axis, an unbound
mesh, a sequence the ranks do not divide or past ``max_seq_len``, serving
with sp > 1: ROADMAP kept item 32). Each tolerance is stated at its assert.
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
from ray_tpu_torch.models.llama import LlamaConfig, build_llama, new_cache, next_token_loss
from ray_tpu_torch.parallel.mesh import make_mesh
from ray_tpu_torch.train import collective as tcol
from ray_tpu_torch.train.examples import llama_lora

_DEADLINE_S = 150.0
_LR = 1e-4
_RANKS = 2
_STEPS = 3
_SEQ = 32


def _tiny_config():
    return LlamaConfig.tiny(dtype=torch.float32, lora_rank=4, remat=True)


def _sp_loop(config):
    """Each rank: logits, loss and its own LoRA gradients at the first
    batch, then the steps with the gradients summed over the group."""
    from ray_tpu_torch.models.convert import params_from_jax

    torch.set_num_threads(1)
    r = train.get_context().world_rank
    tcfg = _tiny_config()
    mesh = tcol.gang_mesh("cpu", sp=_RANKS).bind(r, {"sp": tcol.tensor_group()})
    params = params_from_jax(config["params"], tcfg, device="cpu")
    model, lora, optimizer = llama_lora.lora_model(tcfg, params, lr=_LR, mesh=mesh)
    tokens = [torch.from_numpy(t).long() for t in config["tokens"]]
    with torch.no_grad():
        logits = model(tokens[0])
    loss = next_token_loss(tcfg, model, tokens[0])
    loss.backward()
    train.report({"rank": r, "logits": logits.numpy(), "loss": loss.item(),
                  "grads": {n: p.grad.numpy().copy() for n, p in lora.items()}})
    for step, t in enumerate(tokens):
        loss = llama_lora.lora_train_step(model, optimizer, t, tcol.reduce_gradients)
        train.report({"rank": r, "step": step, "loss": float(loss),
                      "adapters": {n: p.detach().numpy().copy() for n, p in lora.items()}})


def _reference_tree():
    """The reference's tiny f32 tree at PRNGKey(0) as numpy, ``lora_b``
    drawn from a seed (at 0 every ``lora_a`` gradient would be 0)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from ray_tpu.models.llama import init_params as jax_init_params
    from ray_tpu.parallel.sharding import unbox_params

    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, lora_rank=4)
    params = jax.tree_util.tree_map(
        np.asarray, unbox_params(jax_init_params(jcfg, jax.random.PRNGKey(0))))
    rng = np.random.default_rng(40)
    for layer in (v for k, v in params.items() if k.startswith("layer_")):
        for proj in layer["attn"].values():
            proj["lora_b"] = 0.05 * rng.standard_normal(proj["lora_b"].shape).astype(np.float32)
    return jcfg, params


@pytest.fixture(scope="module")
def sp_run():
    """The gang's reports and the reference's logits, loss, gradients and
    steps under an sp=2 mesh, computed while the gang runs."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models.llama import Llama as JaxLlama
    from ray_tpu.models.llama import next_token_loss as jax_next_token_loss
    from ray_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ray_tpu.train.lora import merge_lora as jax_merge_lora
    from ray_tpu.train.lora import split_lora as jax_split_lora

    jcfg, params = _reference_tree()
    rng = np.random.default_rng(41)
    config = {"params": params,
              "tokens": [rng.integers(0, jcfg.vocab_size, (2, _SEQ)).astype(np.int32)
                         for _ in range(_STEPS)]}
    box = []
    with tempfile.TemporaryDirectory() as storage:
        trainer = train.DataParallelTrainer(
            _sp_loop, train_loop_config=config,
            scaling_config=train.ScalingConfig(_RANKS, {"CPU": 1}),
            run_config=train.RunConfig(name="sp-llama", storage_path=storage),
            backend_config=train.TorchConfig(timeout_s=int(_DEADLINE_S)))
        thread = threading.Thread(target=lambda: box.append(trainer.fit()), daemon=True)
        thread.start()

        mesh = jax_make_mesh(num_devices=_RANKS, sp=_RANKS, fsdp=1)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        logits = jax.jit(lambda p, t: JaxLlama(jcfg, mesh).apply({"params": p}, t))(
            jparams, jnp.asarray(config["tokens"][0]))
        base, lora = jax_split_lora(jparams)
        tx = optax.adamw(_LR)

        @jax.jit
        def train_step(lp, s, tok):
            loss, grads = jax.value_and_grad(
                lambda p: jax_next_token_loss(jcfg, mesh, jax_merge_lora(base, p), tok))(lp)
            updates, s = tx.update(grads, s, lp)
            return optax.apply_updates(lp, updates), s, loss, grads

        state = tx.init(lora)
        steps = []
        for tok in config["tokens"]:
            lora, state, loss, grads = train_step(lora, state, jnp.asarray(tok))
            steps.append(({".".join(k): np.asarray(v) for k, v in lora.items()}, float(loss),
                          {".".join(k): np.asarray(v) for k, v in grads.items()}))
        reference = dict(logits=np.asarray(logits), steps=steps,
                         start={".".join(k): np.asarray(v)
                                for k, v in jax_split_lora(jparams)[1].items()})
        thread.join(_DEADLINE_S)
        if thread.is_alive():
            for child in multiprocessing.active_children():
                child.kill()
            thread.join(10)
            pytest.fail(f"fit() did not finish in {_DEADLINE_S} s; its workers were killed")
    assert not multiprocessing.active_children()
    result = box[0]
    assert result.error is None, result.error
    first = {m["rank"]: m for m in result.metrics_history if "grads" in m}
    steps = {}
    for m in result.metrics_history:
        if "step" in m:
            steps.setdefault(m["step"], {})[m["rank"]] = m
    assert sorted(first) == list(range(_RANKS)) and sorted(steps) == list(range(_STEPS))
    return first, steps, reference


def test_each_rank_returns_its_shard_of_the_logits(sp_run):
    """Rank r's (2, 16, vocab) logits are positions [16 r, 16 r + 16) of the
    reference's under the mesh: f32 on both sides, the same arithmetic in
    another summation order (1e-4, as the one-rank forward's test)."""
    first, _, reference = sp_run
    s = _SEQ // _RANKS
    for r, m in first.items():
        assert m["logits"].shape == (2, s, 256)
        assert np.abs(m["logits"] - reference["logits"][:, r * s:(r + 1) * s]).max() < 1e-4


def test_loss_and_summed_lora_gradients_match_jax_grad(sp_run):
    """Every rank returns the loss over the whole sequence (an f32 NLL sum
    in another order: 1e-5 relative); the ranks' LoRA gradients summed are
    ``jax.grad``'s (1e-4 relative to each adapter's largest gradient, as
    tests/test_torch_llama.py's one-rank gradients); one rank's alone is
    not (each rank holds its positions' share)."""
    first, _, reference = sp_run
    _, jloss, jgrads = reference["steps"][0]
    assert first[0]["loss"] == first[1]["loss"]
    assert abs(first[0]["loss"] - jloss) <= 1e-5 * abs(jloss)
    assert sorted(first[0]["grads"]) == sorted(jgrads)
    for name, jg in jgrads.items():
        total = sum(m["grads"][name] for m in first.values())
        scale = np.abs(jg).max()
        assert np.abs(total - jg).max() <= 1e-4 * scale, name
        assert np.abs(first[0]["grads"][name] - jg).max() > 10 * 1e-4 * scale, name


def test_adamw_steps_match_reference_and_ranks_agree(sp_run):
    """Three steps of the loop's ``lora_train_step``, gradients summed over
    the sp group, against the reference's jitted steps under the mesh: the
    losses (1e-5 relative), every adapter within Adam's bound (an element
    moves about lr a step whatever its gradient's size, so a near-zero
    gradient whose sign the f32 rounding flips parts the two by up to 2 lr
    a step; 99% of the elements within 1e-3 lr, as tests/test_torch_fsdp.py);
    the two ranks bit-identical."""
    _, steps, reference = sp_run
    for s, (jlora, jloss, _) in enumerate(reference["steps"]):
        ranks = steps[s]
        assert ranks[0]["loss"] == ranks[1]["loss"]
        assert abs(ranks[0]["loss"] - jloss) <= 1e-5 * abs(jloss)
        diffs = np.concatenate([np.abs(ranks[0]["adapters"][k] - v).ravel()
                                for k, v in jlora.items()])
        assert diffs.max() <= 2 * (s + 1) * _LR
        assert np.quantile(diffs, 0.99) <= 1e-3 * _LR
        for name, a in ranks[1]["adapters"].items():
            np.testing.assert_array_equal(a, ranks[0]["adapters"][name])
    moved = np.concatenate([np.abs(steps[_STEPS - 1][0]["adapters"][k] - v).ravel()
                            for k, v in reference["start"].items()])
    assert np.median(moved) >= 0.5 * _LR  # the steps moved the adapters


class _SpGroup:
    """A stand-in sp group for the paths that must reach no collective."""

    def __init__(self, world_size, rank):
        self.world_size, self.rank = world_size, rank


def _random_params(tcfg, seed=42):
    from ray_tpu_torch.models.llama import init_params

    params = init_params(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for name, p in params.items():
        if name.endswith("lora_b"):
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return params


class _OneRank:
    """A one-rank fsdp group in process: every gather and reduce-scatter is
    the identity (a copy), as a one-rank gloo or NCCL group's."""

    world_size, rank = 1, 0

    def allgather_cat(self, x, dim=0):
        return x.clone()

    def reducescatter_sum(self, x, dim=0):
        return x.clone()


@pytest.mark.parametrize("groups", [{}, {"fsdp": _OneRank()}], ids=["one_rank", "fsdp_gathers"])
def test_sp1_mesh_is_mesh_none_bit_for_bit(groups):
    """A one-rank mesh (sp = 1) runs plain flash: the logits, the loss and
    every LoRA gradient equal ``mesh=None``'s exactly, with its parameters
    read directly or through the FSDP gathers of a bound one-rank ``fsdp``
    group (the LoRA loop's layout at one rank). An ``fsdp`` axis past 1
    splits the parameters now (tests/test_torch_llama_mesh.py)."""
    tcfg = _tiny_config()
    params = _random_params(tcfg)
    mesh = make_mesh(devices=["cpu"], sp=1, fsdp=1).bind(0, groups)
    tokens = torch.from_numpy(np.random.default_rng(43).integers(0, 256, (2, 24))).long()
    outs = []
    for m in (None, mesh):
        model, lora, _ = llama_lora.lora_model(tcfg, params, mesh=m)
        assert model.sp_group is None
        assert m is None or len(model.fsdp.sharded) == (2 * (2 + 7 + 4) + 3 if groups else 0)
        with torch.no_grad():
            logits = model(tokens)
        loss = next_token_loss(tcfg, model, tokens)
        loss.backward()
        outs.append((logits, loss.detach(), {k: p.grad.clone() for k, p in lora.items()}))
        for p in lora.values():
            p.grad = None
    (l0, s0, g0), (l1, s1, g1) = outs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_decode_mode_never_takes_the_ring():
    """Under an sp=2 mesh the decode-mode call runs the whole call on the
    rank, as the reference's engine does (its decode=True model takes the
    cache branch): the same logits and cache as ``mesh=None``, and the sp
    group (a stand-in with no collective) is never reached."""
    tcfg = LlamaConfig.tiny(dtype=torch.float32)
    params = _random_params(tcfg)
    mesh = make_mesh(devices=["cpu"] * 2, sp=2).bind(1, {"sp": _SpGroup(2, 1)})
    tokens = torch.from_numpy(np.random.default_rng(44).integers(0, 256, (2, 12))).long()
    outs = []
    for m in (None, mesh):
        model = build_llama(tcfg, params, m)
        cache = new_cache(tcfg, 2, "cpu")
        with torch.no_grad():
            first = model(tokens, cache)
            step = model(tokens[:, :1], cache)
        outs.append((first, step, cache.key.clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_sequence_parallel_refusals():
    """sp beside other axes builds now (the ring over each rank's sp
    sub-group; trained in tests/test_torch_llama_mesh.py), given the groups
    of every axis; still refused: a mesh missing a group, an unbound sp
    mesh, a sequence the ranks do not divide or longer than
    ``max_seq_len`` (RoPE would clamp the offset), the ViT's and the MoE's
    sp > 1 (ROADMAP item A.12), ``pp`` (A.5.4), and serving with sp > 1
    (kept item 32: the reference never runs the ring when it serves)."""
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.models.llama import Llama
    from ray_tpu_torch.models.moe import MoEConfig, MoETransformer
    from ray_tpu_torch.models.vit import ViT, ViTConfig
    from ray_tpu_torch.parallel.plan import PartitionPlan

    tcfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=32)
    for axes in ({"sp": 2, "tp": 2}, {"sp": 2, "fsdp": 2}, {"sp": 2, "dp": 2}):
        mesh = make_mesh(devices=["cpu"] * 4, **axes)
        other = next(a for a in axes if a != "sp")
        groups = {"sp": _SpGroup(2, 0), other: _SpGroup(2, 0),
                  ("dp", "sp") if other == "dp" else ("fsdp", "sp"): _SpGroup(4, 0)}
        with pytest.raises(ValueError, match="form_groups"):
            Llama(tcfg, mesh.bind(0, {"sp": _SpGroup(2, 0)}))
        with torch.device("meta"):
            model = Llama(tcfg, mesh.bind(0, groups))
        assert model.sp == 2 and model.fsdp is not None
        assert model.lm_head.shape[1] == tcfg.vocab_size // axes.get("tp", 1)
        with pytest.raises(NotImplementedError, match="item A.12"):
            ViT(ViTConfig.tiny(), mesh.bind(0, groups))
        with pytest.raises(NotImplementedError, match="item A.12"):
            MoETransformer(MoEConfig.tiny(), mesh.bind(0, groups))
    with pytest.raises(NotImplementedError, match="A.5.4"):
        Llama(tcfg, make_mesh(devices=["cpu"] * 4, sp=2, pp=2, fsdp=1).bind(0))
    with pytest.raises(ValueError, match="bound"):
        Llama(tcfg, make_mesh(devices=["cpu"] * 2, sp=2))
    model = build_llama(tcfg, _random_params(tcfg),
                        make_mesh(devices=["cpu"] * 2, sp=2).bind(0, {"sp": _SpGroup(2, 0)}))
    with torch.no_grad():
        with pytest.raises(ValueError, match="divide"):
            model(torch.zeros((1, 15), dtype=torch.long))
        with pytest.raises(ValueError, match="max_seq_len"):
            model(torch.zeros((1, 34), dtype=torch.long))
    for kwargs in (dict(sequence_parallel_size=2), dict(mesh={"sp": 2, "tp": 2})):
        with pytest.raises(NotImplementedError, match="kept item 32"):
            LLMConfig(model_id="llama-tiny", **kwargs)
    with pytest.raises(NotImplementedError, match="kept item 32"):
        PartitionPlan.for_model(tcfg, 1, sequence_parallel_size=2, devices=["cpu"] * 2)
