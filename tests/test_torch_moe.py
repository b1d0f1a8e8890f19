"""ray_tpu_torch's MoE (models/moe.py, parallel/expert.py) against ray_tpu's,
on the CPU.

Gating runs on router logits from numpy seeds through both packages. The
model runs ``MoEConfig.tiny(n_kv_heads=2)`` in f32 (GQA: 4 query heads over
2 KV heads): the reference's parameter tree (the shapes of its
``init_params``, unboxed) is filled from a numpy seed and carried into the
port by ``moe_params_from_jax``. The reference reaches its Pallas flash
kernel in interpret mode, the port the plain versions of its kernels (the
tensors lie on the CPU). The reference's ``value_and_grad`` takes about
12 s here, so it runs once per module (the ``reference`` fixture).

Tolerances are stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ray_tpu._internal.jax_compat import shard_map
from ray_tpu.models import moe as jmoe
from ray_tpu.parallel import expert as jexp
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import _flatten, moe_params_from_jax
from ray_tpu_torch.models.llama import nll_from_logits
from ray_tpu_torch.parallel import expert as texp

F32_ULP = 2.0 ** -23


def _configs(**kw):
    """The tiny config of both packages in f32, GQA on; kw in both."""
    base = dict(n_kv_heads=2, **kw)
    return (jmoe.MoEConfig.tiny(dtype=jnp.float32, **base),
            tmoe.MoEConfig.tiny(dtype=torch.float32, **base))


def _random_tree(shapes, rng):
    """numpy values for a tree of the reference's shapes: norm weights in
    [0.5, 1.5], every other leaf normal with variance 1/fan-in (fan-in:
    every axis but the last), so router logits spread over about one unit
    and routing is decided by clear margins."""
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = _random_tree(val, rng)
        elif key.endswith("norm"):
            out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
        else:
            fan_in = int(np.prod(val.shape[:-1]))
            out[key] = (rng.standard_normal(val.shape) / np.sqrt(fan_in)).astype(np.float32)
    return out


def _reference_shapes(jcfg):
    return jax.eval_shape(lambda r: unbox_params(jmoe.init_params(jcfg, r)),
                          jax.random.PRNGKey(0))


def _reference_params(jcfg, seed=11):
    return _random_tree(_reference_shapes(jcfg), np.random.default_rng(seed))


def _tokens(shape=(2, 24), seed=12, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, rel, what):
    """Largest |got - want| within ``rel`` of the largest |want|."""
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


@pytest.fixture(scope="module")
def reference():
    """The reference's logits, sown aux losses, loss and gradients on one
    parameter tree and one batch, computed once."""
    jcfg, tcfg = _configs()
    jparams = jax.tree_util.tree_map(jnp.asarray, _reference_params(jcfg))
    tokens = _tokens()

    @jax.jit
    def run(p):
        logits, sown = jmoe.MoETransformer(jcfg).apply(
            {"params": p}, jnp.asarray(tokens), mutable=["losses"])
        loss, grads = jax.value_and_grad(
            lambda p_: jmoe.next_token_loss(jcfg, None, p_, jnp.asarray(tokens)))(p)
        return logits, sown, loss, grads

    logits, sown, loss, grads = run(jparams)
    aux = [float(sown["losses"][f"layer_{i}"]["moe"]["router_aux"][0])
           for i in range(jcfg.n_layers)]
    return dict(
        tcfg=tcfg, tokens=tokens, logits=np.asarray(logits), aux=aux, loss=float(loss),
        params=jax.tree_util.tree_map(np.asarray, jparams),
        grads=jax.tree_util.tree_map(np.asarray, grads),
    )


def _port_model(reference, **kw):
    tcfg = dataclasses.replace(reference["tcfg"], **kw)
    params = moe_params_from_jax(reference["params"], tcfg, device="cpu")
    return tcfg, tmoe.build_moe(tcfg, params, trainable=True)


# -- gating ------------------------------------------------------------------

# id: (tokens, experts, k, capacity factor); the "overflow" cases drop
# choices, the "ample" ones give every expert room for every token
_GATING = {
    "k1_ample": (64, 4, 1, 4.0),
    "k1_overflow": (64, 4, 1, 0.5),
    "k2_ample": (64, 8, 2, 4.0),
    "k2_overflow": (96, 8, 2, 0.75),
}


@pytest.mark.parametrize("case", list(_GATING))
def test_top_k_gating_matches_reference(case):
    t, e, k, factor = _GATING[case]
    logits = np.random.default_rng(3).standard_normal((t, e)).astype(np.float32)
    cap = texp.expert_capacity(t, e, factor, k)
    assert cap == jexp.expert_capacity(t, e, factor, k)
    jd, jc, jaux = jexp.top_k_gating(jnp.asarray(logits), cap, k=k)
    td, tc, taux = texp.top_k_gating(torch.from_numpy(logits), cap, k=k)
    r = texp.route(torch.from_numpy(logits), cap, k=k)
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == case.endswith("overflow")
    # the routing is discrete: the same expert, slot and kept flag for every
    # (token, choice), so dispatch is equal element for element
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # combine holds the renormalised gates, which come from each side's
    # softmax: equal to a few f32 rounding steps of values at most 1
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=4 * F32_ULP)
    # aux: E * sum(frac_tokens * frac_probs), means of f32 values summed in
    # other orders
    assert abs(taux.item() - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_gating_respects_capacity_and_renormalises():
    t, e, k = 128, 8, 2
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal((t, e)).astype(np.float32))
    cap = texp.expert_capacity(t, e, 1.0, k)
    dispatch, combine, aux = texp.top_k_gating(logits, cap, k=k)
    r = texp.route(logits, cap, k=k)
    assert dispatch.sum(dim=0).max() <= 1  # no slot holds two tokens
    assert int(dispatch.sum()) == int(r.keep.sum())
    w = combine.sum(dim=(1, 2))
    kept_any = r.keep.any(dim=1)
    # weights sum to one over a token's kept choices (f32 division and sum:
    # within 2 ulps), and to zero for a token dropped everywhere
    assert torch.all((w[kept_any] - 1).abs() <= 2 * F32_ULP)
    assert torch.all(w[~kept_any] == 0)
    # a chosen expert is masked for the next pass, even where dropped
    assert torch.all(r.expert[:, 0] != r.expert[:, 1])
    assert aux.item() > 0


def test_argmax_ties_go_to_the_first_expert():
    # every expert equally likely: each pass takes the lowest index left
    logits = torch.zeros(6, 4)
    r = texp.route(logits, capacity=6, k=2)
    assert r.expert.tolist() == [[0, 1]] * 6
    assert r.slot.tolist() == [[i, i] for i in range(6)]
    jd, _, _ = jexp.top_k_gating(jnp.zeros((6, 4)), 6, k=2)
    td, _, _ = texp.top_k_gating(logits, 6, k=2)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# -- dense against indexed apply ----------------------------------------------


def _apply_both(t, e, d, k, factor, dtype, seed=5):
    """The dense and the indexed apply of the same routing and experts; the
    slabs each handed to the experts; the indexed side's sum of |w·y| per
    output (what bounds the rounding of the combine)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)).to(dtype)
    logits = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((e, d, d)) / np.sqrt(d)).astype(np.float32)).to(dtype)
    cap = texp.expert_capacity(t, e, factor, k)
    dispatch, combine, _ = texp.top_k_gating(logits, cap, k=k)
    r = texp.route(logits, cap, k=k)
    slabs = {}

    def experts(name):
        def fn(inp):
            slabs[name] = inp
            return torch.bmm(inp, w)
        return fn

    dense = texp.moe_apply_gspmd(x, dispatch, combine, experts("dense"))
    indexed = texp.moe_apply_indexed(x, r, experts("indexed"))
    y = torch.bmm(slabs["indexed"], w).reshape(e * cap, d).float()
    gathered = y[(r.expert * cap + r.slot).clamp(max=e * cap - 1)]  # (t, k, d)
    mag = (gathered * r.weight[..., None]).abs().sum(dim=1)
    return dense, indexed, slabs, mag, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2])
def test_indexed_apply_equals_dense(k, dtype):
    dense, indexed, slabs, mag, r = _apply_both(256, 8, 32, k, 1.0, dtype)
    assert (~r.keep).any()  # some choices are dropped
    # dispatch: each slot copies one token's row, or is zero; bit for bit
    assert torch.equal(slabs["dense"], slabs["indexed"])
    assert dense.dtype == indexed.dtype == dtype
    if k == 1:
        # one product per output on both sides, rounded once: bit for bit
        assert torch.equal(dense, indexed)
        return
    # k = 2: the indexed form rounds both products and adds; the GEMM may
    # fuse one into a multiply-add. Three roundings of 2^-24 at most, of
    # sum |w·y|: 2^-22 of it; a bf16 result adds one bf16 step (2^-7) of
    # itself
    tol = 2.0 ** -22 * mag
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * indexed.float().abs()
    assert torch.all((dense.float() - indexed.float()).abs() <= tol)


def test_indexed_apply_gradients_equal_dense():
    rng = np.random.default_rng(6)
    t, e, d, k = 128, 8, 16, 2
    x0 = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    lg0 = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((e, d, d)) / np.sqrt(d)).astype(np.float32))
    cap = texp.expert_capacity(t, e, 1.0, k)
    grads = {}
    for form in ("dense", "indexed"):
        x, lg = x0.clone().requires_grad_(), lg0.clone().requires_grad_()
        if form == "dense":
            dispatch, combine, aux = texp.top_k_gating(lg, cap, k=k)
            out = texp.moe_apply_gspmd(x, dispatch, combine, lambda s: torch.bmm(s, w))
        else:
            r = texp.route(lg, cap, k=k)
            out, aux = texp.moe_apply_indexed(x, r, lambda s: torch.bmm(s, w)), r.aux_loss
        ((out * torch.arange(d)).sum() + aux).backward()
        grads[form] = (x.grad, lg.grad)
    # the same function: gradients differ by f32 summation order only
    for got, want, what in zip(grads["indexed"], grads["dense"], ("x", "logits")):
        _close(got, want.numpy(), 1e-6, what)
    assert grads["indexed"][1].abs().max() > 0  # the router logits learn


def test_moe_dispatch_and_combine_at_one_rank_match_reference():
    rng = np.random.default_rng(7)
    t, e, d = 32, 4, 8
    x = rng.standard_normal((t, d)).astype(np.float32)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    w = (rng.standard_normal((e, d, d)) / np.sqrt(d)).astype(np.float32)
    cap = texp.expert_capacity(t, e, 1.0, 2)
    mesh = Mesh(np.array(jax.devices()[:1]), ("ep",))

    def local(x_, lg_, w_):
        dispatch, combine, _ = jexp.top_k_gating(lg_, cap, k=2)
        slabs = jexp.moe_dispatch(x_, dispatch, axis_name="ep")
        return slabs, jexp.moe_combine(slabs @ w_, combine, axis_name="ep")

    jslabs, jout = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P()), out_specs=(P(), P()), check_vma=False,
    ))(x, logits, w)
    dispatch, combine, _ = texp.top_k_gating(torch.from_numpy(logits), cap, k=2)
    slabs = texp.moe_dispatch(torch.from_numpy(x), dispatch)
    out = texp.moe_combine(slabs @ torch.from_numpy(w), combine)
    assert slabs.shape == (e, cap, d)
    # copies of input rows: equal
    np.testing.assert_array_equal(slabs.numpy(), np.asarray(jslabs))
    # f32 products and sums of two terms, summed in each framework's order
    _close(out, np.asarray(jout), 1e-6, "combine")


def test_moe_dispatch_over_more_ranks_waits_for_nccl(monkeypatch):
    """More ranks go through an all_to_all (tests/test_torch_collective.py
    runs 2 gloo ranks against the reference); experts that the ranks do not
    divide are refused before any exchange, as the reference refuses them."""
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="not divisible"):
        texp.moe_dispatch(torch.zeros(4, 2), torch.zeros(4, 3, 2), group=object())


# -- the model ---------------------------------------------------------------


def test_logits_and_aux_match_reference(reference):
    tcfg, model = _port_model(reference)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(reference["tokens"]).long())
    assert logits.shape == (2, 24, tcfg.vocab_size) and logits.dtype == torch.float32
    # f32 throughout, the same routing: the sums of the projections, the
    # experts and the head in other orders, within 1e-5 of the largest logit
    _close(logits, reference["logits"], 1e-5, "logits")
    # the sown router_aux_weight * aux of each layer: means of f32 values
    # in other orders
    np.testing.assert_allclose(aux.numpy(), reference["aux"], rtol=1e-5, atol=0)


def test_next_token_loss_and_aux_share_match_reference(reference):
    tcfg, model = _port_model(reference)
    tokens = torch.from_numpy(reference["tokens"]).long()
    with torch.no_grad():
        loss = tmoe.next_token_loss(tcfg, model, tokens)
        logits, aux = model(tokens)
        nll = nll_from_logits(logits, tokens)
        from_params = tmoe.next_token_loss(tcfg, dict(model.state_dict()), tokens)
    # f32 log-sum-exp over the same logits
    assert abs(loss.item() - reference["loss"]) <= 1e-5 * reference["loss"]
    assert from_params.item() == loss.item()
    # the loss is the NLL plus each layer's weighted aux loss, added in order
    share = loss.item() - nll.item()
    assert abs(share - aux.sum().item()) <= 1e-6
    # the reference's share: its loss less its NLL; a few percent of it
    assert 0 < share / loss.item() < 0.1
    assert abs(share - sum(reference["aux"])) <= 1e-5 * sum(reference["aux"])


def test_gradients_match_reference(reference):
    tcfg, model = _port_model(reference)
    loss = tmoe.next_token_loss(tcfg, model, torch.from_numpy(reference["tokens"]).long())
    loss.backward()
    want = moe_params_from_jax(reference["grads"], tcfg, device="cpu")
    for name, p in model.named_parameters():
        assert float(want[name].abs().max()) > 0, name
        # f32 on both sides, the same routing; the backward of attention,
        # the experts and the gating in other summation orders: within 1e-4
        # of each tensor's largest gradient (as the ViT's)
        _close(p.grad, want[name].numpy(), 1e-4, name)
    assert model.layer_0.moe.router.grad.abs().max() > 0


def test_remat_changes_nothing(reference):
    grads, losses = {}, {}
    for remat in (False, True):
        tcfg, model = _port_model(reference, remat=remat)
        loss = tmoe.next_token_loss(tcfg, model, torch.from_numpy(reference["tokens"]).long())
        loss.backward()
        losses[remat] = loss.item()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    # the recompute runs the same ops on the same input and routes every
    # token as the forward did: equal, bit for bit, on the CPU
    assert losses[True] == losses[False]
    for name, g in grads[False].items():
        assert torch.equal(grads[True][name], g), name


def test_param_tree_matches_reference():
    # tiny, and one layer at Mixtral-8x7B's width (shapes only)
    for jcfg, tcfg in (_configs(), (jmoe.MoEConfig.mixtral_8x7b(n_layers=1),
                                    tmoe.MoEConfig.mixtral_8x7b(n_layers=1))):
        want = {k: tuple(v.shape) for k, v in _flatten(_reference_shapes(jcfg)).items()}
        got = {k: tuple(v) for k, v in tmoe.param_shapes(tcfg).items()}
        assert got == want
    # the training cell's model: 4 layers of 1.451 B and 0.262 B of
    # embedding and head, 6.07 B in all
    shapes = tmoe.param_shapes(tmoe.MoEConfig.mixtral_8x7b(n_layers=4))
    per_layer = sum(v.numel() for k, v in shapes.items() if k.startswith("layer_0."))
    total = sum(v.numel() for v in shapes.values())
    assert (round(per_layer / 1e9, 3), round((total - 4 * per_layer) / 1e9, 3)) == (1.451, 0.262)
    assert round(total / 1e9, 2) == 6.07


def test_init_params_scales_like_flax():
    _, tcfg = _configs()
    params = tmoe.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    e, d, f = tcfg.n_experts, tcfg.dim, tcfg.intermediate
    # lecun normal over fan-in = every axis but the last (E·d for w_gate,
    # E·f for w_down, d for the router): the sample std within 3%
    for name, fan_in in (("layer_0.moe.w_gate", e * d), ("layer_0.moe.w_down", e * f),
                         ("layer_1.moe.router", d), ("layer_0.attn.wq.base.kernel", d)):
        std = params[name].std().item()
        assert abs(std * np.sqrt(fan_in) - 1) < 0.03, (name, std)
    assert torch.all(params["layer_0.ffn_norm"] == 1)


def test_moe_params_from_jax_rejects_bad_trees(reference):
    tcfg = reference["tcfg"]
    good = reference["params"]
    assert set(moe_params_from_jax(good, tcfg, device="cpu")) == set(tmoe.param_shapes(tcfg))

    def edited(edit):
        tree = jax.tree_util.tree_map(lambda a: a, good)
        edit(tree)
        return tree

    with pytest.raises(KeyError, match="missing"):
        moe_params_from_jax(edited(lambda t: t["layer_1"]["moe"].pop("router")), tcfg, device="cpu")
    with pytest.raises(KeyError, match="does not know"):
        moe_params_from_jax(edited(lambda t: t["layer_0"]["moe"].update(bias=np.zeros(4))),
                            tcfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        moe_params_from_jax(
            edited(lambda t: t["layer_0"]["moe"].update(w_up=np.zeros((4, 256, 128), np.float32))),
            tcfg, device="cpu")
    with pytest.raises(KeyError, match="does not know"):  # a Llama tree is not a MoE tree
        moe_params_from_jax(edited(lambda t: t["layer_0"].update(mlp={"w_up": np.zeros(1)})),
                            tcfg, device="cpu")


def test_mesh_is_refused():
    """The meshes the MoE over a mesh still refuses (tests/test_torch_moe_mesh.py
    and tests/test_torch_sp_models.py hold the ones it takes): ``pp > 1``
    (no model of the reference pipelines, ROADMAP kept item 33), before any
    group is looked at; ``sp > 1`` on a mesh not bound with its groups."""
    from ray_tpu_torch.parallel.mesh import make_mesh

    for axes, error, match in (({"pp": 2, "fsdp": 1}, NotImplementedError, "item 33"),
                               ({"sp": 2, "fsdp": 1}, ValueError, "form_groups")):
        with pytest.raises(error, match=match):
            tmoe.MoETransformer(tmoe.MoEConfig.tiny(), mesh=make_mesh(
                devices=["cpu"] * 2, **axes).bind(0))
