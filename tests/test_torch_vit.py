"""ray_tpu_torch's ViT against ray_tpu's, on the CPU.

The reference's parameter trees (the shapes of its ``init_params``,
unboxed) are filled with random values from a numpy seed, the zero-start
``head`` and ``cls_token`` and every bias included (at init every logit is
0, and a parity test there proves nothing), and carried into the port by
``vit_params_from_jax``. The reference runs its Pallas flash kernel in
interpret mode (JAX on the CPU), the port the plain versions of its kernels
(the tensors lie on the CPU). Two configs: ``tiny`` (head_dim 16) and a
2-layer one at head_dim 64, the head_dim of ViT-B/16 and of the card's
kernels.

Tolerances, relative to the largest |value| of the compared tensor: f32
logits 1e-5 (the same sums in another order); f32 gradients 1e-4 (the
backward subtracts nearly equal terms, LayerNorm's and softmax's, which
lifts the same rounding noise by about 10x); bf16 logits 3e-2 (each
projection, norm and residual add rounds to bf16, 8 bits, on both sides,
from f32 values that differ in their last bits: a few steps of 2^-8
through two blocks and the head).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import vit as jvit
from ray_tpu.parallel.sharding import unbox_params
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import _flatten, vit_params_from_jax
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import rmsnorm as trms

_CONFIGS = {
    "tiny_d16": dict(),
    "d64": dict(dim=128, n_heads=2, mlp_dim=256),
}


def _configs(name, jdtype=jnp.float32, tdtype=torch.float32, **kw):
    return (jvit.ViTConfig.tiny(dtype=jdtype, **_CONFIGS[name], **kw),
            tvit.ViTConfig.tiny(dtype=tdtype, **_CONFIGS[name], **kw))


def _random_tree(shapes, rng):
    """numpy values for a tree of the reference's shapes: LayerNorm scales
    in [0.5, 1.5], biases normal(0, 0.1), every other leaf (kernels,
    ``cls_token``, ``pos_embed``, ``head``) normal with variance 1/fan-in
    (fan-in: every axis but the last)."""
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = _random_tree(val, rng)
        elif key == "scale":
            out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
        elif key == "bias":
            out[key] = (0.1 * rng.standard_normal(val.shape)).astype(np.float32)
        else:
            fan_in = int(np.prod(val.shape[:-1]))
            out[key] = (rng.standard_normal(val.shape) / np.sqrt(fan_in)).astype(np.float32)
    return out


def _reference_params(jcfg, seed=8):
    shapes = jax.eval_shape(lambda r: unbox_params(jvit.init_params(jcfg, r)),
                            jax.random.PRNGKey(0))
    return _random_tree(shapes, np.random.default_rng(seed))


def _batch(cfg, n=2, seed=9):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    return images, rng.integers(0, cfg.num_classes, (n,)).astype(np.int32)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def test_forward_shape_and_dtype():
    cfg = tvit.ViTConfig.tiny()
    model = tvit.build_vit(cfg, tvit.init_params(cfg, device="cpu"))
    logits = model(torch.zeros(2, 32, 32, 3))
    assert logits.shape == (2, 10) and logits.dtype == torch.float32
    assert not logits.any()  # the head starts at zero, as the reference's


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_f32_logits_and_gradients_match_reference(name):
    jcfg, tcfg = _configs(name)
    assert tcfg.head_dim == (16 if name == "tiny_d16" else 64)
    jparams = _reference_params(jcfg)
    images, labels = _batch(jcfg)

    @jax.jit
    def reference(p):
        logits = jvit.ViT(jcfg).apply({"params": p}, jnp.asarray(images))
        grads = jax.grad(jvit.classification_loss, argnums=2)(
            jcfg, None, p, jnp.asarray(images), jnp.asarray(labels))
        loss = jvit.classification_loss(jcfg, None, p, jnp.asarray(images), jnp.asarray(labels))
        return logits, loss, grads

    jlogits, jloss, jgrads = reference(jparams)
    model = tvit.build_vit(tcfg, vit_params_from_jax(jparams, tcfg, device="cpu"))
    _close(model(torch.from_numpy(images)).detach(), jlogits, 1e-5, "logits")
    loss = tvit.classification_loss(tcfg, None, model, torch.from_numpy(images),
                                    torch.from_numpy(labels))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    loss.backward()
    want = vit_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tcfg, device="cpu")
    for pname, p in model.named_parameters():
        if pname.endswith("wk.bias"):
            # adds q.b to every score of a row, which softmax cancels: the
            # true gradient is 0, and both sides hold rounding noise
            scale = float(want[pname.replace("bias", "kernel")].abs().max())
            assert float(p.grad.abs().max()) <= 1e-5 * scale, pname
            continue
        assert float(want[pname].abs().max()) > 0, pname
        _close(p.grad, want[pname], 1e-4, pname)


def test_bf16_logits_match_reference():
    jcfg, tcfg = _configs("d64", jnp.bfloat16, torch.bfloat16)
    jparams = _reference_params(jcfg)
    images, _ = _batch(jcfg)
    jlogits = jax.jit(lambda p: jvit.ViT(jcfg).apply({"params": p}, jnp.asarray(images)))(jparams)
    model = tvit.build_vit(tcfg, vit_params_from_jax(jparams, tcfg, device="cpu"))
    with torch.no_grad():
        logits = model(torch.from_numpy(images))
    assert logits.dtype == torch.float32
    _close(logits, jlogits, 3e-2, "bf16 logits")


def _loss_and_grads(tcfg, params, images, labels, **kw):
    model = tvit.build_vit(tcfg, {k: v.clone() for k, v in params.items()})
    logits = model(torch.from_numpy(images), **kw)
    loss = F.cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_remat_matches_no_remat(dropout):
    """As the reference's test_remat_matches_no_remat, with gradients; with
    dropout the masks of one generator seed are the same under the
    recompute, so loss and gradients are too."""
    jcfg, _ = _configs("d64")
    params = vit_params_from_jax(_reference_params(jcfg), _configs("d64")[1], device="cpu")
    images, labels = _batch(jcfg)
    runs = {}
    for remat in (False, True):
        tcfg = _configs("d64", dropout=dropout, remat=remat)[1]
        kw = {}
        if dropout:
            kw = dict(deterministic=False, generator=torch.Generator().manual_seed(11))
        runs[remat] = _loss_and_grads(tcfg, params, images, labels, **kw)
    assert runs[True][0] == pytest.approx(runs[False][0], rel=1e-6)
    for name, g in runs[False][1].items():
        _close(runs[True][1][name], g, 1e-6, name)
    if dropout:
        # the masks are drawn and change the result: another seed moves it
        tcfg = _configs("d64", dropout=dropout)[1]
        other = _loss_and_grads(tcfg, params, images, labels, deterministic=False,
                                generator=torch.Generator().manual_seed(12))
        plain = _loss_and_grads(tcfg, params, images, labels)
        assert len({runs[False][0], other[0], plain[0]}) == 3


def test_dropout_needs_a_generator():
    cfg = tvit.ViTConfig.tiny(dropout=0.1)
    model = tvit.build_vit(cfg, tvit.init_params(cfg, device="cpu"))
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros(1, 32, 32, 3), deterministic=False)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gelu_and_layernorm_are_flax_s(dtype):
    """GELU is the tanh form and LayerNorm's eps is 1e-6 with f32
    statistics: both held to flax's ops, and shown to differ from torch's
    defaults (erf, 1e-5) on these inputs."""
    import flax.linen as nn

    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    xt = torch.from_numpy(x).to(tdt)
    got = tvit.gelu(xt)
    want = np.asarray(nn.gelu(jnp.asarray(x, jdt)), np.float32)
    ulp = 1e-6 if dtype == "f32" else 2.0 ** -7
    assert np.abs(got.float().numpy() - want).max() <= ulp * np.abs(want).max()
    assert (F.gelu(xt.float()) - tvit.gelu(xt.float())).abs().max() > 1e-4

    # low-variance rows, where eps 1e-6 and 1e-5 part
    small = (1e-3 * x).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 64).astype(np.float32), rng.standard_normal(64).astype(
        np.float32)
    ln = tvit.LayerNorm(64, torch.float32, tdt)
    ln.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    xs = torch.from_numpy(small).to(tdt)
    got = ln(xs).detach()
    assert got.dtype == tdt
    want = np.asarray(nn.LayerNorm(dtype=jdt).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(small, jdt)), np.float32)
    tol = 1e-5 if dtype == "f32" else 2.0 ** -7
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()
    eps5 = F.layer_norm(xs.float(), (64,), torch.from_numpy(scale), torch.from_numpy(bias), 1e-5)
    assert (eps5 - got.float()).abs().max() > 10 * tol * np.abs(want).max()


def test_mesh_is_not_ported():
    """The meshes the ViT over a mesh still refuses (tests/test_torch_vit_mesh.py
    holds the ones it takes): ``sp > 1``, ROADMAP item A.12, and ``pp > 1``,
    A.5.4, at the model and at the loss."""
    from ray_tpu_torch.parallel.mesh import make_mesh

    cfg = tvit.ViTConfig.tiny()
    params = tvit.init_params(cfg, device="cpu")
    for axes, item in (({"sp": 2, "fsdp": 1}, "item A.12"), ({"pp": 2, "fsdp": 1}, "A.5.4")):
        mesh = make_mesh(devices=["cpu"] * 2, **axes).bind(0)
        with pytest.raises(NotImplementedError, match=item):
            tvit.ViT(cfg, mesh=mesh)
        with pytest.raises(NotImplementedError, match=item):
            tvit.classification_loss(cfg, mesh, params, torch.zeros(1, 32, 32, 3),
                                     torch.zeros(1, dtype=torch.long))


def test_init_params_follow_the_reference_initialisers():
    cfg = tvit.ViTConfig.tiny()
    params = tvit.init_params(cfg, device="cpu")
    jshapes = jax.eval_shape(lambda r: unbox_params(jvit.init_params(
        jvit.ViTConfig.tiny(), r)), jax.random.PRNGKey(0))
    want = vit_params_from_jax(_random_tree(jshapes, np.random.default_rng(0)), cfg, device="cpu")
    assert {k: v.shape for k, v in params.items()} == {k: v.shape for k, v in want.items()}
    assert not params["head"].any() and not params["cls_token"].any()
    assert not params["layer_0.wq.bias"].any() and bool((params["ln_final.scale"] == 1).all())
    # xavier uniform: |w| <= sqrt(6 / (fan_in + fan_out))
    assert params["layer_0.fc1.kernel"].abs().max() <= (6 / (64 + 128)) ** 0.5
    assert 0.015 < params["pos_embed"].std().item() < 0.025


def test_converter_rejects_missing_and_unknown_keys():
    jcfg, tcfg = _configs("tiny_d16")
    jparams = _reference_params(jcfg)
    with pytest.raises(KeyError, match="does not know"):
        vit_params_from_jax(dict(jparams, extra=np.zeros(3, np.float32)), tcfg, device="cpu")
    short = {k: v for k, v in jparams.items() if k != "pos_embed"}
    with pytest.raises(KeyError, match="missing"):
        vit_params_from_jax(short, tcfg, device="cpu")
    layer = dict(jparams["layer_0"], wq={"kernel": jparams["layer_0"]["wq"]["kernel"]})
    with pytest.raises(KeyError, match="layer_0.wq.bias"):
        vit_params_from_jax(dict(jparams, layer_0=layer), tcfg, device="cpu")
    assert sorted(_flatten(jparams)) == sorted(tvit.param_shapes(tcfg))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_train_step_calls_each_attention_wrapper_per_layer(monkeypatch, remat):
    """The per-step launch counts chip_smoke.py demands on the card: one
    forward, dQ and dK/dV call a layer, the forward twice with remat, no
    RMSNorm."""
    calls = dict.fromkeys(("rmsnorm_fwd", "flash_attention_fwd", "flash_bwd_dq",
                           "flash_bwd_dkv"), 0)
    for module, name in ((trms, "rmsnorm_fwd"), (tfa, "flash_attention_fwd"),
                         (tfa, "flash_bwd_dq"), (tfa, "flash_bwd_dkv")):
        real = getattr(module, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, spy)
    cfg = tvit.ViTConfig.tiny(remat=remat)
    model = tvit.build_vit(cfg, tvit.init_params(cfg, device="cpu"))
    tvit.classification_loss(cfg, None, model, torch.zeros(2, 32, 32, 3),
                             torch.tensor([1, 2])).backward()
    n = cfg.n_layers
    assert calls == {"rmsnorm_fwd": 0, "flash_attention_fwd": n * (2 if remat else 1),
                     "flash_bwd_dq": n, "flash_bwd_dkv": n}
