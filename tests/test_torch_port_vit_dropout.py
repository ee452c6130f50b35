"""ViT training with dropout and the FF-kernel path, and Swin's two forced
kernel routes, in the port against the JAX package.

Both sides start from one numpy-seeded reference-layout state_dict (the JAX
side through its ``torch_convert.convert_state_dict``), and the dropout
masks are made explicit on both: the JAX model's ``nn.Dropout`` calls take
them through ``flax.linen.intercept_methods`` (the golden script's
``jax_dropout_masks``), the port's through ``utils/weights.
supplied_dropout_masks``, in call order — so both sides must also call
dropout in the same order, at the same shapes and rates.  The JAX Pallas
kernels run in interpret mode, the port's ops on their plain versions.  A
tiny ViT (depth 2, dim 64, 2 heads, 17 tokens) at 5 images (no crop
packing on the JAX side: 5 is divisible by neither 2 nor 3): logits, loss
and every gradient of one train step to rtol 1e-3 per tensor (as
tests/test_torch_port_swin.py), the layer-level outputs and gradients to
1e-4 of the tensor's largest value.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.config import registry as jax_registry
from vision_transformers_tpu.models.vit import TransformerLayer as JaxLayer
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.models import layers
from vision_transformers_tpu_torch.models.swin import SwinConfig
from vision_transformers_tpu_torch.models.vit import ViTConfig
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.utils.weights import (seeded_dropout_masks,
                                                         seeded_state_dict,
                                                         seeded_train_batch,
                                                         state_dict_from_flax,
                                                         supplied_dropout_masks,
                                                         to_torch, vit_dropout_calls)
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH = dict(image_size=32, window_size=8, depth=2, dim=64, n_head=2, dim_ff=128,
            n_class=10)
SWIN = dict(image_size=[64, 64], n_class=10, depths=[2, 2, 2, 2], dims=[8, 16, 32, 64],
            dim_head=4, n_heads=[2, 4, 8, 16], dim_ffs=[32, 64, 128, 256], window_size=2)
IMAGES = 5


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_port_train_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_train_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_dropout_masks = _script().jax_dropout_masks


class forced:
    """The same attention impl (and FF-kernel switch) in both packages."""

    def __init__(self, name, ff_kernel=None):
        self.name, self.ff = name, ff_kernel

    def __enter__(self):
        jax_ops.set_attention_impl(self.name, interpret=self.name is not None)
        ops.set_attention_impl(self.name)
        jax_ops.set_ff_kernel(self.ff)
        ops.set_ff_kernel(self.ff)

    def __exit__(self, *exc):
        jax_ops.set_attention_impl(None)
        ops.set_attention_impl(None)
        jax_ops.set_ff_kernel(None)
        ops.set_ff_kernel(None)


class spy:
    """Counts the calls of ``ops.<name>`` (the models look it up per call)."""

    def __init__(self, monkeypatch, name):
        self.n, fn = 0, getattr(ops, name)

        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(ops, name, counted)


def close_grads(ours, theirs, rtol=1e-3):
    assert sorted(ours) == sorted(theirs)
    for k in sorted(ours):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=rtol, atol=1e-6, err_msg=k)


def train_step_both(cfg_jax, model, sd, batch, masks):
    """One train-step loss and gradients of both packages from the
    state_dict ``sd`` (which ``model`` holds) on ``batch``, each dropout
    taking the next of ``masks``; returns (port logits, JAX logits, port
    loss, JAX loss, port grads, JAX grads, the port's dropout calls)."""
    params = jax.tree.map(jnp.asarray, convert_state_dict(cfg_jax, sd))["params"]
    b = jax.tree.map(jnp.asarray, batch)

    def f(p):
        logits = cfg_jax.make().apply({"params": p}, b["image"], deterministic=False,
                                      rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_loss.mix_loss(logits, b["label1"], b["label2"], b["ratio"],
                                 eps=0.1), logits

    with jax_dropout_masks(masks) as jcalls:
        (loss_j, logits_j), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with supplied_dropout_masks(masks) as calls:
        logits = model.train()(tb["image"].permute(0, 3, 1, 2))
    loss = L.mix_loss(logits, tb["label1"].long(), tb["label2"].long(), tb["ratio"],
                      eps=0.1)
    loss.backward()
    assert calls == jcalls
    ours = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return (logits.detach().numpy(), np.asarray(logits_j), float(loss.detach()),
            float(loss_j), ours, state_dict_from_flax(jax.tree.map(np.asarray, g)), calls)


def port_vit(**kw):
    """(config, model, its seeded state_dict)."""
    cfg = ViTConfig(**ARCH, **kw)
    model = cfg.make()
    sd = seeded_state_dict(cfg, seed=0)
    model.load_state_dict(to_torch(sd), strict=True)
    return cfg, model, sd


def jax_vit(**kw):
    return jax_registry.build("model", {"type": "vit", **ARCH, **kw})


def masks_for(cfg, seed=1):
    shapes, rates = zip(*vit_dropout_calls(cfg, IMAGES))
    return seeded_dropout_masks(seed, shapes, rates)


# ---------------------------------------------------------------------------
# the tiny ViT, one train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rates", [dict(dropout=0.1, drop_ff=0.2),
                                   dict(dropout=0.1, drop_attn=0.2, drop_ff=0.2)],
                         ids=["dropout+drop_ff", "drop_attn-on-einsum"])
def test_train_step_with_dropout_matches_jax(monkeypatch, rates):
    """'fused' forced on both sides: with dropout and drop_ff the attention
    runs the packed-qkv op; with drop_attn > 0 both packages leave it for
    the einsum (vit.py:112-113), whose probabilities take a mask."""
    cfg, model, sd = port_vit(**rates)
    qkv = spy(monkeypatch, "fused_attention_qkv")
    with forced("fused"):
        logits, logits_j, loss, loss_j, ours, theirs, calls = train_step_both(
            jax_vit(**rates), model, sd, seeded_train_batch(3, IMAGES, 32, 10),
            masks_for(cfg))
    assert qkv.n == (0 if rates.get("drop_attn") else ARCH["depth"])
    assert len(calls) == 1 + ARCH["depth"] * (4 if rates.get("drop_attn") else 3)
    np.testing.assert_allclose(logits, logits_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    close_grads(ours, theirs)


def test_train_step_with_the_ff_kernel_matches_jax(monkeypatch):
    """'layer' forced with the FF kernel on, in both packages: the attention
    half and the FF half through their ops (no dropout: the layer kernels
    take none)."""
    _, model, sd = port_vit()
    ff = spy(monkeypatch, "fused_ff_layer")
    with forced("layer", ff_kernel=True):
        logits, logits_j, loss, loss_j, ours, theirs, _ = train_step_both(
            jax_vit(), model, sd, seeded_train_batch(4, IMAGES, 32, 10), [])
    assert ff.n == ARCH["depth"]
    np.testing.assert_allclose(logits, logits_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    close_grads(ours, theirs)


# ---------------------------------------------------------------------------
# one layer with explicit DropPath scales (the JAX rs_override)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["fused-dropout", "layer-ff-kernel"])
def test_layer_with_row_scales_matches_jax(path):
    dropping = path == "fused-dropout"
    rates = dict(dropout=0.1, drop_ff=0.2) if dropping else {}
    cfg, model, sd = port_vit(**rates)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(IMAGES, 17, ARCH["dim"])).astype(np.float32)
    rs1 = np.array([0.0, 1.25, 1.25, 0.0, 1.25], np.float32)
    rs2 = np.array([1.25, 0.0, 1.25, 1.25, 0.0], np.float32)
    calls = vit_dropout_calls(cfg, IMAGES)[1:4]  # one layer's
    masks = seeded_dropout_masks(2, *zip(*calls)) if calls else []
    lp = jax.tree.map(jnp.asarray,
                      convert_state_dict(jax_vit(**rates), sd)["params"]["layers_0"])
    layer = JaxLayer(ARCH["n_head"], ARCH["dim_ff"], rates.get("dropout", 0.0), 0.0,
                     rates.get("drop_ff", 0.0))

    def jax_fn(p, xx):
        out = layer.apply({"params": p}, xx, deterministic=False,
                          rs_override=(jnp.asarray(rs1), jnp.asarray(rs2)),
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out ** 2), out

    with forced("fused" if dropping else "layer", ff_kernel=not dropping):
        with jax_dropout_masks(masks):
            (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
                jax_fn, argnums=(0, 1), has_aux=True))(lp, jnp.asarray(x))
        tl = model.train().layers[0]
        xt = torch.from_numpy(x).requires_grad_()
        with supplied_dropout_masks(masks) as used:
            out = tl(xt, (torch.from_numpy(rs1), torch.from_numpy(rs2)))
        (out ** 2).sum().backward()
    assert len(used) == len(masks)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=5e-5, atol=5e-5)
    theirs = {k[len("layers.0."):]: v for k, v in state_dict_from_flax(
        {"patch_embedding": {"linear": {"kernel": np.zeros((1, 1, 1, 1)),
                                        "bias": np.zeros(1)}},
         "cls_token": 0, "pos_embed": 0, "norm": {"scale": 0, "bias": 0},
         "layers_0": jax.tree.map(np.asarray, jg)}).items() if k.startswith("layers.0.")}
    ours = {k: p.grad.numpy() for k, p in tl.named_parameters()}
    theirs["x"], ours["x"] = np.asarray(jgx), xt.grad.numpy()
    for k in sorted(ours):
        scale = max(float(np.abs(theirs[k]).max()), 1e-12)
        np.testing.assert_allclose(ours[k] / scale, theirs[k] / scale, atol=1e-4,
                                   rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# Swin's forced routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["fused", "layer-ff-kernel"])
def test_swin_forced_routes_match_jax(monkeypatch, route):
    """Swin's first stage (16x16 map, 2x2 windows packed in pairs: 32
    groups, m = 8 tokens), its shifted and its unshifted layer, forced to
    'fused' (the packed-qkv op with the grouped bias on the partitioned
    rows) and to 'layer' with the FF kernel (the FF op on the same rows):
    outputs and every gradient, x's included, against the JAX SwinLayer."""
    from vision_transformers_tpu.models.swin import SwinLayer as JaxSwinLayer

    cfg = SwinConfig(**SWIN)
    sd = seeded_state_dict(cfg, seed=0)
    model = cfg.make()
    model.load_state_dict(to_torch(sd), strict=True)
    params = convert_state_dict(jax_registry.build(
        "model", {"type": "swin_transformer", **SWIN}), sd)["params"]
    watched = spy(monkeypatch, "fused_attention_qkv" if route == "fused"
                  else "fused_ff_layer")
    x = np.random.default_rng(6).normal(size=(2, 16, 16, 8)).astype(np.float32)
    for i in range(2):
        layer = JaxSwinLayer(2, 4, 32, (16, 16), 2, shift=i % 2 == 0)
        lp = jax.tree.map(jnp.asarray, params[f"block1_{i}"])

        def jax_fn(p, xx):
            out = layer.apply({"params": p}, xx, deterministic=False)
            return jnp.sum(out ** 2), out

        with forced(route.split("-")[0], ff_kernel=route != "fused" or None):
            (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
                jax_fn, argnums=(0, 1), has_aux=True))(lp, jnp.asarray(x))
            tl = model.train().block1[i]
            xt = torch.from_numpy(x).requires_grad_()
            out = tl(xt)
            (out ** 2).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5)
        theirs = {k[len(f"block1.{i}."):]: v for k, v in state_dict_from_flax(
            {**params, f"block1_{i}": jax.tree.map(np.asarray, jg)}).items()
            if k.startswith(f"block1.{i}.")}
        ours = {k: p.grad.numpy() for k, p in tl.named_parameters()}
        theirs["x"], ours["x"] = np.asarray(jgx), xt.grad.numpy()
        close_grads(ours, theirs)
        assert np.abs(ours["attn.rel_pos.weight"]).max() > 0
    assert watched.n == 2


def test_swin_ff_kernel_tiles_the_row_scale():
    """On the partitioned rows the FF kernel takes each image's DropPath
    scale tiled over the window groups: the same layer output and gradients
    as the plain path's per-image scaling (both the port's plain versions)."""
    cfg = SwinConfig(**SWIN)
    model = cfg.make()
    model.load_state_dict(to_torch(seeded_state_dict(cfg, seed=0)), strict=True)
    tl = model.train().block1[0]
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 16, 16, 8))
                         .astype(np.float32))
    rs = (torch.tensor([1.25, 0.0]), torch.tensor([0.0, 1.25]))
    results = []
    for name, ff in (("einsum", None), ("layer", True)):
        ops.set_attention_impl(name)
        ops.set_ff_kernel(ff)
        try:
            xt = x.clone().requires_grad_()
            tl.zero_grad()
            out = tl(xt, rs)
            (out ** 2).sum().backward()
        finally:
            ops.set_attention_impl(None)
            ops.set_ff_kernel(None)
        results.append((out.detach(), xt.grad, tl.ff[0].weight.grad.clone()))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# dispatch and the mask draw
# ---------------------------------------------------------------------------


def test_dispatch_gates():
    """The JAX gates (ops/__init__.py:292-295): 'fused' from 32 rows and
    128 tokens; a force wins."""
    assert ops.attention_impl(31, seq=197, default="fused") == "einsum"
    assert ops.attention_impl(32, seq=127, default="fused") == "einsum"
    assert ops.attention_impl(32, seq=128, default="fused") == "fused"
    assert ops.attention_impl(128, seq=197, default="layer") == "layer"
    assert not ops.ff_kernel_enabled()
    ops.set_attention_impl("fused")
    try:
        assert ops.attention_impl(2, seq=17, default="layer") == "fused"
    finally:
        ops.set_attention_impl(None)
    ops.set_attention_impl("block")
    try:
        assert ops.attention_impl(2, seq=17, default="fused") == "block"
    finally:
        ops.set_attention_impl(None)
    ops.set_attention_impl("swin")
    try:
        assert ops.attention_impl(2, seq=17, default="fused") == "swin"
    finally:
        ops.set_attention_impl(None)
    with pytest.raises(ValueError):
        ops.set_attention_impl("map")


@pytest.mark.parametrize("rates,train_mode,want", [
    ({}, True, "fused_attention_layer"),
    (dict(dropout=0.1), True, "fused_attention_qkv"),
    (dict(drop_ff=0.1), True, "fused_attention_qkv"),
    (dict(drop_attn=0.1), True, None),
    (dict(dropout=0.1, drop_attn=0.1, drop_ff=0.1), False, "fused_attention_layer")],
    ids=["train-no-dropout", "train-dropout", "train-drop_ff", "train-drop_attn", "eval"])
def test_model_dispatch(monkeypatch, rates, train_mode, want):
    """A ViT with 145 tokens at 32 rows: in training the layer kernel only
    with all three rates 0, else the packed-qkv op — unless the attention
    probabilities drop (einsum); in eval the layer kernel whatever the
    rates."""
    model = ViTConfig(image_size=48, window_size=4, depth=1, dim=16, n_head=2,
                      dim_ff=32, n_class=3, **rates).make()
    names = ("fused_attention_layer", "fused_attention_qkv", "fused_transformer_layer")
    spies = {n: spy(monkeypatch, n) for n in names}
    x = torch.randn(32, 3, 48, 48, generator=torch.Generator().manual_seed(0))
    model.train(train_mode)
    with torch.no_grad():
        model(x, torch.Generator().manual_seed(1))
    assert {n: s.n for n, s in spies.items()} == {n: int(n == want) for n in names}


def test_dropout_draws_from_the_generator():
    """Keep rate, the inverted scaling, and every draw from the explicit
    generator: the same seed gives the same masks, the global RNG is not
    touched, rate 0 is the identity."""
    x = torch.ones(200, 500)
    state = torch.get_rng_state()
    a = layers.dropout(x, 0.25, torch.Generator().manual_seed(3))
    b = layers.dropout(x, 0.25, torch.Generator().manual_seed(3))
    c = layers.dropout(x, 0.25, torch.Generator().manual_seed(4))
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(torch.unique(a).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    keep = (a > 0).float().mean().item()
    assert abs(keep - 0.75) < 0.01  # 1e5 draws: ~7 standard deviations
    assert layers.dropout(x, 0.0, None) is x


