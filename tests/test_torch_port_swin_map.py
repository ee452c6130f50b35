"""Swin's map-resident whole-layer path ('swin'), Swin training with dropout
and the dispatch's environment forces in the port, against the JAX package.

- A tiny Swin (image 64, window 2, depths 2·4, dims 8-64, dim_head 4, the
  model of tests/test_torch_port_swin.py) under ``set_attention_impl("swin")``
  in both packages (the JAX kernel in interpret mode, the port's op on its
  plain version): every layer runs ``fused_swin_layer``; logits to atol
  1e-5, one drop_path-0 train step's loss to rtol 1e-5 and every gradient
  to rtol 1e-3 per tensor (as the other tiny-Swin tests).
- The tiny Swin trained with drop_attn 0.1 and drop_ff 0.2, on the default
  dispatch and under the 'swin' force (both take the two residual branches
  with einsum attention, as in JAX): every dropout mask supplied on both
  sides in ``swin_dropout_calls`` order (JAX through
  ``flax.linen.intercept_methods``), the calls' shapes and rates equal;
  logits to 1e-4, loss to rtol 1e-5, gradients to rtol 1e-3.
- The dispatch: ``attention_impl``, ``halo_impl`` and ``sra_impl`` against
  the JAX functions under every combination of ``VTX_ATTN_IMPL``,
  ``VTX_FUSED_ATTENTION``, ``VTX_HALO_IMPL``, ``VTX_SRA_IMPL`` and the
  ``set_*`` forces (JAX asked as on its accelerator, its TPU-only clauses
  excepted), and which op each of the five models calls under 'swin'.
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
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.models import halo as port_halo
from vision_transformers_tpu_torch.models.halo import HaloConfig
from vision_transformers_tpu_torch.models.pvt import PVTConfig
from vision_transformers_tpu_torch.models.swin import SwinConfig
from vision_transformers_tpu_torch.models.twins import TwinsConfig
from vision_transformers_tpu_torch.models.vit import ViTConfig
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.utils.weights import (seeded_dropout_masks,
                                                         seeded_state_dict,
                                                         seeded_train_batch,
                                                         state_dict_from_flax,
                                                         supplied_dropout_masks,
                                                         swin_dropout_calls, to_torch)
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SWIN = dict(image_size=[64, 64], n_class=10, depths=[2, 2, 2, 2], dims=[8, 16, 32, 64],
            dim_head=4, n_heads=[2, 4, 8, 16], dim_ffs=[32, 64, 128, 256], window_size=2)
IMAGES = 2


def _jax_dropout_masks():
    path = os.path.join(ROOT, "scripts", "make_torch_port_train_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_train_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.jax_dropout_masks


jax_dropout_masks = _jax_dropout_masks()


class forced:
    """One attention impl in both packages (the JAX kernels interpreted)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        jax_ops.set_attention_impl(self.name, interpret=self.name is not None)
        ops.set_attention_impl(self.name)

    def __exit__(self, *exc):
        jax_ops.set_attention_impl(None)
        ops.set_attention_impl(None)


class spy:
    """Counts the calls of ``<module>.<name>`` (looked up per call)."""

    def __init__(self, monkeypatch, name, module=ops):
        self.n, fn = 0, getattr(module, name)

        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)


def swin_both(**kw):
    """(the JAX config, the port model, the seeded state_dict it holds)."""
    cfg = SwinConfig(**SWIN, **kw)
    sd = seeded_state_dict(cfg, seed=0)
    model = cfg.make()
    model.load_state_dict(to_torch(sd), strict=True)
    return jax_registry.build("model", {"type": "swin_transformer", **SWIN, **kw}), model, sd


def train_step_both(cfg_jax, model, sd, batch, masks):
    """One train step in both packages from ``sd`` on ``batch``, each dropout
    taking the next of ``masks``: (port logits, JAX logits, port loss, JAX
    loss, port grads, JAX grads); the two packages' dropout calls equal."""
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
    assert calls == jcalls and len(calls) == len(masks)
    ours = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return (logits.detach().numpy(), np.asarray(logits_j), float(loss.detach()),
            float(loss_j), ours, state_dict_from_flax(jax.tree.map(np.asarray, g)))


def close_grads(ours, theirs, rtol=1e-3):
    assert sorted(ours) == sorted(theirs)
    for k in sorted(ours):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=rtol, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the tiny Swin under 'swin'
# ---------------------------------------------------------------------------


def test_swin_route_logits_match_jax(monkeypatch):
    cfg_jax, model, sd = swin_both()
    x = seeded_train_batch(5, IMAGES, 64, 10)["image"]
    variables = jax.tree.map(jnp.asarray, convert_state_dict(cfg_jax, sd))
    layers = spy(monkeypatch, "fused_swin_layer")
    with forced("swin"):
        theirs = np.asarray(cfg_jax.make().apply(variables, jnp.asarray(x)))
        with torch.no_grad():
            ours = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert layers.n == sum(SWIN["depths"])
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def test_swin_route_train_step_matches_jax(monkeypatch):
    cfg_jax, model, sd = swin_both()
    layers = spy(monkeypatch, "fused_swin_layer")
    with forced("swin"):
        logits, logits_j, loss, loss_j, ours, theirs = train_step_both(
            cfg_jax, model, sd, seeded_train_batch(6, IMAGES, 64, 10), [])
    assert layers.n == sum(SWIN["depths"])
    np.testing.assert_allclose(logits, logits_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    close_grads(ours, theirs)
    assert np.abs(ours["block1.0.attn.rel_pos.weight"]).max() > 0


# ---------------------------------------------------------------------------
# Swin trained with dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [None, "swin"], ids=["default", "swin"])
def test_train_step_with_dropout_matches_jax(monkeypatch, name):
    rates = dict(drop_attn=0.1, drop_ff=0.2)
    cfg_jax, model, sd = swin_both(**rates)
    kernels = [spy(monkeypatch, n) for n in ("fused_swin_layer", "fused_transformer_layer",
                                             "fused_attention_layer")]
    shapes, mask_rates = zip(*swin_dropout_calls(SwinConfig(**SWIN, **rates), IMAGES))
    masks = seeded_dropout_masks(3, shapes, mask_rates)
    assert len(masks) == 2 * sum(SWIN["depths"])
    with forced(name):
        logits, logits_j, loss, loss_j, ours, theirs = train_step_both(
            cfg_jax, model, sd, seeded_train_batch(7, IMAGES, 64, 10), masks)
    assert [k.n for k in kernels] == [0, 0, 0]  # two branches, einsum attention
    np.testing.assert_allclose(logits, logits_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    close_grads(ours, theirs)


def test_dropout_calls_follow_the_model():
    """``swin_dropout_calls`` lists, in order, the dropout calls a training
    forward of the port makes (drop_ff alone: only the FF hidden)."""
    for rates in (dict(drop_attn=0.1, drop_ff=0.2), dict(drop_ff=0.3)):
        cfg = SwinConfig(**SWIN, **rates)
        want = swin_dropout_calls(cfg, 3)
        masks = seeded_dropout_masks(0, *zip(*want))
        with supplied_dropout_masks(masks) as calls, torch.no_grad():
            cfg.make().train()(torch.zeros(3, 3, 64, 64), torch.Generator().manual_seed(0))
        assert calls == want


# ---------------------------------------------------------------------------
# the dispatch against the JAX package's
# ---------------------------------------------------------------------------


ATTN_ENVS = [None, "einsum", "fused", "block", "layer", "layer1", "swin", "unknown"]
SITES = [(2, 17, "fused"), (64, 197, "fused"), (64, 49, "fused"), (2, 197, "layer"),
         (64, 197, "layer"), (64, 98, "layer1"), (16, 98, "layer1"), (64, 4, "einsum")]
GEOMETRIES = [(2, 1), (8, 2), (4, 3), (7, 3)]


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("attn_env", ATTN_ENVS, ids=lambda v: v or "unset")
def test_dispatch_follows_the_jax_forces(monkeypatch, attn_env):
    """For each ``VTX_ATTN_IMPL``, under every ``VTX_FUSED_ATTENTION`` and
    global force: the attention impl at several sites; the Halo impl under
    each ``VTX_HALO_IMPL`` (also given as ``set_halo_impl``); the reduced-kv
    impl under each ``VTX_SRA_IMPL`` (also as ``set_sra_impl``) — all as the
    JAX functions answer on their accelerator.  Excepted, as documented in
    the port: a 'direct' Halo force where 2·halo > window raises in the port
    (JAX returns 'direct'); JAX's 8 | window and n_kv < 8 clauses (TPU
    alignment and a TPU compiler fault) are switched off on the JAX side."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_ops, "_INTERPRET", True)
    _set(monkeypatch, "VTX_ATTN_IMPL", attn_env)
    checked = 0
    try:
        for fused_env in (None, "0", "1"):
            _set(monkeypatch, "VTX_FUSED_ATTENTION", fused_env)
            for force in (None, "einsum", "fused", "swin"):
                monkeypatch.setattr(jax_ops, "_FORCED", force)
                ops.set_attention_impl(force)
                for site in SITES:
                    assert ops.attention_impl(*site) == jax_ops.attention_impl(*site), \
                        (fused_env, force, site)
                for halo_env in (None, "layer", "direct", "gather", "einsum"):
                    for via_set in (False, True):
                        for window, halo in GEOMETRIES:
                            _set(monkeypatch, "VTX_HALO_IMPL", halo_env)
                            theirs = jax_ops.halo_impl(window, halo)
                            if via_set:  # the port's own force instead of the env's
                                monkeypatch.delenv("VTX_HALO_IMPL", raising=False)
                                ops.set_halo_impl(halo_env)
                            if theirs == "direct" and 2 * halo > window:
                                with pytest.raises(NotImplementedError):
                                    ops.halo_impl(window, halo)
                            else:
                                assert ops.halo_impl(window, halo) == theirs, \
                                    (fused_env, force, halo_env, via_set, window, halo)
                            ops.set_halo_impl(None)
                            checked += 1
                for sra_env in (None, "einsum", "fused"):
                    for via_set in (False, True):
                        _set(monkeypatch, "VTX_SRA_IMPL", sra_env)
                        theirs = jax_ops.sra_attention_impl(n_kv=49)
                        if via_set:
                            monkeypatch.delenv("VTX_SRA_IMPL", raising=False)
                            ops.set_sra_impl(sra_env)
                        assert ops.sra_impl(49) == theirs, (fused_env, force, sra_env)
                        ops.set_sra_impl(None)
                        checked += 1
    finally:
        ops.set_attention_impl(None)
        ops.set_halo_impl(None)
        ops.set_sra_impl(None)
    assert checked == 3 * 4 * (5 * 2 * len(GEOMETRIES) + 3 * 2)


def test_env_force_reaches_the_swin_layers(monkeypatch):
    """``VTX_ATTN_IMPL=swin`` alone (no set_attention_impl) takes every Swin
    layer to ``fused_swin_layer``; a ``set_attention_impl`` force wins."""
    monkeypatch.setenv("VTX_ATTN_IMPL", "swin")
    layers = spy(monkeypatch, "fused_swin_layer")
    model = SwinConfig(**SWIN).make().eval()
    with torch.no_grad():
        model(torch.zeros(2, 3, 64, 64))
    assert layers.n == sum(SWIN["depths"])
    ops.set_attention_impl("einsum")
    try:
        with torch.no_grad():
            model(torch.zeros(2, 3, 64, 64))
    finally:
        ops.set_attention_impl(None)
    assert layers.n == sum(SWIN["depths"])


MODELS = {
    "vit": (ViTConfig(image_size=32, window_size=8, depth=2, dim=64, n_head=2, dim_ff=128,
                      n_class=10), 32, {}),
    "swin": (SwinConfig(**SWIN), 64, {"fused_swin_layer": 8}),
    "twins": (TwinsConfig(n_class=10, depths=[1, 1, 1, 1], dims=[16, 32, 64, 128],
                          dim_head=8, n_heads=[2, 4, 8, 16], dim_ffs=[32, 64, 128, 256],
                          window_size=2), 64, {}),
    "halo": (HaloConfig(image_size=64, n_class=10, depths=[1, 1, 1, 1],
                        dims=[16, 32, 64, 128], dim_head=8, n_heads=[2, 4, 8, 16],
                        dim_ffs=[32, 64, 128, 256], window_size=2, halo_size=1), 64,
             {"fused_halo_layer": 4}),
    "pvt": (PVTConfig(image_size=32, n_class=10, depths=[1, 1, 1, 1],
                      patch_embed_dims=[16, 32, 64, 128], n_heads=[1, 2, 4, 8],
                      dim_ffs=[32, 64, 128, 256], reductions=[4, 2, 2, 1]), 32, {}),
}
OPS = ("fused_attention_layer", "fused_transformer_layer", "fused_attention_qkv",
       "fused_attention_block", "fused_ff_layer", "fused_swin_layer", "fused_attention",
       "halo_attention", "halo_attention_direct")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_under_the_swin_force(monkeypatch, name):
    """Under 'swin', as in JAX: ViT's layers take the two branches with
    einsum attention (vit.py:111-113, 234-237), Twins' local attention
    einsum (twins.py:224-227) and the reduced-kv attention einsum
    (sra_attention_impl reads only an einsum / fused force), Halo its
    default whole-layer op (halo_impl reads only an einsum force), Swin the
    map-resident layer in every layer — in training (rows < 32 would not
    matter: a force wins)."""
    cfg, size, want = MODELS[name]
    spies = {n: spy(monkeypatch, n) for n in OPS}
    spies["fused_halo_layer"] = spy(monkeypatch, "fused_halo_layer", port_halo)
    ops.set_attention_impl("swin")
    try:
        model = cfg.make().train()
        out = model(torch.zeros(2, 3, size, size), torch.Generator().manual_seed(0))
    finally:
        ops.set_attention_impl(None)
    assert out.shape == (2, 10) and torch.isfinite(out).all()
    assert {n: s.n for n, s in spies.items()} == {n: want.get(n, 0) for n in spies}
