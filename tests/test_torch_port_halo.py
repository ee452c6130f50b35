"""The port's Halo (vision_transformers_tpu_torch/models/halo.py) against the
JAX package's, from one numpy-seeded reference-layout state_dict: the JAX
side builds its params through its own ``torch_convert.convert_state_dict``,
the port loads the same dict with ``load_state_dict(strict=True)``.

Two tiny Halos: image 64, window 2, halo 1 (2·halo = window; stage maps
16 / 8 / 4 / 2, the last one window), depths 1·4, dims 16-128, dim_head 8,
as tests/test_pvt_twins_halo.py:166-173; and image 128 with window 4, halo 2.
The port's three paths (``einsum``, ``layer``, ``direct``; plain versions on
the CPU) are held to the JAX Halo forced to its whole-layer kernel in
interpret mode: logits to atol 1e-5.  One train-step gradient (drop_path 0,
and drop_path 0.5 with the same per-sample scales handed to both packages)
is held to the JAX Halo's einsum path (which tests/test_fused_halo_layer.py
holds equal to the layer kernel) at rtol 1e-3 per tensor,
relative-position tables included.  Then the plumbing: the static index,
the neighbourhoods, the weights' round trip, the reference ``.pt``, the wd
mask, the dispatch and the conf.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.config import registry as jax_registry
from vision_transformers_tpu.models import halo as jax_halo
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.train.optim import wd_mask as jax_wd_mask
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.models import halo as port_halo
from vision_transformers_tpu_torch.models.halo import HaloConfig
from vision_transformers_tpu_torch.models.swin import SwinConfig
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.train.optim import wd_mask
from vision_transformers_tpu_torch.utils.weights import (load_checkpoint,
                                                         seeded_state_dict,
                                                         seeded_train_batch,
                                                         state_dict_from_flax,
                                                         to_torch)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = dict(image_size=64, n_class=10, depths=[1, 1, 1, 1], dims=[16, 32, 64, 128],
            dim_head=8, n_heads=[2, 4, 8, 16], dim_ffs=[32, 64, 128, 256], window_size=2,
            halo_size=1)
TINY_W4 = {**TINY, "image_size": 128, "window_size": 4, "halo_size": 2}
PATHS = ["einsum", "layer", "direct"]


def jax_cfg(arch, **kw):
    return jax_registry.build("model", {"type": "halo_transformer", **arch, **kw})


def port_model(arch, sd, **kw):
    model = HaloConfig(**{**arch, **kw}).make()
    model.load_state_dict(to_torch(sd), strict=True)
    return model


class halo_path:
    """Force one Halo path in the port."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        ops.set_halo_impl(self.name)

    def __exit__(self, *exc):
        ops.set_halo_impl(None)


def jax_layer_logits(arch, sd, x):
    """The JAX Halo forced to its whole-layer kernel, interpreted."""
    cfg = jax_cfg(arch)
    variables = jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))
    jax_ops.set_attention_impl("layer", interpret=True)
    try:
        return np.asarray(jax.jit(cfg.make().apply)(variables, jnp.asarray(x)))
    finally:
        jax_ops.set_attention_impl(None)


@pytest.fixture(scope="module")
def tiny():
    sd = seeded_state_dict(HaloConfig(**TINY), seed=0)
    batch = seeded_train_batch(5, 2, 64, 10)
    return sd, batch, jax_layer_logits(TINY, sd, batch["image"])


@pytest.mark.parametrize("path", PATHS)
def test_logits_match_jax(tiny, path):
    sd, batch, theirs = tiny
    model = port_model(TINY, sd).eval()
    with halo_path(path), torch.no_grad():
        ours = model(torch.from_numpy(batch["image"]).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def test_logits_match_jax_window4_halo2():
    sd = seeded_state_dict(HaloConfig(**TINY_W4), seed=1)
    x = seeded_train_batch(6, 2, 128, 10)["image"]
    theirs = jax_layer_logits(TINY_W4, sd, x)
    with torch.no_grad():  # the default path: 'layer'
        ours = port_model(TINY_W4, sd).eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)


def jax_grads(arch, sd, batch, drop_path, scales=None):
    """(loss, state_dict-keyed grads) of the JAX Halo's einsum path; with
    ``scales`` each DropPath draw takes the next given [b] scale instead."""
    cfg = jax_cfg(arch, drop_path=drop_path)
    params = jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))["params"]
    b = jax.tree.map(jnp.asarray, batch)

    def f(p):
        logits = cfg.make().apply({"params": p}, b["image"], deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_loss.mix_loss(logits, b["label1"], b["label2"], b["ratio"], eps=0.1)

    drop_path_fn = jax_halo.drop_path_fn
    if scales is not None:  # the einsum path's two draws per layer: attn, then ff
        it = iter(jnp.asarray(s) for s in scales)
        jax_halo.drop_path_fn = lambda y, rate, rng, _: y * next(it)[:, None, None, None]
    try:
        loss, g = jax.jit(jax.value_and_grad(f))(params)
    finally:
        jax_halo.drop_path_fn = drop_path_fn
    return float(loss), state_dict_from_flax(jax.tree.map(np.asarray, g))


def port_grads(arch, sd, batch, path, drop_path=0.0, scales=None):
    model = port_model(arch, sd, drop_path=drop_path).train()
    if scales is not None:
        pairs = [(torch.from_numpy(a), torch.from_numpy(f))
                 for a, f in zip(scales[::2], scales[1::2])]
        model.draw_drop_path = lambda b, generator=None: pairs
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with halo_path(path):
        logits = model(tb["image"].permute(0, 3, 1, 2))
        loss = L.mix_loss(logits, tb["label1"].long(), tb["label2"].long(), tb["ratio"],
                          eps=0.1)
        loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in model.named_parameters()}


def assert_grads_match(ours, theirs):
    (loss, g), (loss_j, g_j) = ours, theirs
    assert sorted(g) == sorted(g_j)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    for k in sorted(g):
        np.testing.assert_allclose(g[k], g_j[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert all(np.abs(g[k]).max() > 0 for k in g if "rel_pos" in k)


@pytest.fixture(scope="module")
def tiny_grads(tiny):
    sd, batch, _ = tiny
    return jax_grads(TINY, sd, batch, 0.0)


@pytest.mark.parametrize("path", PATHS)
def test_train_step_grads_match_jax(tiny, tiny_grads, path):
    sd, batch, _ = tiny
    assert_grads_match(port_grads(TINY, sd, batch, path), tiny_grads)


def test_drop_path_scales_passed_explicitly_match_jax(tiny):
    """drop_path 0.5: the same per-sample scales (two per layer, some
    samples dropped) in both packages give the same loss and gradients
    through the whole-layer op's row scales."""
    sd, batch, _ = tiny
    # per layer (attn, ff); each attention branch keeps one sample, so every
    # relative-position table gets a gradient
    scales = [np.array(v, np.float32) for v in
              ([0, 2], [2, 2], [2, 0], [0, 0], [2, 2], [0, 2], [0, 2], [2, 0])]
    theirs = jax_grads(TINY, sd, batch, 0.5, scales)
    assert_grads_match(port_grads(TINY, sd, batch, "layer", 0.5, scales), theirs)


def test_drop_path_draws_two_scales_per_layer_at_one_rate():
    """In training each layer draws independent (rs_attn, rs_ff) at the same
    rate (no ramp) from the generator it is given."""
    model = HaloConfig(**{**TINY, "drop_path": 0.5}).make()
    assert model.drop_path_rates == [0.5] * 4
    draws = model.draw_drop_path(64, torch.Generator().manual_seed(0))
    a, f = draws[0]
    assert not torch.equal(a, f)
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    again = model.draw_drop_path(64, torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for (x, _), (y, _) in zip(draws, again))
    assert HaloConfig(**TINY).make().draw_drop_path(4) == [(None, None)] * 4


@pytest.mark.parametrize("window,halo", [(2, 1), (4, 1), (4, 2), (8, 2), (8, 3), (7, 3)])
def test_static_index_equals_jax(window, halo):
    ours, n_ours = port_halo.halo_position_index(window, halo)
    theirs, n_theirs = jax_halo.halo_position_index(window, halo)
    np.testing.assert_array_equal(ours, theirs)
    assert n_ours == n_theirs


@pytest.mark.parametrize("window,halo,H,W", [(8, 2, 16, 16), (4, 1, 8, 12), (4, 2, 4, 4)])
def test_neighborhoods_equal_jax(window, halo, H, W):
    x = np.random.default_rng(0).normal(size=(2, H, W, 3)).astype(np.float32)
    ours = port_halo.halo_neighborhoods(torch.from_numpy(x), window, halo).numpy()
    theirs = np.asarray(jax_halo.halo_neighborhoods(jnp.asarray(x), window, halo))
    np.testing.assert_array_equal(ours, theirs)


def test_state_dict_round_trip_through_jax_params():
    """Seeded Halo-S state_dict → the JAX package's params → back is the
    identity, key for key, and loads strictly into the port's Halo-S."""
    arch = HaloConfig()
    sd = seeded_state_dict(arch, seed=3)
    params = convert_state_dict(jax_registry.build(
        "model", {"type": "halo_transformer"}), sd)["params"]
    assert "embed1" in params and "final_norm" in params
    back = state_dict_from_flax(params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    arch.make().load_state_dict(to_torch(sd), strict=True)
    assert np.abs(sd["block3.4.attn.rel_pos.weight"]).max() > 0  # the tests see the bias


def test_weights_routing_tells_the_families_apart():
    """A Halo tree has ``final_norm`` too: it goes to the Halo conversion,
    a Swin tree to the Swin one; ``seeded_state_dict`` follows the config's
    type, not its fields (HaloConfig has ``depths`` as SwinConfig does)."""
    swin = SwinConfig(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), dim_head=4,
                      n_heads=(2, 4, 8, 16), dim_ffs=(16, 32, 64, 128),
                      image_size=(28, 28))
    swin_sd = seeded_state_dict(swin, 0)
    halo_sd = seeded_state_dict(HaloConfig(**TINY), 0)
    assert "patch_embedding.linear.weight" in swin_sd and "block1.0.linear.weight" in halo_sd
    assert halo_sd["block2.0.linear.weight"].shape == (32, 16 * 4)
    swin_params = convert_state_dict(jax_registry.build(
        "model", {"type": "swin_transformer", **{k: list(v) if isinstance(v, tuple) else v
                                                 for k, v in vars(swin).items()}}),
        swin_sd)["params"]
    halo_params = convert_state_dict(jax_cfg(TINY), halo_sd)["params"]
    assert sorted(state_dict_from_flax(swin_params)) == sorted(swin_sd)
    assert sorted(state_dict_from_flax(halo_params)) == sorted(halo_sd)


def test_checkpoint_drops_reference_buffers(tiny, tmp_path):
    """A reference .pt carries each layer's ``attn.pos`` index; loading
    drops it, and the rest loads strictly."""
    sd = to_torch(tiny[0])
    sd["block1.1.attn.pos"] = torch.zeros(4, 16, dtype=torch.long)
    path = tmp_path / "ref.pt"
    torch.save({"ema": sd}, path)
    loaded = load_checkpoint(f"{path}:ema")
    assert not any(k.endswith(".attn.pos") for k in loaded)
    port_model(TINY, {k: v.numpy() for k, v in loaded.items()})


def test_wd_mask_matches_jax(tiny):
    """The ``vit`` wd-skip rule on the port's state_dict names decays the
    same tensors as the JAX rule on the converted flax tree, the
    relative-position tables among them."""
    params = convert_state_dict(jax_cfg(TINY), tiny[0])["params"]
    theirs = state_dict_from_flax(jax.tree.map(
        lambda d: np.full((1,), d), jax_wd_mask(params, "vit")))
    ours = wd_mask(dict(port_model(TINY, tiny[0]).named_parameters()), "vit")
    assert sorted(ours) == sorted(theirs)
    assert {k for k, v in ours.items() if v} == {k for k, v in theirs.items() if v[0]}
    assert ours["block1.1.attn.rel_pos.weight"] and not ours["block2.0.norm.weight"]


def test_halo_dispatch():
    """'layer' by default wherever 2·halo ≤ window, 'gather' (the gathered
    kernel) where the halo is wider; forced paths; 'einsum' under the global
    attention force; a 'layer' force on a wide halo becomes 'gather', a
    'direct' force on one raises."""
    assert ops.halo_impl(8, 2) == ops.halo_impl(2, 1) == "layer"
    for name in ("direct", "einsum", "gather"):
        with halo_path(name):
            assert ops.halo_impl(8, 2) == name
    ops.set_attention_impl("einsum")
    try:
        assert ops.halo_impl(8, 2) == "einsum"
    finally:
        ops.set_attention_impl(None)
    assert ops.halo_impl(4, 3) == "gather"
    with halo_path("layer"):
        assert ops.halo_impl(4, 3) == "gather"
    with halo_path("direct"), pytest.raises(NotImplementedError, match="2·halo ≤ window"):
        ops.halo_impl(4, 3)
    with halo_path("einsum"):
        assert ops.halo_impl(4, 3) == "einsum"
    with pytest.raises(ValueError):
        ops.set_halo_impl("map")


def test_training_refuses_dropout():
    model = HaloConfig(**{**TINY, "drop_ff": 0.1}).make().train()
    with pytest.raises(NotImplementedError, match="drop_attn / drop_ff"):
        model(torch.zeros(1, 3, 64, 64))


def test_halo_s_conf_loads():
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.train.trainer import check_supported

    conf = load_config(os.path.join(ROOT, "tests", "data", "halo_s_port.conf"),
                       ["precision=f32", "data_backend=synthetic"])
    arch = conf.arch
    assert isinstance(arch, HaloConfig) and arch == HaloConfig()
    assert (arch.window_size, arch.halo_size, arch.image_size) == (8, 2, 256)
    assert conf.training.valid_size == conf.training.train_size == 256
    assert conf.training.grad_accumulation == 1
    check_supported(conf)
    n = sum(p.numel() for p in arch.make().parameters())
    assert list(itertools.islice(arch.make().state_dict(), 2)) == [
        "block1.0.linear.weight", "block1.0.linear.bias"]
    assert 30e6 < n < 40e6  # Halo-S
