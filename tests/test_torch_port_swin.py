"""The port's Swin (vision_transformers_tpu_torch/models/swin.py) against the
JAX package's, from one numpy-seeded reference-layout state_dict: the JAX
side builds its params through its own ``torch_convert.convert_state_dict``,
the port loads the same dict with ``load_state_dict(strict=True)``.

A tiny Swin (image 64, window 2, depths 2·4, dims 8-64, dim_head 4): both
shifts run in every stage, three stages pack window pairs and the last has
grid = window, where the shifted index wraps inside the window.  Each
attention path is compared at the same impl: the JAX Pallas kernels in
interpret mode against the port's plain versions on the CPU.  Logits are
held to atol 1e-5, a train-step gradient (drop_path 0) to rtol 1e-3 per
tensor (relative-position tables included), as
tests/test_fused_layer1.py:195-203 holds the Pallas kernel's gradients.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.config import registry as jax_registry
from vision_transformers_tpu.models import swin as jax_swin
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.train.optim import wd_mask as jax_wd_mask
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.models import swin
from vision_transformers_tpu_torch.models.swin import SwinConfig
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.train.optim import wd_mask
from vision_transformers_tpu_torch.utils.weights import (load_checkpoint,
                                                         seeded_state_dict,
                                                         seeded_train_batch,
                                                         state_dict_from_flax,
                                                         to_torch)

ARCH = dict(image_size=[64, 64], n_class=10, depths=[2, 2, 2, 2], dims=[8, 16, 32, 64],
            dim_head=4, n_heads=[2, 4, 8, 16], dim_ffs=[32, 64, 128, 256], window_size=2)


def jax_cfg(**kw):
    return jax_registry.build("model", {"type": "swin_transformer", **ARCH, **kw})


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(SwinConfig(**ARCH), seed=0)


@pytest.fixture(scope="module")
def batch():
    return seeded_train_batch(5, 2, 64, 10)


class impl:
    """Force one attention impl in both packages (JAX kernels interpreted)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        jax_ops.set_attention_impl(self.name, interpret=self.name is not None)
        ops.set_attention_impl(self.name)

    def __exit__(self, *exc):
        jax_ops.set_attention_impl(None)
        ops.set_attention_impl(None)


def port_model(sd):
    model = SwinConfig(**ARCH).make()
    model.load_state_dict(to_torch(sd), strict=True)
    return model


@pytest.mark.parametrize("grid,window,shift", [
    ((8, 8), 2, False), ((8, 8), 2, True), ((14, 14), 7, True), ((7, 7), 7, True),
    ((2, 2), 2, True), ((6, 4), 2, True)])
def test_static_index_and_masks_equal_jax(grid, window, shift):
    np.testing.assert_array_equal(swin.relative_position_index(window, grid, shift),
                                  jax_swin.relative_position_index(window, grid, shift))
    np.testing.assert_array_equal(swin.shifted_window_mask(grid, window),
                                  jax_swin.shifted_window_mask(grid, window))


def test_last_stage_index_wraps_inside_the_window():
    """Grid = window (Swin-S stage 4): the shifted index differs from the
    unshifted one, and the mask is all zero (JAX swin.py:85-91)."""
    assert not np.array_equal(swin.relative_position_index(7, (7, 7), True),
                              swin.relative_position_index(7, (7, 7), False))
    assert (swin.shifted_window_mask((7, 7), 7) == 0).all()


@pytest.mark.parametrize("name", [None, "layer1", "layer"],
                         ids=["default-einsum", "layer1", "layer"])
def test_logits_match_jax(weights, batch, name):
    x = batch["image"]
    cfg = jax_cfg()
    variables = jax.tree.map(jnp.asarray, convert_state_dict(cfg, weights))
    model = port_model(weights).eval()
    with impl(name):
        theirs = np.asarray(cfg.make().apply(variables, jnp.asarray(x)))
        with torch.no_grad():
            ours = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", [None, "layer1"], ids=["default-einsum", "layer1"])
def test_train_step_grads_match_jax(weights, batch, name):
    cfg = jax_cfg(drop_path=0.0)
    params = jax.tree.map(jnp.asarray, convert_state_dict(cfg, weights))["params"]
    b = jax.tree.map(jnp.asarray, batch)
    model = port_model(weights).train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with impl(name):
        def f(p):
            logits = cfg.make().apply({"params": p}, b["image"], deterministic=False)
            return jax_loss.mix_loss(logits, b["label1"], b["label2"], b["ratio"], eps=0.1)

        loss_j, g = jax.value_and_grad(f)(params)
        logits = model(tb["image"].permute(0, 3, 1, 2))
        loss = L.mix_loss(logits, tb["label1"].long(), tb["label2"].long(), tb["ratio"],
                          eps=0.1)
        loss.backward()
    theirs = state_dict_from_flax(jax.tree.map(np.asarray, g))
    ours = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(ours) == sorted(theirs)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for k in sorted(ours):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert any(np.abs(ours[k]).max() > 0 for k in ours if "rel_pos" in k)


def test_state_dict_round_trip_through_jax_params():
    """Seeded Swin-S state_dict → the JAX package's params → back is the
    identity, key for key."""
    arch = SwinConfig(depths=(2, 2, 18, 2))
    sd = seeded_state_dict(arch, seed=3)
    params = convert_state_dict(jax_registry.build(
        "model", {"type": "swin_transformer", "depths": [2, 2, 18, 2]}), sd)["params"]
    back = state_dict_from_flax(params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    assert np.abs(sd["block3.5.attn.rel_pos.weight"]).max() > 0  # the tests see the bias


def test_checkpoint_drops_reference_buffers(weights, tmp_path):
    """A reference .pt carries each layer's ``attn.pos`` index and
    ``attn.local_mask``; loading drops them, and the rest loads strictly."""
    sd = to_torch(weights)
    sd["block1.0.attn.pos"] = torch.zeros(4, 4, dtype=torch.long)
    sd["block1.0.attn.local_mask"] = torch.zeros(16, 4, 4)
    path = tmp_path / "ref.pt"
    torch.save({"model": sd}, path)
    loaded = load_checkpoint(f"{path}:model")
    assert not any(k.endswith((".attn.pos", ".attn.local_mask")) for k in loaded)
    port_model({k: v.numpy() for k, v in loaded.items()})


def test_wd_mask_matches_jax(weights):
    """The ``vit`` wd-skip rule on the port's state_dict names decays the
    same tensors as the JAX rule on the converted flax tree."""
    params = convert_state_dict(jax_cfg(), weights)["params"]
    theirs = state_dict_from_flax(jax.tree.map(
        lambda d: np.full((1,), d), jax_wd_mask(params, "vit")))
    ours = wd_mask(dict(port_model(weights).named_parameters()), "vit")
    assert sorted(ours) == sorted(theirs)
    assert {k for k, v in ours.items() if v} == {k for k, v in theirs.items() if v[0]}
    assert ours["block1.0.attn.rel_pos.weight"] and not ours["block2.0.norm.weight"]


def test_drop_path_draws_two_scales_per_layer():
    """In training each layer draws independent (rs_attn, rs_ff) at the
    ramp drop_path·i/sum(depths) from the generator it is given."""
    model = SwinConfig(**{**ARCH, "drop_path": 0.5}).make()
    assert model.drop_path_rates == [0.5 * i / 8 for i in range(8)]
    draws = model.draw_drop_path(64, torch.Generator().manual_seed(0))
    assert draws[0] == (None, None)
    a, f = draws[-1]
    assert not torch.equal(a, f)
    keep = 1 - 0.5 * 7 / 8
    assert set(torch.unique(a).tolist()) <= {0.0, float(np.float32(1 / keep))}
    again = model.draw_drop_path(64, torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for (x, _), (y, _) in zip(draws[1:], again[1:]))


def test_swin_s_conf_loads():
    from vision_transformers_tpu_torch.config.schema import load_config

    conf = load_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                    "swin-transformer-s.conf"))
    arch = conf.arch
    assert isinstance(arch, SwinConfig) and arch.type == "swin_transformer"
    assert (arch.depths, arch.dims, arch.dim_head, arch.n_heads, arch.window_size) == \
        ((2, 2, 18, 2), (96, 192, 384, 768), 32, (3, 6, 12, 24), 7)
    assert arch.drop_path == 0.3 and conf.training.grad_accumulation == 2
