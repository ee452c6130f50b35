"""The port's ViT (vision_transformers_tpu_torch/models/vit.py) against the
JAX package's, from one numpy-seeded reference-layout state_dict: the JAX
side builds its params through its own ``torch_convert.convert_state_dict``,
the port loads the same dict with ``load_state_dict(strict=True)``.

Each attention path is compared at the same impl: JAX's Pallas kernels in
interpret mode against the port's plain versions on the CPU.  Logits are
held to rtol 5e-4, atol 5e-5, as tests/test_fused_layer1.py:299-301 holds
the layer1 and layer model forwards to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.models.vit import ViTConfig as JaxViTConfig
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu.utils.torch_export import export_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.models.vit import ViTConfig
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         state_dict_from_flax,
                                                         to_torch)

ARCH = dict(image_size=32, window_size=8, depth=2, dim=64, n_head=2,
            dim_ff=128, n_class=10)


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(ViTConfig(**ARCH), seed=0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(np.float32)


def port_model(sd):
    model = ViTConfig(**ARCH).make()
    result = model.load_state_dict(to_torch(sd), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return model.eval()


def jax_logits(sd, x, impl):
    cfg = JaxViTConfig(**ARCH)
    variables = jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))
    jax_ops.set_attention_impl(impl, interpret=impl is not None)
    try:
        with jax_ops.forward_only():
            return np.asarray(cfg.make().apply(variables, jnp.asarray(x)))
    finally:
        jax_ops.set_attention_impl(None)


def port_logits(sd, x, impl):
    ops.set_attention_impl(impl)
    try:
        with torch.no_grad(), ops.forward_only():
            return port_model(sd)(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    finally:
        ops.set_attention_impl(None)


@pytest.mark.parametrize("impl", [None, "layer", "layer1"],
                         ids=["default-einsum", "layer", "layer1"])
def test_logits_match_jax(weights, images, impl):
    np.testing.assert_allclose(port_logits(weights, images, impl),
                               jax_logits(weights, images, impl),
                               rtol=5e-4, atol=5e-5)


def test_pos_embed_resize_matches_jax(weights):
    """Another input size than the model was built for: the port's
    F.interpolate(bicubic) against the JAX package's torch-exact matrix."""
    x = np.random.default_rng(2).normal(size=(2, 48, 48, 3)).astype(np.float32)
    np.testing.assert_allclose(port_logits(weights, x, None),
                               jax_logits(weights, x, None), rtol=5e-4, atol=5e-5)


def test_state_dict_from_flax_matches_export(images):
    """The port's numpy-only converter gives the JAX package's own export,
    key for key and bit for bit."""
    cfg = JaxViTConfig(**ARCH)
    variables = cfg.make().init(jax.random.PRNGKey(0), jnp.asarray(images))
    variables = jax.tree.map(np.asarray, variables)
    ours = state_dict_from_flax(variables["params"])
    theirs = export_state_dict(cfg, variables)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        assert np.array_equal(ours[k], theirs[k]), k
    port_model(ours)  # and it loads strictly


def test_dispatch_row_gates():
    """The JAX package's row-count gates (ops/__init__.py:66-79)."""
    assert ops.attention_impl(8, default="layer") == "einsum"
    assert ops.attention_impl(64, default="layer") == "layer"
    assert ops.attention_impl(256, default="layer") == "layer"
    with ops.forward_only():
        assert ops.attention_impl(31, default="layer") == "einsum"
        assert ops.attention_impl(64, default="layer") == "layer"
        assert ops.attention_impl(127, default="layer") == "layer"
        assert ops.attention_impl(128, default="layer") == "layer1"
        assert ops.attention_impl(256, default="einsum") == "einsum"
    assert ops.attention_impl(256, default="layer") == "layer"


def test_training_forward_with_drop_path_trains(weights, images):
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    model = ViTConfig(**ARCH, drop_path=0.1).make()
    model.load_state_dict(to_torch(weights), strict=True)
    out = model.train()(x)
    assert out.shape == (x.shape[0], ARCH["n_class"]) and torch.isfinite(out).all()


def test_training_forward_with_dropout_trains(weights, images):
    """Dropout is ported: a training forward runs, draws its masks from the
    generator it is given (the same seed gives the same logits, the global
    RNG is untouched) and differs from the eval forward."""
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    model = ViTConfig(**ARCH, drop_path=0.1, dropout=0.1).make()
    model.load_state_dict(to_torch(weights), strict=True)
    state = torch.get_rng_state()
    out = model.train()(x, torch.Generator().manual_seed(0))
    again = model(x, torch.Generator().manual_seed(0))
    other = model(x, torch.Generator().manual_seed(1))
    assert torch.equal(torch.get_rng_state(), state)
    assert out.shape == (x.shape[0], ARCH["n_class"]) and torch.isfinite(out).all()
    assert torch.equal(out, again) and not torch.equal(out, other)
    assert not torch.allclose(out, model.eval()(x))
