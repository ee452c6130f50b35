"""The port's PVT (vision_transformers_tpu_torch/models/pvt.py) against the
JAX package's, from one numpy-seeded reference-layout state_dict: the JAX
side builds its params through its own ``torch_convert.convert_state_dict``,
the port loads the same dict with ``load_state_dict(strict=True)``.

The tiny PVT of tests/test_pvt_twins_halo.py:56-68: image 32, depths 1·4,
dims 16-128, heads 1-8, reductions 4/2/2/1 (k / v of 4, 4, 1 and 5
tokens: stage 4 keeps the cls token and reduces nothing).  The port's two
spatial-reduction paths (``einsum`` and ``fused``; plain versions on the
CPU) are held to the JAX PVT forced to its ``fused_attention`` kernel in
interpret mode: logits to atol 1e-5.  One train-step gradient (drop_path
0.5, the same per-sample DropPath scales handed to both packages) is held
to the JAX PVT's einsum path at rtol 1e-3 per tensor.  Then the plumbing:
the weights' round trip, the wd mask, the dispatch and the conf.
"""

import importlib.util
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.config import registry as jax_registry
from vision_transformers_tpu.models import pvt as jax_pvt
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.train.optim import wd_mask as jax_wd_mask
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.models.pvt import PVTConfig
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.train.optim import wd_mask
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         seeded_train_batch,
                                                         state_dict_from_flax,
                                                         to_torch)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = dict(image_size=32, n_class=10, depths=[1, 1, 1, 1], patch_embed_dims=[16, 32, 64, 128],
            n_heads=[1, 2, 4, 8], dim_ffs=[32, 64, 128, 256], reductions=[4, 2, 2, 1])
PATHS = ["einsum", "fused"]


def jax_cfg(**kw):
    return jax_registry.build("model", {"type": "pvt", **TINY, **kw})


def port_model(sd, **kw):
    model = PVTConfig(**{**TINY, **kw}).make()
    model.load_state_dict(to_torch(sd), strict=True)
    return model


class sra_path:
    """Force one reduced-kv path in the port."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        ops.set_sra_impl(self.name)

    def __exit__(self, *exc):
        ops.set_sra_impl(None)


@pytest.fixture(scope="module")
def tiny():
    """(state_dict, batch, the JAX PVT's logits through its fused kernel)."""
    sd = seeded_state_dict(PVTConfig(**TINY), seed=0)
    batch = seeded_train_batch(5, 2, 32, 10)
    cfg = jax_cfg()
    variables = jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))
    jax_ops.set_attention_impl("fused", interpret=True)
    try:
        logits = np.asarray(jax.jit(cfg.make().apply)(variables, jnp.asarray(batch["image"])))
    finally:
        jax_ops.set_attention_impl(None)
    return sd, batch, logits


@pytest.mark.parametrize("path", PATHS)
def test_logits_match_jax(tiny, path):
    sd, batch, theirs = tiny
    model = port_model(sd).eval()
    with sra_path(path), torch.no_grad():
        ours = model(torch.from_numpy(batch["image"]).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def jax_grads(sd, batch, drop_path, scales):
    """(loss, state_dict-keyed grads) of the JAX PVT's einsum path; each
    DropPath draw (attention, then FF branch, of each layer whose rate is
    > 0) takes the next of ``scales``."""
    cfg = jax_cfg(drop_path=drop_path)
    params = jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))["params"]
    b = jax.tree.map(jnp.asarray, batch)

    def f(p):
        logits = cfg.make().apply({"params": p}, b["image"], deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_loss.mix_loss(logits, b["label1"], b["label2"], b["ratio"], eps=0.1)

    it = iter(jnp.asarray(s) for s in scales)
    drop_path_fn = jax_pvt.drop_path_fn
    jax_pvt.drop_path_fn = lambda y, rate, rng, _: y * next(it).reshape(
        (-1,) + (1,) * (y.ndim - 1))
    try:
        loss, g = jax.jit(jax.value_and_grad(f))(params)  # traced once: one draw each
    finally:
        jax_pvt.drop_path_fn = drop_path_fn
    return float(loss), state_dict_from_flax(jax.tree.map(np.asarray, g))


def port_grads(sd, batch, path, drop_path, scales):
    model = port_model(sd, drop_path=drop_path).train()
    it = iter(torch.from_numpy(s) for s in scales)
    pairs = [(None, None) if r == 0 else (next(it), next(it)) for r in model.drop_path_rates]
    model.draw_drop_path = lambda b, generator=None: pairs
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with sra_path(path):
        logits = model(tb["image"].permute(0, 3, 1, 2))
        loss = L.mix_loss(logits, tb["label1"].long(), tb["label2"].long(), tb["ratio"],
                          eps=0.1)
        loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in model.named_parameters()}


# per layer of rate > 0 (layers 1-3): (attention, FF); some samples dropped
SCALES = [np.array(v, np.float32) for v in
          ([2, 0], [2, 2], [0, 2], [2, 2], [2, 2], [0, 2])]


@pytest.fixture(scope="module")
def tiny_grads(tiny):
    sd, batch, _ = tiny
    return jax_grads(sd, batch, 0.5, SCALES)


@pytest.mark.parametrize("path", PATHS)
def test_train_step_grads_with_drop_path_scales_match_jax(tiny, tiny_grads, path):
    sd, batch, _ = tiny
    loss, g = port_grads(sd, batch, path, 0.5, SCALES)
    loss_j, g_j = tiny_grads
    assert sorted(g) == sorted(g_j)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    for k in sorted(g):
        np.testing.assert_allclose(g[k], g_j[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert np.abs(g["patch_embedding.3.cls_token"]).max() > 0


def test_drop_path_ramp_and_draws():
    """The ramp drop_path·i/(total − 1) over the layers, two independent
    draws per layer from the generator it is given (None at rate 0)."""
    model = PVTConfig(**{**TINY, "drop_path": 0.3}).make()
    np.testing.assert_allclose(model.drop_path_rates, [0.0, 0.1, 0.2, 0.3])
    draws = model.draw_drop_path(64, torch.Generator().manual_seed(0))
    assert draws[0] == (None, None)
    a, f = draws[3]
    assert not torch.equal(a, f)
    assert set(torch.unique(a).tolist()) == {0.0, float(torch.tensor(1 / 0.7))}
    again = model.draw_drop_path(64, torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for (x, _), (y, _) in zip(draws[1:], again[1:]))


def test_state_dict_round_trip_through_jax_params():
    """Seeded PVT-S state_dict → the JAX package's params → back is the
    identity, key for key, and loads strictly into the port's PVT-S."""
    arch = PVTConfig()
    sd = seeded_state_dict(arch, seed=3)
    params = convert_state_dict(jax_registry.build("model", {"type": "pvt"}), sd)["params"]
    assert "patch_embedding_0" in params and "peg1" not in params
    back = state_dict_from_flax(params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    arch.make().load_state_dict(to_torch(sd), strict=True)
    assert sd["patch_embedding.3.pos"].shape == (50, 512)  # 7·7 patches + cls
    assert "block4.0.attn.reduce_conv.weight" not in sd  # stage 4 reduces nothing


def test_wd_mask_matches_jax(tiny):
    """The ``vit`` wd-skip rule on the port's state_dict names decays the
    same tensors as the JAX rule on the converted flax tree: the position
    embeddings and the convs decay, the cls token and the norms do not."""
    params = convert_state_dict(jax_cfg(), tiny[0])["params"]
    theirs = state_dict_from_flax(jax.tree.map(
        lambda d, p: np.full(np.shape(p), d), jax_wd_mask(params, "vit"), params))
    ours = wd_mask(dict(port_model(tiny[0]).named_parameters()), "vit")
    assert sorted(ours) == sorted(theirs)
    assert {k for k, v in ours.items() if v} == {k for k, v in theirs.items() if v.all()}
    assert ours["patch_embedding.0.pos"] and ours["block1.0.attn.reduce_conv.weight"]
    assert not ours["patch_embedding.3.cls_token"]


def test_sra_dispatch():
    """'einsum' by default on every device and under the global einsum
    force; 'fused' when forced, at any number of reduced tokens (no n_kv
    gate); unknown names and empty k / v raise."""
    assert ops.sra_impl(1) == ops.sra_impl(49) == "einsum"
    with sra_path("fused"):
        assert ops.sra_impl(1) == ops.sra_impl(4) == "fused"
        ops.set_attention_impl("einsum")
        try:
            assert ops.sra_impl(49) == "fused"  # the site's own force wins
        finally:
            ops.set_attention_impl(None)
    ops.set_attention_impl("einsum")
    try:
        assert ops.sra_impl(49) == "einsum"
    finally:
        ops.set_attention_impl(None)
    with pytest.raises(ValueError):
        ops.set_sra_impl("layer")
    with pytest.raises(ValueError):
        ops.sra_impl(0)



def test_jax_package_reproduces_golden():
    """The JAX package still gives the logits stored in the PVT-S golden
    (scripts/make_torch_port_pvt_twins_golden.py), which
    tests/test_torch_port_pvt_twins_golden.py holds the port to."""
    path = os.path.join(ROOT, "scripts", "make_torch_port_pvt_twins_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_pvt_twins_golden", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    conf, golden, _ = script.MODELS["PVT-S"]
    with np.load(golden) as g:
        np.testing.assert_allclose(script.jax_logits(int(g["seed"]), conf), g["logits"],
                                   rtol=1e-5, atol=1e-5)


def test_training_refuses_dropout():
    model = PVTConfig(**{**TINY, "drop_ff": 0.1}).make().train()
    with pytest.raises(NotImplementedError, match="drop_attn / drop_ff"):
        model(torch.zeros(1, 3, 32, 32))


def test_pvt_s_conf_loads():
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.train.trainer import check_supported

    conf = load_config(os.path.join(ROOT, "tests", "data", "pvt_s_port.conf"),
                       ["precision=f32", "data_backend=synthetic"])
    arch = conf.arch
    assert isinstance(arch, PVTConfig) and arch == PVTConfig()
    assert (arch.image_size, arch.reductions, arch.n_heads) == (224, (8, 4, 2, 1), (1, 2, 5, 8))
    assert conf.training.valid_size == conf.training.train_size == 224
    assert conf.training.grad_accumulation == 1
    check_supported(conf)
    model = arch.make()
    assert list(itertools.islice(model.state_dict(), 2)) == [
        "block1.0.norm_attn.weight", "block1.0.norm_attn.bias"]
    assert 24e6 < sum(p.numel() for p in model.parameters()) < 25e6  # PVT-Small: 24.5M
