"""The port's Twins-SVT (vision_transformers_tpu_torch/models/twins.py)
against the JAX package's, from one numpy-seeded reference-layout
state_dict: the JAX side builds its params through its own
``torch_convert.convert_state_dict``, the port loads the same dict with
``load_state_dict(strict=True)``.

The tiny Twins of tests/test_pvt_twins_halo.py:84-97: image 64, window 2
(window pairs packed under the block mask at stages 1-3, single windows at
stage 4), depths 1·4, dims 16-128, head width 8; the global attention
reduces to 64, 16, 4 and 1 tokens.  Each of the port's paths (local
attention ``einsum`` or through the attention-layer op with the mask,
global attention ``einsum`` or ``fused``; plain versions on the CPU) is
held to the JAX Twins on the same path, its kernels interpreted: logits to
atol 1e-5.  One train-step gradient (drop_path 0.5, the same per-sample
DropPath scales handed to both packages, four per layer) is held to the
JAX Twins' einsum path at rtol 1e-3 per tensor.  Then the plumbing: the
flax → state_dict routing of all five families, the weights' round trip,
the wd mask, the packing and the conf.
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
from vision_transformers_tpu.models import twins as jax_twins
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.train.optim import wd_mask as jax_wd_mask
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.models.halo import HaloConfig
from vision_transformers_tpu_torch.models.pvt import PVTConfig
from vision_transformers_tpu_torch.models.swin import SwinConfig
from vision_transformers_tpu_torch.models.twins import LocalAttention, TwinsConfig
from vision_transformers_tpu_torch.models.vit import ViTConfig
from vision_transformers_tpu_torch.ops import fused_layer
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.train.optim import wd_mask
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         seeded_train_batch,
                                                         state_dict_from_flax,
                                                         to_torch)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = dict(n_class=10, depths=[1, 1, 1, 1], dims=[16, 32, 64, 128], dim_head=8,
            n_heads=[2, 4, 8, 16], dim_ffs=[32, 64, 128, 256], window_size=2)
# (local attention, global attention) of each path, and the JAX force that
# takes the same path there
PATHS = {"einsum": (("einsum", "einsum"), None), "layer": (("layer", "einsum"), "layer"),
         "fused-gsa": (("einsum", "fused"), "fused")}


def jax_cfg(**kw):
    return jax_registry.build("model", {"type": "twins_svt", **TINY, **kw})


def port_model(sd, **kw):
    model = TwinsConfig(**{**TINY, **kw}).make()
    model.load_state_dict(to_torch(sd), strict=True)
    return model


class path:
    """Force the local and the global attention path in the port."""

    def __init__(self, local, glob):
        self.local, self.glob = local, glob

    def __enter__(self):
        ops.set_attention_impl(self.local)
        ops.set_sra_impl(self.glob)

    def __exit__(self, *exc):
        ops.set_attention_impl(None)
        ops.set_sra_impl(None)


@pytest.fixture(scope="module")
def tiny():
    sd = seeded_state_dict(TwinsConfig(**TINY), seed=0)
    return sd, seeded_train_batch(5, 2, 64, 10)


def jax_logits(sd, x, force):
    cfg = jax_cfg()
    variables = jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))
    jax_ops.set_attention_impl(force, interpret=True)
    try:
        return np.asarray(jax.jit(cfg.make().apply)(variables, jnp.asarray(x)))
    finally:
        jax_ops.set_attention_impl(None)


@pytest.mark.parametrize("name", list(PATHS))
def test_logits_match_jax(tiny, name):
    sd, batch = tiny
    (local, glob), force = PATHS[name]
    theirs = jax_logits(sd, batch["image"], force)
    model = port_model(sd).eval()
    before = fused_layer.BIAS_LAUNCHES
    with path(local, glob), torch.no_grad():
        ours = model(torch.from_numpy(batch["image"]).permute(0, 3, 1, 2)).numpy()
    assert fused_layer.BIAS_LAUNCHES == before  # the CPU takes the plain versions
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def jax_grads(sd, batch, drop_path, scales):
    """(loss, state_dict-keyed grads) of the JAX Twins' einsum path; each
    DropPath draw (LSA, its FF, GSA, its FF of each layer whose rate is > 0)
    takes the next of ``scales``."""
    cfg = jax_cfg(drop_path=drop_path)
    params = jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))["params"]
    b = jax.tree.map(jnp.asarray, batch)

    def f(p):
        logits = cfg.make().apply({"params": p}, b["image"], deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_loss.mix_loss(logits, b["label1"], b["label2"], b["ratio"], eps=0.1)

    it = iter(jnp.asarray(s) for s in scales)
    drop_path_fn = jax_twins.drop_path_fn
    jax_twins.drop_path_fn = lambda y, rate, rng, _: y * next(it).reshape(
        (-1,) + (1,) * (y.ndim - 1))
    try:
        loss, g = jax.jit(jax.value_and_grad(f))(params)  # traced once: one draw each
    finally:
        jax_twins.drop_path_fn = drop_path_fn
    return float(loss), state_dict_from_flax(jax.tree.map(np.asarray, g))


def port_grads(sd, batch, local, glob, drop_path, scales):
    model = port_model(sd, drop_path=drop_path).train()
    it = iter(torch.from_numpy(s) for s in scales)
    draws = [(None,) * 4 if r == 0 else tuple(next(it) for _ in range(4))
             for r in model.drop_path_rates]
    model.draw_drop_path = lambda b, generator=None: draws
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with path(local, glob):
        logits = model(tb["image"].permute(0, 3, 1, 2))
        loss = L.mix_loss(logits, tb["label1"].long(), tb["label2"].long(), tb["ratio"],
                          eps=0.1)
        loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in model.named_parameters()}


# per layer of rate > 0 (layers 1-3): LSA, FF, GSA, FF; some samples dropped
SCALES = [np.array(v, np.float32) for v in
          ([2, 0], [2, 2], [0, 2], [2, 2], [2, 2], [0, 2], [2, 2], [2, 0], [0, 2], [2, 2],
           [2, 0], [2, 2])]


@pytest.fixture(scope="module")
def tiny_grads(tiny):
    return jax_grads(*tiny, 0.5, SCALES)


@pytest.mark.parametrize("name", list(PATHS))
def test_train_step_grads_with_drop_path_scales_match_jax(tiny, tiny_grads, name):
    loss, g = port_grads(*tiny, *PATHS[name][0], 0.5, SCALES)
    loss_j, g_j = tiny_grads
    assert sorted(g) == sorted(g_j)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    for k in sorted(g):
        np.testing.assert_allclose(g[k], g_j[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert np.abs(g["block1.2.proj.weight"]).max() > 0


def test_drop_path_ramp_and_draws():
    """The ramp drop_path·i/sum(depths), four independent draws per layer
    (None at rate 0)."""
    model = TwinsConfig(**{**TINY, "drop_path": 0.4}).make()
    np.testing.assert_allclose(model.drop_path_rates, [0.0, 0.1, 0.2, 0.3])
    draws = model.draw_drop_path(64, torch.Generator().manual_seed(0))
    assert draws[0] == (None,) * 4 and len(draws[3]) == 4
    assert len({tuple(d.tolist()) for d in draws[3]}) == 4


def test_window_packing_and_mask():
    """Pairs where a row of windows is even and 2·w² ≤ 128 (Twins-S: stages
    1-3 at 224 px, m = 98); the mask is 0 within a window, −1e9 across."""
    attn = LocalAttention(64, 2, 32, 7)
    assert [attn.pack(ws) for ws in (8, 4, 2, 1)] == [2, 2, 2, 1]
    assert LocalAttention(64, 2, 32, 9).pack(4) == 1  # 2·81 > 128
    mask = attn.pair_mask(2, "cpu")
    assert mask.shape == (98, 98) and attn.pair_mask(1, "cpu") is None
    assert (mask[:49, :49] == 0).all() and (mask[49:, 49:] == 0).all()
    assert (mask[:49, 49:] == -1e9).all() and (mask[49:, :49] == -1e9).all()


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

FAMILIES = {  # registered type → the port's config of a tiny model
    "vit": ViTConfig(image_size=32, window_size=8, depth=1, dim=16, n_head=2, dim_ff=32,
                     n_class=10),
    "swin_transformer": SwinConfig(image_size=(64, 64), depths=(1, 1, 1, 1),
                                   dims=(8, 16, 32, 64), dim_head=4, n_heads=(2, 4, 8, 16),
                                   dim_ffs=(16, 32, 64, 128), window_size=2, n_class=10),
    "halo_transformer": HaloConfig(image_size=64, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
                                   dim_head=4, n_heads=(2, 4, 8, 16),
                                   dim_ffs=(16, 32, 64, 128), window_size=2, halo_size=1,
                                   n_class=10),
    "pvt": PVTConfig(**{**{k: tuple(v) if isinstance(v, list) else v for k, v in dict(
        image_size=32, n_class=10, depths=[1, 1, 1, 1], patch_embed_dims=[16, 32, 64, 128],
        n_heads=[1, 2, 4, 8], dim_ffs=[32, 64, 128, 256], reductions=[4, 2, 2, 1]).items()}}),
    "twins_svt": TwinsConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in TINY.items()}),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dict_from_flax_routes_every_family(family):
    """Each family's flax tree goes to its own conversion: Twins (which has
    ``embed1`` and ``final_norm`` as Halo does) by ``peg1``, PVT by
    ``patch_embedding_0``, Halo by ``embed1``, Swin by ``final_norm`` beside
    ``patch_embedding``, else ViT; the round trip is the identity."""
    arch = FAMILIES[family]
    sd = seeded_state_dict(arch, seed=1)
    fields = {k: list(v) if isinstance(v, tuple) else v for k, v in vars(arch).items()}
    params = convert_state_dict(jax_registry.build("model", {"type": family, **fields}),
                                sd)["params"]
    back = state_dict_from_flax(params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    arch.make().load_state_dict(to_torch(sd), strict=True)


def test_state_dict_round_trip_through_jax_params():
    """Seeded Twins-SVT-S state_dict → the JAX package's params → back is
    the identity and loads strictly; the layers sit at torch indices 1,
    3, 4, ... around the PEG at 2."""
    arch = TwinsConfig()
    sd = seeded_state_dict(arch, seed=3)
    params = convert_state_dict(jax_registry.build("model", {"type": "twins_svt"}),
                                sd)["params"]
    assert {"peg1", "embed1", "final_norm"} <= set(params)
    back = state_dict_from_flax(params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    assert sd["block3.2.proj.weight"].shape == (256, 1, 3, 3)
    assert "block3.11.ff_global.3.bias" in sd and "block3.12.norm_ff_local.weight" not in sd


def test_wd_mask_matches_jax(tiny):
    params = convert_state_dict(jax_cfg(), tiny[0])["params"]
    theirs = state_dict_from_flax(jax.tree.map(
        lambda d, p: np.full(np.shape(p), d), jax_wd_mask(params, "vit"), params))
    ours = wd_mask(dict(port_model(tiny[0]).named_parameters()), "vit")
    assert sorted(ours) == sorted(theirs)
    assert {k for k, v in ours.items() if v} == {k for k, v in theirs.items() if v.all()}
    assert ours["block1.2.proj.weight"] and not ours["block1.1.norm_ff_global.weight"]



def test_jax_package_reproduces_golden():
    """The JAX package still gives the logits stored in the Twins-SVT-S golden
    (scripts/make_torch_port_pvt_twins_golden.py), which
    tests/test_torch_port_pvt_twins_golden.py holds the port to."""
    path = os.path.join(ROOT, "scripts", "make_torch_port_pvt_twins_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_pvt_twins_golden", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    conf, golden, _ = script.MODELS["Twins-SVT-S"]
    with np.load(golden) as g:
        np.testing.assert_allclose(script.jax_logits(int(g["seed"]), conf), g["logits"],
                                   rtol=1e-5, atol=1e-5)


def test_training_refuses_dropout():
    model = TwinsConfig(**{**TINY, "drop_attn": 0.1}).make().train()
    with pytest.raises(NotImplementedError, match="drop_attn / drop_ff"):
        model(torch.zeros(1, 3, 64, 64))


def test_twins_svt_s_conf_loads():
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.train.trainer import check_supported

    conf = load_config(os.path.join(ROOT, "tests", "data", "twins_svt_s_port.conf"),
                       ["precision=f32", "data_backend=synthetic"])
    arch = conf.arch
    assert isinstance(arch, TwinsConfig) and arch == TwinsConfig()
    assert (arch.window_size, arch.dim_head, arch.depths) == (7, 32, (2, 2, 10, 4))
    assert conf.training.valid_size == conf.training.train_size == 224
    assert conf.training.grad_accumulation == 1
    check_supported(conf)
    model = arch.make()
    assert list(itertools.islice(model.state_dict(), 2)) == [
        "block1.0.linear.weight", "block1.0.linear.bias"]
    assert 128e6 < sum(p.numel() for p in model.parameters()) < 130e6
