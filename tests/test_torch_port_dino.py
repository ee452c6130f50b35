"""The port's DINO pieces (vision_transformers_tpu_torch/models/vit.py,
train/loss.py, train/schedule.py, train/optim.py, data/ops.py,
utils/weights.py) against the JAX package's, on the CPU, from numpy-seeded
inputs and reference-layout weights (the JAX side builds its params through
its own ``torch_convert.convert_state_dict``).

- one packed layer: JAX's ``TransformerLayer`` with token-level DropPath
  scales (``rs_override``) and the block-diagonal mask of 3 local crops of
  37 tokens, its attention layer in Pallas interpret mode, against the
  port's layer through B1's autograd Function on its plain version,
  forward and every gradient (rtol = atol = 1e-4 of each tensor's scale);
- the backbone's grouped, packed multi-crop forward (features, rtol 1e-4)
  and the pos-embed resize at 14 → 6 (atol 1e-6);
- ``DINOHead`` with and without the trainable gain, output and gradients;
- ``dino_loss`` (rtol 1e-5, and its gradient), ``update_center``,
  ``teacher_temperature_schedule``, ``cosine_schedule`` and the ``dino``
  weight-decay mask on state_dict names;
- each colour op's apply fed the draws the JAX op made (atol 1e-5);
- the flax → state_dict routing of DINO trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.data import ops as jax_data_ops
from vision_transformers_tpu.models.vit import DINOConfig as JaxDINOConfig
from vision_transformers_tpu.models.vit import DINOHead as JaxDINOHead
from vision_transformers_tpu.models.vit import TransformerLayer as JaxLayer
from vision_transformers_tpu.models.vit import VisionTransformer as JaxViT
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.train.optim import wd_mask as jax_wd_mask
from vision_transformers_tpu.train.schedule import cosine_schedule as jax_cosine
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.data import ops as data_ops
from vision_transformers_tpu_torch.models.vit import (DINOConfig, DINOHead, crop_pack,
                                                      pack_mask, torch_bicubic_matrix)
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.train import optim
from vision_transformers_tpu_torch.train.schedule import cosine_schedule
from vision_transformers_tpu_torch.utils import weights
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         state_dict_from_flax, to_torch)
from torch_port_threads import one_torch_thread  # noqa: F401

# DeiT-S/16's geometry at a small width: 224 / 16 → 197-token globals,
# 96 / 16 → 37-token locals (packed 3 to a row: 111 tokens), heads 64 wide
ARCH = dict(image_size=224, window_size=16, depth=2, dim=128, n_head=2, dim_ff=256,
            dim_head_out=100, norm_last_layer=False, depth_head=3, dim_head_ff=96,
            dim_head_bottleneck=32)
TOL = 1e-4


@pytest.fixture(scope="module")
def weights_sd():
    return seeded_state_dict(DINOConfig(**ARCH), seed=0)


def jax_params(sd, **arch):
    return jax.tree.map(jnp.asarray,
                        convert_state_dict(JaxDINOConfig(**{**ARCH, **arch}), sd)["params"])


def port_model(sd, **arch):
    model = DINOConfig(**{**ARCH, **arch}).make()
    model.load_state_dict(to_torch(sd), strict=True)
    return model


def close_scaled(ours, theirs, tol, what):
    """Every tensor within ``tol`` of its own scale (max |theirs|)."""
    assert sorted(ours) == sorted(theirs), what
    for k in ours:
        a, b = np.asarray(ours[k], np.float64), np.asarray(theirs[k], np.float64)
        assert a.shape == b.shape, (what, k)
        scale = max(np.abs(b).max(), 1e-12)
        np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


def token_scales(rng, rows, pack, seq, keep=0.9):
    """Token-level DropPath scales [rows, pack·seq]: one draw per crop,
    both kinds present."""
    m = rng.random((rows, pack)) < keep
    m[0, 0], m[-1, -1] = False, True
    return np.repeat(m.astype(np.float32) / keep, seq, axis=1)


# ---------------------------------------------------------------------------
# one packed layer (B1 with the block mask at heads 64 wide)
# ---------------------------------------------------------------------------


def test_packed_layer_with_token_scales_matches_jax(weights_sd):
    rng = np.random.default_rng(5)
    pack, seq, rows, C = 3, 37, 2, ARCH["dim"]
    N = pack * seq
    x = rng.normal(size=(rows, N, C)).astype(np.float32)
    rs1, rs2 = token_scales(rng, rows, pack, seq), token_scales(rng, rows, pack, seq)
    extra_np = np.asarray(pack_mask(pack, seq, "cpu"))
    lp = jax_params(weights_sd)["backbone"]["layers_0"]
    layer = JaxLayer(ARCH["n_head"], ARCH["dim_ff"])

    def jax_loss_fn(p, xx):
        out = layer.apply({"params": p}, xx, deterministic=False,
                          extra=jnp.asarray(extra_np), pack=pack,
                          rs_override=(jnp.asarray(rs1), jnp.asarray(rs2)))
        return jnp.sum(out ** 2), out

    jax_ops.set_attention_impl("layer", interpret=True)
    ops.set_attention_impl("layer")
    launches = ops.fused_layer.LAUNCHES, ops.fused_layer.BWD_LAUNCHES
    try:
        (_, jout), (jg, jgx) = jax.value_and_grad(jax_loss_fn, argnums=(0, 1),
                                                   has_aux=True)(lp, jnp.asarray(x))
        tl = port_model(weights_sd).layers[0]
        xt = torch.from_numpy(x).requires_grad_()
        out = tl(xt, (torch.from_numpy(rs1), torch.from_numpy(rs2)), None,
                 torch.from_numpy(extra_np))
        (out ** 2).sum().backward()
    finally:
        jax_ops.set_attention_impl(None)
        ops.set_attention_impl(None)
    # the plain versions on CPU tensors launch nothing, so count nothing
    assert launches == (ops.fused_layer.LAUNCHES, ops.fused_layer.BWD_LAUNCHES)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    theirs = {k[len("layers.0."):]: v for k, v in state_dict_from_flax(
        {"patch_embedding": {"linear": {"kernel": np.zeros((1, 1, 1, 1)), "bias": np.zeros(1)}},
         "cls_token": 0, "pos_embed": 0, "norm": {"scale": 0, "bias": 0},
         "layers_0": jax.tree.map(np.asarray, jg)}).items() if k.startswith("layers.0.")}
    ours = {k: p.grad.numpy() for k, p in tl.named_parameters()}
    theirs["x"], ours["x"] = np.asarray(jgx), xt.grad.numpy()
    close_scaled(ours, theirs, TOL, "packed layer grad")
    # a dropped crop passes x through both branches: its tokens are unchanged
    dropped = (rs1[0] == 0) & (rs2[0] == 0)
    if dropped.any():
        np.testing.assert_array_equal(out.detach().numpy()[0, dropped], x[0, dropped])


def test_layer_dispatch_takes_the_attention_layer_for_packed_rows(weights_sd, monkeypatch):
    """vit.py:233-282: packed rows take 'layer' at any token count; with
    token-level scales B1 runs without a row scale (the scales applied
    outside), with per-sample ones it takes them as its row scale."""
    calls = []
    real = ops.fused_attention_layer

    def spy(*args, **kw):
        calls.append({k: kw.get(k) for k in ("extra", "row_scale")})
        return real(*args, **kw)

    monkeypatch.setattr(ops, "fused_attention_layer", spy)
    tl = port_model(weights_sd).layers[0]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(32, 111, ARCH["dim"])).astype(np.float32))
    extra = pack_mask(3, 37, "cpu")
    rs = torch.from_numpy(token_scales(rng, 32, 3, 37))
    with torch.no_grad():
        tl(x, (rs, rs), None, extra)
        tl(x, (torch.ones(32), torch.ones(32)), None, extra)
        tl(x[:, :37], None, None, None)  # 37 unpacked tokens: einsum
    assert len(calls) == 2
    assert calls[0]["extra"] is extra and calls[0]["row_scale"] is None
    assert calls[1]["row_scale"] is not None


# ---------------------------------------------------------------------------
# the multi-crop backbone and the pos-embed resize
# ---------------------------------------------------------------------------


def test_crop_pack_rule():
    assert crop_pack(24, 37) == 3 and crop_pack(8, 37) == 2 and crop_pack(7, 37) == 1
    assert crop_pack(6, 65) == 1 and crop_pack(6, 197) == 1 and crop_pack(4, 50) == 2
    m = pack_mask(3, 2, "cpu")
    assert m.shape == (6, 6) and m[0, 1] == 0 and m[1, 2] == -1e9 and m[5, 4] == 0


def test_crop_pack_honours_vtx_pack_model(monkeypatch):
    monkeypatch.setenv("VTX_PACK_MODEL", "0")
    assert crop_pack(24, 37) == 1


def test_pos_embed_resize_matches_jax(weights_sd):
    params = jax_params(weights_sd)["backbone"]
    jmodel = JaxDINOConfig(**ARCH).make().backbone
    theirs = jmodel.apply({"params": params}, 36, method=JaxViT.interpolate_pos_embedding)
    ours = port_model(weights_sd).interpolate_pos_embedding(36).detach()
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6, rtol=0)
    # torch's own bicubic (F.interpolate, align_corners False, no antialias)
    # gives the same grid at 14 → 6, up to the matrix's f32 weights
    grid = torch.from_numpy(weights_sd["pos_embed"][0, 1:]).reshape(14, 14, -1)
    ref = F.interpolate(grid.permute(2, 0, 1)[None].double(), size=(6, 6), mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0).reshape(36, -1)
    np.testing.assert_allclose(ours[0, 1:].numpy(), ref.numpy(), atol=1e-6, rtol=0)
    W = torch_bicubic_matrix(14, 6)
    np.testing.assert_allclose(W.sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("n_local", [6, 2], ids=["locals_pack3", "locals_pack2"])
def test_grouped_packed_backbone_matches_jax(weights_sd, n_local):
    """2 globals (224) and ``n_local`` locals (96) of 3 images: the globals
    one group of 6 × 197 tokens, the locals one packed group (18 crops → 6
    rows of 111; 6 crops → 2 rows of 111, pack 3)."""
    rng = np.random.default_rng(7)
    b = 3
    crops = [rng.normal(size=(b, s, s, 3)).astype(np.float32)
             for s in [224] * 2 + [96] * n_local]
    params = jax_params(weights_sd)["backbone"]
    jmodel = JaxDINOConfig(**ARCH).make().backbone
    # one XLA program, not op-by-op dispatch
    theirs = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                              [jnp.asarray(c) for c in crops]))
    model = port_model(weights_sd).eval()
    model.head = None  # the trunk's features
    with torch.no_grad():
        ours = model([torch.from_numpy(c).permute(0, 3, 1, 2) for c in crops]).numpy()
    assert ours.shape == theirs.shape == (b * (2 + n_local), ARCH["dim"])
    np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_last_layer", [False, True], ids=["last_g", "frozen_gain"])
def test_dino_head_matches_jax(norm_last_layer):
    rng = np.random.default_rng(3)
    kw = dict(out_dim=100, norm_last_layer=norm_last_layer, depth=3, dim_ff=96,
              dim_bottleneck=32)
    jhead = JaxDINOHead(**kw)
    x = rng.normal(size=(5, 48)).astype(np.float32)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    if not norm_last_layer:  # unit gains would hide the gain's gradient
        params = {**params, "last_g": jnp.asarray(1 + 0.2 * rng.normal(size=100),
                                                  jnp.float32)}
    assert ("last_g" in params) != norm_last_layer
    R = rng.normal(size=(5, 100)).astype(np.float32)

    def f(p, xx):
        out = jhead.apply({"params": p}, xx)
        return jnp.sum(out * R), out

    (_, jout), (jg, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    sd = weights._dino_head_from_flax(jax.tree.map(np.asarray, params))
    head = DINOHead(48, **{"out_dim": 100, "norm_last_layer": norm_last_layer, "depth": 3,
                           "dim_ff": 96, "dim_bottleneck": 32})
    head.load_state_dict({k[len("head."):]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = head(xt)
    (out * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    theirs = {k[len("head."):]: v for k, v in
              weights._dino_head_from_flax(jax.tree.map(np.asarray, jg)).items()}
    ours = {k: p.grad.numpy() for k, p in head.named_parameters()}
    if norm_last_layer:  # the frozen gain is a buffer: no parameter, no gradient
        del theirs["last.weight_g"]
        assert "last.weight_g" in head.state_dict()
    theirs["x"], ours["x"] = np.asarray(jgx), xt.grad.numpy()
    close_scaled(ours, theirs, 1e-5, "head grad")


def test_dino_head_use_bn_is_not_ported():
    with pytest.raises(NotImplementedError, match="use_bn"):
        DINOConfig(**{**ARCH, "use_bn": True}).make()


# ---------------------------------------------------------------------------
# loss, center, schedules, weight-decay mask
# ---------------------------------------------------------------------------


def test_dino_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(11)
    n_crop, b, K = 5, 3, 64
    s = rng.normal(size=(n_crop * b, K)).astype(np.float32)
    t = rng.normal(size=(2 * b, K)).astype(np.float32)
    c = 0.1 * rng.normal(size=(1, K)).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda ss: jax_loss.dino_loss(
        ss, jnp.asarray(t), jnp.asarray(c), 0.04, n_crop))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    loss = L.dino_loss(st, torch.from_numpy(t), torch.from_numpy(c), 0.04, n_crop)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    # the gradient in another summation order: within 1e-5 relative, and
    # 1e-7 absolute for entries far below its largest (~0.3)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
    new = L.update_center(torch.from_numpy(c), torch.from_numpy(t), 0.9)
    np.testing.assert_allclose(new.numpy(), np.asarray(jax_loss.update_center(
        jnp.asarray(c), jnp.asarray(t), 0.9)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("warm,epochs", [(30, 300), (3, 5), (1, 4), (0, 2)])
def test_teacher_temperature_schedule_matches_jax(warm, epochs):
    assert L.teacher_temperature_schedule(0.04, 0.07, warm, epochs) == \
        jax_loss.teacher_temperature_schedule(0.04, 0.07, warm, epochs)


@pytest.mark.parametrize("warmup", [0, 1, 5])
def test_cosine_schedule_matches_jax(warmup):
    assert cosine_schedule(0.04, 0.4, 40, warmup, 0.01) == \
        jax_cosine(0.04, 0.4, 40, warmup, 0.01)


def test_dino_wd_mask_matches_jax(weights_sd):
    params = jax_params(weights_sd)
    theirs = state_dict_from_flax(jax.tree.map(
        lambda m, p: np.full(p.shape, m), jax_wd_mask(params, "dino"), params))
    model = port_model(weights_sd)
    ours = optim.wd_mask(dict(model.named_parameters()), "dino")
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert np.all(theirs[k] == ours[k]), k
    # the reference's rule: the [out, 1] gain decays, like cls_token and
    # pos_embed; biases and the 1-D LayerNorm parameters do not
    assert ours["head.last.weight_g"] and ours["cls_token"] and ours["pos_embed"]
    assert not ours["norm.weight"] and not ours["head.mlp.0.bias"]


# ---------------------------------------------------------------------------
# the colour ops, fed JAX's draws
# ---------------------------------------------------------------------------


B_IMG = 6


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2).random((B_IMG, 20, 24, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.array(np.asarray(x).transpose(0, 3, 1, 2)))


def bernoulli(key, p, n):
    return torch.from_numpy(np.array(jax.random.bernoulli(key, p, (n,))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_hflip_grayscale_solarize_applies_match_jax(images):
    key = jax.random.PRNGKey(4)
    x = jnp.asarray(images)
    cases = [
        (jax_data_ops.random_hflip(key, x, p=0.5),
         data_ops.apply_hflip(nchw(images), bernoulli(key, 0.5, B_IMG))),
        (jax_data_ops.random_grayscale(key, x, p=0.5),
         data_ops.apply_grayscale(nchw(images), bernoulli(key, 0.5, B_IMG))),
        (jax_data_ops.random_solarize(key, x, p=0.5),
         data_ops.apply_solarize(nchw(images), bernoulli(key, 0.5, B_IMG))),
    ]
    for theirs, ours in cases:
        np.testing.assert_allclose(nhwc(ours), np.asarray(theirs), atol=1e-6, rtol=0)
    gates = np.asarray(jax.random.bernoulli(key, 0.5, (B_IMG,)))
    assert gates.any() and not gates.all()  # both kinds of sample


def jax_jitter_draws(key, b, brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1, p=0.8):
    """The per-sample draws of the JAX ``color_jitter`` (data/ops.py:236-277)."""
    def one(k):
        k_gate, k_b, k_c, k_s, k_h, k_ord = jax.random.split(k, 6)
        return (jax.random.bernoulli(k_gate, p),
                jax.random.uniform(k_b, (), minval=1 - brightness, maxval=1 + brightness),
                jax.random.uniform(k_c, (), minval=1 - contrast, maxval=1 + contrast),
                jax.random.uniform(k_s, (), minval=1 - saturation, maxval=1 + saturation),
                jax.random.uniform(k_h, (), minval=-hue, maxval=hue),
                jax.random.permutation(k_ord, 4))
    d = jax.vmap(one)(jax.random.split(key, b))
    return {k: torch.from_numpy(np.array(v)) for k, v in
            zip(("gate", "fb", "fc", "fs", "fh", "order"), d)}


def test_color_jitter_apply_matches_jax(images):
    key = jax.random.PRNGKey(9)
    theirs = jax_data_ops.color_jitter(key, jnp.asarray(images), p=0.8)
    draws = jax_jitter_draws(key, B_IMG)
    draws["order"] = draws["order"].long()
    assert len({tuple(o) for o in draws["order"].tolist()}) > 1  # orders differ
    ours = data_ops.apply_color_jitter(nchw(images), draws)
    np.testing.assert_allclose(nhwc(ours), np.asarray(theirs), atol=1e-5, rtol=0)


def test_gaussian_blur_apply_matches_jax(images):
    key = jax.random.PRNGKey(6)
    theirs = jax_data_ops.gaussian_blur(key, jnp.asarray(images), p=0.5)

    def one(k):
        k_gate, k_r = jax.random.split(k)
        return (jax.random.bernoulli(k_gate, 0.5),
                jax.random.uniform(k_r, (), minval=0.1, maxval=2.0))
    gate, radius = jax.vmap(one)(jax.random.split(key, B_IMG))
    draws = {"gate": torch.from_numpy(np.array(gate)),
             "radius": torch.from_numpy(np.array(radius))}
    assert draws["gate"].any() and not draws["gate"].all()
    ours = data_ops.apply_gaussian_blur(nchw(images), draws)
    np.testing.assert_allclose(nhwc(ours), np.asarray(theirs), atol=1e-5, rtol=0)


def test_device_augment_gives_normalized_crops():
    from vision_transformers_tpu_torch.data.dino import make_dino_device_augment
    from vision_transformers_tpu_torch.data.synthetic import synthetic_dino_batches

    batch = next(synthetic_dino_batches(4, 32, 16, 3, 1, seed=0))
    crops = make_dino_device_augment(3)(torch.Generator().manual_seed(0),
                                        torch.from_numpy(batch["globals"]),
                                        torch.from_numpy(batch["locals"]))
    assert [tuple(c.shape) for c in crops] == [(4, 3, 32, 32)] * 2 + [(4, 3, 16, 16)] * 3
    assert all(c.dtype == torch.float32 and torch.isfinite(c).all() for c in crops)
    lo = (0 - max(data_ops.IMAGENET_MEAN)) / min(data_ops.IMAGENET_STD)
    hi = (1 - min(data_ops.IMAGENET_MEAN)) / min(data_ops.IMAGENET_STD)
    assert all(lo - 1e-5 <= c.min() and c.max() <= hi + 1e-5 for c in crops)


# ---------------------------------------------------------------------------
# flax → state_dict, seeded weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [dict(), dict(norm_last_layer=True),
                                  dict(depth_head=1), dict(depth_head=2)],
                         ids=["last_g", "frozen_gain", "depth_head_1", "depth_head_2"])
def test_dino_state_dict_round_trips_through_flax(arch):
    sd = seeded_state_dict(DINOConfig(**{**ARCH, **arch}), seed=2)
    back = state_dict_from_flax(jax.tree.map(np.asarray, jax_params(sd, **arch)))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    port_model(sd, **arch)  # loads with strict=True
    assert sd["head.last.weight_v"].shape == (ARCH["dim_head_out"], ARCH["dim_head_bottleneck"])
    assert sd["head.last.weight_g"].shape == (ARCH["dim_head_out"], 1)
