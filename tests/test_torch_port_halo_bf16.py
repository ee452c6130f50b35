"""Halo-S's path at the JAX package's default precision, bf16, against the
JAX package at dtype bfloat16.

- The whole Halo layer B4 (window 4 / halo 1, both row scales at keep 0.9,
  whose 1/0.9 bf16 rounds to 1.109375): its output and every gradient (x,
  both LayerNorms, the four weights and three biases, the bias — f32 —
  and both row scales), the halo attention off the maps B5a (window 4 /
  halo 1) and gathered B5b (window 4 / halo 3: 100 keys a window), output
  and dq / dkv / dbias: the port's plain versions on the CPU (the CUDA
  kernels' rounding points) against the JAX Pallas kernels in interpret
  mode at bf16, on the same numpy-seeded inputs.
- A tiny Halo (two layers, window 2 / halo 1, heads 8 wide) at bf16 on the
  default 'layer' dispatch, with the JAX model's f32 params carried into
  the port through ``state_dict_from_flax``: logits and one train step's
  loss and gradients (the relative-position tables among them) against the
  JAX Halo at bf16 on its whole-layer kernel; the 'direct', 'gather' and
  'einsum' paths' logits against the same.
- The trainer at the Halo-S conf's default precision (``precision``
  unset): ``check_supported`` takes it, and a tiny bf16 epoch writes f32
  checkpoints.

The limit is JAX's own bf16 error from the same inputs (JAX at f32: the
JAX package's jnp references of the same math, tests/test_fused_halo_layer.py
and tests/test_fused_halo.py hold the kernels to them, for the ops; the
einsum path for the model): max|port − JAX bf16| ≤ 3 · max|JAX bf16 − JAX f32| for outputs,
logits and the loss, and per gradient the relative Frobenius error within
3 × JAX's own (tests/test_torch_port_bf16_ops.py's rule).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.config import registry as jax_registry
from vision_transformers_tpu.ops.fused_halo import halo_attention as jax_halo_attention
from vision_transformers_tpu.ops.fused_halo import \
    halo_attention_direct as jax_halo_attention_direct
from vision_transformers_tpu.ops.fused_halo_layer import \
    fused_halo_layer as jax_fused_halo_layer
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.config.schema import load_config
from vision_transformers_tpu_torch.models.halo import HaloConfig
from vision_transformers_tpu_torch.ops import fused_halo, fused_halo_layer
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.train.trainer import check_supported, compute_dtype
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         seeded_train_batch,
                                                         state_dict_from_flax, to_torch)
from test_fused_halo import ref_halo, ref_halo_map
from test_fused_halo_layer import ref_halo_layer
from test_torch_port_bf16_ops import KEEP, assert_grad_within_gap, assert_within_gap
from test_torch_port_halo_ops import layer_inputs
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
bf = torch.bfloat16
# 2 images, an 8x8 map, C 32, 2 heads 16 wide (F = 2C)
B, H, W, C, NH, D = 2, 8, 8, 32, 2, 16
# the layer's inputs that stay f32: the LayerNorms' parameters and the bias
F32_ARGS = {1, 2, 6, 7, 12}
F32_GRADS = {"dln1_scale", "dln1_bias", "dln2_scale", "dln2_bias", "dbias", "drs_attn",
             "drs_ff"}


def row_scales():
    """Two DropPath scales of kept (1/0.9) and dropped (0) images, f32."""
    return (np.array([1 / KEEP, 0.0], np.float32), np.array([0.0, 1 / KEEP], np.float32))


def jax_grads(fn, inputs, w):
    """(out, grads of sum(out · w)) of ``fn`` on the JAX ``inputs``, f32."""
    def f(*a):
        out = fn(*a)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=tuple(range(len(inputs))),
                                                 has_aux=True))(*inputs)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def port_grads(fn, inputs, w):
    """(out, grads of sum(out · w)) of the port's ``fn``, as f32 numpy."""
    out = fn(*inputs)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out.detach().float().numpy(), [t.grad for t in inputs]


def check(names, ours, bf16, f32, f32_names=()):
    """Every output within 3x JAX's bf16 gap; the gradients in their dtype
    (f32 where ``f32_names``, else bf16)."""
    (out, grads), (out_bf, grads_bf), (out_f32, grads_f32) = ours, bf16, f32
    assert_within_gap("out", out, out_bf, out_f32)
    for name, g, gb, gf in zip(names, grads, grads_bf, grads_f32):
        assert g.dtype == (torch.float32 if name in f32_names else bf), (name, g.dtype)
        assert_grad_within_gap(name, g.float().numpy(), gb, gf)


# ---------------------------------------------------------------------------
# the ops: B4, B5a, B5b
# ---------------------------------------------------------------------------


def test_b4_bf16_forward_and_grads_within_jax_gap():
    args, _, _, w = layer_inputs(B, H, W, C, NH, D, 4, 1, rs=False, seed=11)
    r1, r2 = row_scales()
    kw = dict(window=4, halo=1)

    def jax_side(dtype):
        inputs = [jnp.asarray(a, jnp.float32 if i in F32_ARGS else dtype)
                  for i, a in enumerate(args)] + [jnp.asarray(r1), jnp.asarray(r2)]
        if dtype == jnp.float32:  # the JAX package's jnp reference of the same math
            return jax_grads(lambda *a: ref_halo_layer(a, NH, 4, 1, D ** -0.5), inputs, w)
        return jax_grads(lambda *a: jax_fused_halo_layer(*a[:13], NH, a[13], a[14], **kw,
                                                         interpret=True), inputs, w)

    inputs = [torch.from_numpy(a).to(torch.float32 if i in F32_ARGS else bf).requires_grad_()
              for i, a in enumerate(args)] + [torch.from_numpy(r).requires_grad_()
                                              for r in (r1, r2)]
    launches = fused_halo_layer.LAUNCHES, fused_halo_layer.BWD_LAUNCHES
    ours = port_grads(lambda *a: fused_halo_layer.fused_halo_layer(
        *a[:13], NH, a[13], a[14], **kw), inputs, w)
    # a CPU tensor takes the plain versions: no kernel launch counted
    assert (fused_halo_layer.LAUNCHES, fused_halo_layer.BWD_LAUNCHES) == launches
    check(fused_halo_layer.GRAD_NAMES, ours, jax_side(jnp.bfloat16), jax_side(jnp.float32),
          F32_GRADS)


def test_b4_bf16_saves_and_serving_forward():
    """The training forward's saves at the kernels' dtypes, its out equal
    to the serving forward's, and the scales rounded to bf16 before they
    multiply (the branch of a kept image scaled by 1.109375)."""
    args, _, _, _ = layer_inputs(B, H, W, C, NH, D, 4, 1, rs=False, seed=12)
    a = [torch.from_numpy(t).to(torch.float32 if i in F32_ARGS else bf)
         for i, t in enumerate(args)]
    r1, r2 = (torch.from_numpy(r) for r in row_scales())
    kw = dict(window=4, halo=1)
    out, saved = fused_halo_layer.fused_halo_layer_fwd(*a, NH, r1, r2, **kw)
    for name in ("qkv", "acc", "z", "hid"):
        assert getattr(saved, name).dtype == bf, name
    for name in ("mu1", "rstd1", "lse", "mu2", "rstd2", "bias"):
        assert getattr(saved, name).dtype == torch.float32, name
    assert torch.equal(out, fused_halo_layer.fused_halo_layer(*a, NH, r1, r2, **kw))
    # image 1 drops the attention branch: z = x there; image 0 keeps it at
    # round(1/0.9) = 1.109375, so the scale 1.109375 itself gives the same
    # z and out bit for bit
    assert torch.equal(saved.z[1], a[0][1])
    exact = [torch.tensor([1.109375, 0.0]), torch.tensor([0.0, 1.109375])]
    out_x, saved_x = fused_halo_layer.fused_halo_layer_fwd(*a, NH, *exact, **kw)
    assert torch.equal(saved_x.z, saved.z) and torch.equal(out_x, out)
    assert not torch.equal(saved.z[0], a[0][0])


def direct_inputs(seed, window, halo, gathered):
    rng = np.random.default_rng(seed)
    k = window + 2 * halo
    n = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    bias = n(NH, window * window, k * k, sc=0.5)
    if gathered:
        nw = B * (H // window) * (W // window)
        return [n(nw, window * window, NH * D), n(nw, k * k, 2 * NH * D), bias], \
            n(nw, window * window, NH * D)
    return [n(B, H, W, NH * D), n(B, H, W, 2 * NH * D), bias], n(B, H, W, NH * D)


@pytest.mark.parametrize("window,halo,gathered", [(4, 1, False), (4, 3, True)],
                         ids=["B5a w4h1", "B5b w4h3"])
def test_halo_attention_bf16_within_jax_gap(window, halo, gathered):
    args, w = direct_inputs(13, window, halo, gathered)
    # JAX at bf16: the Pallas kernel interpreted; at f32: the JAX package's
    # jnp reference of the same math
    if gathered:
        jax_fn = lambda q, kv, b: jax_halo_attention(q, kv, b, NH, interpret=True)  # noqa: E731
        ref_fn = lambda q, kv, b: ref_halo(q, kv, b, NH)  # noqa: E731
        port_fn = lambda q, kv, b: fused_halo.halo_attention(q, kv, b, NH)  # noqa: E731
    else:
        jax_fn = lambda q, kv, b: jax_halo_attention_direct(  # noqa: E731
            q, kv, b, window, halo, NH, interpret=True)
        ref_fn = lambda q, kv, b: ref_halo_map(q, kv, b, window, halo, NH)  # noqa: E731
        port_fn = lambda q, kv, b: fused_halo.halo_attention_direct(  # noqa: E731
            q, kv, b, window, halo, NH)

    def jax_side(dtype):
        return jax_grads(jax_fn if dtype == jnp.bfloat16 else ref_fn,
                         [jnp.asarray(args[0], dtype), jnp.asarray(args[1], dtype),
                          jnp.asarray(args[2])], w)

    inputs = [torch.from_numpy(args[0]).to(bf).requires_grad_(),
              torch.from_numpy(args[1]).to(bf).requires_grad_(),
              torch.from_numpy(args[2]).requires_grad_()]
    check(("dq", "dkv", "dbias"), port_grads(port_fn, inputs, w), jax_side(jnp.bfloat16),
          jax_side(jnp.float32), {"dbias"})


# ---------------------------------------------------------------------------
# a tiny Halo at bf16
# ---------------------------------------------------------------------------

TINY = dict(image_size=64, n_class=10, depths=[1, 1, 0, 0], dims=[16, 32, 64, 64],
            dim_head=8, n_heads=[2, 4, 8, 8], dim_ffs=[32, 64, 128, 128], window_size=2,
            halo_size=1)


def jax_run(cfg, variables, batch, dtype, impl):
    """(logits, loss, {state_dict key: grad}) of one JAX train step (drop
    path 0: the logits are the eval's) at ``dtype`` on ``impl`` ('layer':
    the Pallas kernel interpreted)."""
    model = cfg.make(dtype=dtype)

    def f(p):
        logits = model.apply({"params": p}, batch["image"], deterministic=False)
        return jax_loss.mix_loss(logits, batch["label1"], batch["label2"], batch["ratio"],
                                 eps=0.1), logits

    jax_ops.set_attention_impl(impl, interpret=impl == "layer")
    try:
        (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            variables["params"])
    finally:
        jax_ops.set_attention_impl(None)
    return (np.asarray(logits, np.float32), float(loss),
            state_dict_from_flax(jax.tree.map(lambda g: np.asarray(g, np.float32), grads)))


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_registry.build("model", {"type": "halo_transformer", **TINY})
    sd = seeded_state_dict(HaloConfig(**TINY), seed=9)
    variables = jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))
    batch = {k: jnp.asarray(v) for k, v in seeded_train_batch(9, 2, 64, 10).items()}
    return (variables, batch, jax_run(cfg, variables, batch, jnp.bfloat16, "layer"),
            jax_run(cfg, variables, batch, jnp.float32, "einsum"))


def port_bf16(variables):
    """The port's bf16 Halo with the JAX model's f32 params."""
    model = HaloConfig(**TINY).make(dtype=bf)
    sd = state_dict_from_flax(jax.tree.map(np.asarray, variables["params"]))
    model.load_state_dict(to_torch(sd), strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return model


def test_tiny_halo_bf16_logits_and_train_step_within_jax_gap(tiny):
    variables, batch, (logits_bf, loss_bf, grads_bf), (logits_f32, loss_f32, grads_f32) = tiny
    model = port_bf16(variables)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    x = tb["image"].permute(0, 3, 1, 2)
    launches = fused_halo_layer.LAUNCHES
    with torch.no_grad():
        logits = model.eval()(x)
    model.train()
    loss = L.mix_loss(model(x), tb["label1"].long(), tb["label2"].long(), tb["ratio"],
                      eps=0.1)
    loss.backward()
    assert fused_halo_layer.LAUNCHES == launches  # the CPU runs the plain versions
    assert logits.dtype == torch.float32  # the classifier computes in f32
    assert_within_gap("logits", logits.numpy(), logits_bf, logits_f32)
    assert abs(float(loss.detach()) - loss_bf) <= 3 * abs(loss_bf - loss_f32)
    ours = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(grads_bf) == set(ours)
    assert sum(k.endswith("attn.rel_pos.weight") for k in grads_bf) == 2
    for k in grads_bf:
        assert_grad_within_gap(k, ours[k], grads_bf[k], grads_f32[k])


@pytest.mark.parametrize("path", ["direct", "gather", "einsum"])
def test_tiny_halo_bf16_paths_within_jax_gap(tiny, path):
    """The attention-alone paths at bf16 (the projections in bf16 between,
    the einsum path's scores in bf16, its softmax f32) against JAX's bf16
    logits on the whole-layer kernel, within the same limit."""
    variables, batch, (logits_bf, _, _), (logits_f32, _, _) = tiny
    model = port_bf16(variables).eval()
    x = torch.from_numpy(np.array(batch["image"])).permute(0, 3, 1, 2)
    ops.set_halo_impl(path)
    try:
        with torch.no_grad():
            logits = model(x)
    finally:
        ops.set_halo_impl(None)
    assert_within_gap(path, logits.numpy(), logits_bf, logits_f32)


# ---------------------------------------------------------------------------
# the trainer at the conf's default precision
# ---------------------------------------------------------------------------

TINY_OVERRIDES = ["training.epoch=1", "training.dataloader.batch_size=8",
                  "data_backend=synthetic", "arch.image_size=64", "arch.window_size=2",
                  "arch.halo_size=1", "arch.depths=[1, 1, 0, 0]", "arch.dims=[8, 16, 32, 64]",
                  "arch.dim_head=8", "arch.n_heads=[1, 2, 4, 8]",
                  "arch.dim_ffs=[16, 32, 64, 128]", "arch.n_class=10",
                  "training.train_size=64", "training.valid_size=64", "n_device=1"]


def test_trainer_takes_halo_at_its_default_precision(tmp_path):
    conf = os.path.join(ROOT, "tests", "data", "halo_s_port.conf")
    c = load_config(conf)
    assert c.precision == "bf16" and compute_dtype(c) == bf
    check_supported(c)
    from vision_transformers_tpu_torch import train

    store = f"checker.storage=[{{type: local, path: {tmp_path}}}]"
    metrics = train.main(["--conf", conf, "--device", "cpu", store, *TINY_OVERRIDES])
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["valid_loss"])
    obj = torch.load(os.path.join(tmp_path, "epoch-001.pt"), weights_only=False)
    assert all(v.dtype == torch.float32 for v in obj["model"].values())
