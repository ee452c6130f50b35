"""Swin-S's path at the JAX package's default precision, bf16, against the
JAX package at dtype bfloat16.

- The whole layer B2 with Swin's grouped bias [G, H, N, N] (f32) and both
  per-sample row scales: its training forward (with saves) and backward
  (every gradient: x, both LayerNorms, the four weights and their biases,
  the bias — summed in f32 over each group's rows — and both row scales),
  the port's plain versions on the CPU (the CUDA kernels' rounding points)
  against the JAX Pallas kernel in interpret mode at bf16, at an odd small
  shape (18 tokens, 3 groups of 2 rows, heads 16 wide).
- The attention layer B1's bf16 backward with the bias's gradient, the
  same way.
- A tiny Swin (one shifted layer, window 2, packed pairs, heads 8 wide,
  the patch merges of three stages without layers; the golden test holds
  every stage of the full-width model) at bf16 on 'layer1': its logits and
  one train step's loss and gradients (the relative-position table among
  them); at bf16 on its small-batch default, the plain einsum path, its
  logits against JAX's bf16 'layer1' logits within the same limit.
- The trainer at the Swin conf's default precision (``precision`` unset):
  ``check_supported`` takes it, and a tiny bf16 epoch writes f32
  checkpoints.

The limit is JAX's own bf16 error from the same inputs (JAX at f32: the
JAX package's pure-jnp reference of the same math, ``_attn_layer_ref`` and
the FF half in jnp, for the ops; the einsum path for the model): max|port − JAX bf16| ≤ 3 · max|JAX bf16 − JAX f32| for outputs,
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
from vision_transformers_tpu.ops.fused_layer import _attn_layer_ref
from vision_transformers_tpu.ops.fused_layer import \
    fused_attention_layer as jax_fused_attention_layer
from vision_transformers_tpu.ops.fused_layer1 import \
    fused_transformer_layer as jax_fused_transformer_layer
from vision_transformers_tpu.models.swin import SwinConfig as JaxSwinConfig
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.config.schema import load_config
from vision_transformers_tpu_torch.models.swin import SwinConfig
from vision_transformers_tpu_torch.ops import fused_layer, fused_layer1
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.train.trainer import check_supported, compute_dtype
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         state_dict_from_flax, to_torch)
from test_torch_port_bf16_ops import (assert_grad_within_gap, assert_within_gap, jax_inputs,
                                      make_args, port_inputs, row_scale)
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
bf = torch.bfloat16
# B = 6 rows in G = 3 groups, N = 18 tokens, C = 40, H = 2 heads 16 wide, F = 80
B, N, C, H, D, G = 6, 18, 40, 2, 16, 3
F = 2 * C
L1_NAMES = ("dx", "dln1_scale", "dln1_bias", "dwqkv", "dbqkv", "dwout", "dbout",
            "dln2_scale", "dln2_bias", "dw1", "db1", "dw2", "db2", "dextra", "drs_attn",
            "drs_ff")
# the gradients that stay f32 at bf16: LN parameters, the bias, row scales
F32_GRADS = {"dln1_scale", "dln1_bias", "dln2_scale", "dln2_bias", "dln_scale", "dln_bias",
             "dextra", "drs_attn", "drs_ff", "drs"}


def bias(seed=4):
    """A seeded grouped bias [G, H, N, N] f32 with Swin-like −1e9 entries."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(G, H, N, N)).astype(np.float32)
    e[1, :, :9, 9:] = -1e9  # a shift-masked block in one group
    return e


def jax_b2_f32(a):
    """The whole layer in f32 jnp: _attn_layer_ref, then the FF half."""
    z = _attn_layer_ref(*a[:7], a[13], a[14], H, D ** -0.5, 1e-6)
    mu = z.mean(-1, keepdims=True)
    var = (z * z).mean(-1, keepdims=True) - mu * mu
    u = (z - mu) * jax.lax.rsqrt(var + 1e-6) * a[7] + a[8]
    out = jax.nn.silu(u @ a[9] + a[10]) @ a[11] + a[12]
    return z + out * a[15][:, None, None]


def jax_b2(args, extra, r, dtype):
    """(out, grads of sum(out²)) of the JAX package at ``dtype``: its Pallas
    kernel in bf16 (interpreted), the jnp reference in f32."""
    inputs = jax_inputs(args, dtype) + [jnp.asarray(extra), jnp.asarray(r), jnp.asarray(r)]

    def f(*a):
        if dtype == jnp.float32:
            out = jax_b2_f32(a)
        else:
            out = jax_fused_transformer_layer(*a[:13], H, a[13], a[14], a[15], "silu",
                                              interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    grad_fn = jax.value_and_grad(f, argnums=tuple(range(len(inputs))), has_aux=True)
    (_, out), grads = jax.jit(grad_fn)(*inputs)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


@pytest.fixture(scope="module")
def b2_case():
    args = make_args(B, N, C, H, D, F, seed=21)
    r = row_scale(B)
    return args, r, jax_b2(args, bias(), r, jnp.bfloat16), jax_b2(args, bias(), r,
                                                                  jnp.float32)


def test_b2_bf16_forward_and_grads_with_grouped_bias_within_jax_gap(b2_case):
    args, r, (out_bf, grads_bf), (out_f32, grads_f32) = b2_case
    inputs = port_inputs(args, bf, grad=True)
    extra = torch.from_numpy(bias()).requires_grad_()
    rs = [torch.from_numpy(r).requires_grad_() for _ in range(2)]
    out = fused_layer1.fused_transformer_layer(*inputs, H, extra, *rs, activation="silu")
    (out.float() ** 2).sum().backward()
    assert out.dtype == bf
    assert_within_gap("out", out.detach().float().numpy(), out_bf, out_f32)
    grads = [t.grad for t in inputs] + [extra.grad] + [t.grad for t in rs]
    for name, g, gb, gf in zip(L1_NAMES, grads, grads_bf, grads_f32):
        assert g is not None, name
        assert g.dtype == (torch.float32 if name in F32_GRADS else bf), (name, g.dtype)
        assert_grad_within_gap(name, g.float().numpy(), gb, gf)


def test_b2_bf16_saves_and_backward_steps(b2_case):
    """The training forward's saves at bf16 (the kernels' dtypes), its out
    equal to the serving forward's, and the step-by-step plain backward
    equal to autograd's through the op (dextra grouped, f32)."""
    args, r, *_ = b2_case
    inputs = port_inputs(args, bf)
    extra = torch.from_numpy(bias())
    rs = torch.from_numpy(r)
    out, saved = fused_layer1.fused_transformer_layer_fwd(*inputs, H, extra, rs, rs)
    with torch.no_grad():
        serve = fused_layer1.fused_transformer_layer(*inputs, H, extra, rs, rs)
    assert torch.equal(out, serve)
    for t in (saved.qkv, saved.acc, saved.z, saved.hid):
        assert t.dtype == bf
    for t in (saved.mu1, saved.rstd1, saved.lse, saved.mu2, saved.rstd2, saved.extra_g):
        assert t.dtype == torch.float32
    do = torch.from_numpy(np.random.default_rng(2).normal(size=(B, N, C))).to(bf)
    grads = fused_layer1.fused_transformer_layer_bwd(saved, do)
    assert grads[13].shape == (G, H, N, N) and grads[13].dtype == torch.float32
    assert grads[0].dtype == bf and grads[14].dtype == grads[15].dtype == torch.float32


def test_b1_bf16_bias_gradient_within_jax_gap():
    args = make_args(B, N, C, H, D, seed=22)
    r = row_scale(B)
    extra = bias(5)

    def jax_b1(dtype):
        inputs = jax_inputs(args, dtype) + [jnp.asarray(extra), jnp.asarray(r)]

        def f(*a):
            if dtype == jnp.float32:
                out = _attn_layer_ref(*a[:7], a[7], a[8], H, D ** -0.5, 1e-6)
            else:
                out = jax_fused_attention_layer(*a[:7], H, a[7], a[8], interpret=True)
            return jnp.sum(out.astype(jnp.float32) ** 2), out

        grad_fn = jax.value_and_grad(f, argnums=tuple(range(len(inputs))), has_aux=True)
        (_, out), grads = jax.jit(grad_fn)(*inputs)
        return (np.asarray(out.astype(jnp.float32)),
                [np.asarray(g.astype(jnp.float32)) for g in grads])

    (out_bf, grads_bf), (out_f32, grads_f32) = jax_b1(jnp.bfloat16), jax_b1(jnp.float32)
    inputs = port_inputs(args, bf, grad=True)
    e = torch.from_numpy(extra).requires_grad_()
    rs = torch.from_numpy(r).requires_grad_()
    out = fused_layer.fused_attention_layer(*inputs, H, extra=e, row_scale=rs)
    (out.float() ** 2).sum().backward()
    assert_within_gap("out", out.detach().float().numpy(), out_bf, out_f32)
    names = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwout", "dbout", "dextra",
             "drs")
    for name, g, gb, gf in zip(names, [t.grad for t in inputs] + [e.grad, rs.grad],
                               grads_bf, grads_f32):
        assert g.dtype == (torch.float32 if name in F32_GRADS else bf), (name, g.dtype)
        assert_grad_within_gap(name, g.float().numpy(), gb, gf)


def test_attention_bf16_bias_gradient_sums_each_groups_ds():
    """The thin door's plain backward with ``dbias``: the grouped dS sums,
    equal to the attention half's (f32 dS, summed over each group's rows)."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * D)).astype(np.float32)).to(bf)
    extra = torch.from_numpy(bias(6))
    out, lse = fused_layer.packed_attention_bf16(qkv, H, extra=extra)
    dout = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32)).to(bf)
    dqkv, dbias = fused_layer.packed_attention_bf16_bwd(qkv, out, lse, dout, H, extra=extra,
                                                        dbias=True)
    _, ds = fused_layer.attention_bwd_reference(
        qkv, out, lse, dout, H, D ** -0.5, extra, dtype=bf)
    assert dqkv.dtype == bf and dbias.shape == (G, H, N, N)
    assert torch.equal(dbias, ds.reshape(G, B // G, H, N, N).sum(1))
    assert torch.equal(dqkv, fused_layer.packed_attention_bf16_bwd(qkv, out, lse, dout, H,
                                                                   extra=extra))


# ---------------------------------------------------------------------------
# a tiny Swin at bf16 on 'layer1'
# ---------------------------------------------------------------------------

ARCH = dict(image_size=[32, 32], n_class=10, depths=[1, 0, 0, 0], dims=[16, 32, 64, 64],
            dim_head=8, n_heads=[2, 4, 8, 8], dim_ffs=[32, 64, 128, 128], window_size=2)


@pytest.fixture(scope="module")
def tiny():
    sd = seeded_state_dict(SwinConfig(**ARCH), seed=7)
    rng = np.random.default_rng([7, 1])
    n = 4
    batch = {"image": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
             "label1": rng.integers(0, 10, n).astype(np.int32),
             "label2": rng.integers(0, 10, n).astype(np.int32),
             "ratio": rng.uniform(0.2, 0.8, n).astype(np.float32)}
    return sd, batch


def jax_swin(sd, dtype):
    cfg = JaxSwinConfig(**ARCH)
    return cfg.make(dtype=dtype), jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))


def jax_run(sd, batch, dtype, impl):
    """(logits, loss, {state_dict key: grad}) of one JAX train step (drop
    path 0: the logits are the eval's) at ``dtype`` on ``impl`` (the Pallas
    kernels interpreted; None the einsum path)."""
    model, variables = jax_swin(sd, dtype)

    def f(p):
        logits = model.apply({"params": p}, batch["image"], deterministic=False)
        return jax_loss.mix_loss(logits, batch["label1"], batch["label2"], batch["ratio"],
                                 eps=0.1), logits

    jax_ops.set_attention_impl(impl, interpret=impl is not None)
    try:
        (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            variables["params"])
    finally:
        jax_ops.set_attention_impl(None)
    return (np.asarray(logits, np.float32), float(loss),
            state_dict_from_flax(jax.tree.map(lambda g: np.asarray(g, np.float32), grads)))


@pytest.fixture(scope="module")
def tiny_jax(tiny):
    sd, batch = tiny
    # one row at a time in the interpreted kernels' bodies: the same values,
    # a quarter of the trace to compile (the unroll only interleaves rows)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VTX_L1_UNROLL", "1")
        return (jax_run(sd, batch, jnp.bfloat16, "layer1"),
                jax_run(sd, batch, jnp.float32, None))


def test_tiny_swin_bf16_logits_and_train_step_within_jax_gap(tiny, tiny_jax):
    sd, batch = tiny
    (logits_bf, loss_bf, grads_bf), (logits_f32, loss_f32, grads_f32) = tiny_jax
    model = SwinConfig(**ARCH).make(dtype=bf)
    model.load_state_dict(to_torch(sd), strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2)
    launches = fused_layer1.LAUNCHES
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ops.set_attention_impl("layer1")  # 4 images: the dispatch would take einsum
    try:
        with torch.no_grad():
            logits = model.eval()(x)
        model.train()
        loss = L.mix_loss(model(x), tb["label1"].long(), tb["label2"].long(), tb["ratio"],
                          eps=0.1)
        loss.backward()
    finally:
        ops.set_attention_impl(None)
    assert logits.dtype == torch.float32  # the classifier computes in f32
    within = abs(logits.numpy() - logits_bf).max()
    assert within <= 3 * abs(logits_bf - logits_f32).max()
    assert fused_layer1.LAUNCHES == launches  # the CPU runs the plain versions
    assert abs(float(loss.detach()) - loss_bf) <= 3 * abs(loss_bf - loss_f32)
    ours = {k: p.grad.numpy() for k, p in model.named_parameters()}
    # every tensor JAX's state_dict maps (the merges of the stages without
    # layers, the port's block2.0 to block4.0, have no key there)
    assert set(grads_bf) <= set(ours) and len(grads_bf) == len(ours) - 9
    assert sum(k.endswith("attn.rel_pos.weight") for k in grads_bf) == 1
    for k in grads_bf:
        assert_grad_within_gap(k, ours[k], grads_bf[k], grads_f32[k])


def test_tiny_swin_bf16_einsum_within_jax_gap_and_kernel_forces_raise(tiny, tiny_jax):
    """At bf16 the plain 'einsum' path (small batches, dropout) runs in
    bf16, within the limit of JAX's bf16 logits; the 'fused' and 'block'
    forces raise, naming the queue."""
    sd, batch = tiny
    (logits_bf, _, _), (logits_f32, _, _) = tiny_jax
    model = SwinConfig(**ARCH).make(dtype=bf)
    model.load_state_dict(to_torch(sd), strict=True)
    x = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2)
    launches = fused_layer1.LAUNCHES, fused_layer.LAUNCHES
    with torch.no_grad():
        ours = model.eval()(x).numpy()  # 4 images: the einsum path
    assert (fused_layer1.LAUNCHES, fused_layer.LAUNCHES) == launches
    assert abs(ours - logits_bf).max() <= 3 * abs(logits_bf - logits_f32).max()
    for force in ("fused", "block"):
        ops.set_attention_impl(force)
        try:
            with pytest.raises(NotImplementedError, match="§A2"), torch.no_grad():
                model(x)
        finally:
            ops.set_attention_impl(None)


# ---------------------------------------------------------------------------
# the trainer at the conf's default precision
# ---------------------------------------------------------------------------

TINY = ["training.epoch=1", "training.dataloader.batch_size=8", "data_backend=synthetic",
        '"arch.image_size=[32, 32]"', "arch.window_size=2", '"arch.depths=[2, 2, 0, 0]"',
        '"arch.dims=[16, 32, 64, 64]"', "arch.dim_head=8", '"arch.n_heads=[2, 4, 8, 8]"',
        '"arch.dim_ffs=[32, 64, 128, 128]"', "arch.n_class=10", "training.train_size=32",
        "training.valid_size=32", "n_device=1"]


def test_trainer_takes_swin_at_its_default_precision(tmp_path):
    conf = os.path.join(ROOT, "configs", "swin-transformer-s.conf")
    c = load_config(conf)
    assert c.precision == "bf16" and compute_dtype(c) == bf
    check_supported(c)
    from vision_transformers_tpu_torch import train

    store = f"checker.storage=[{{type: local, path: {tmp_path}}}]"
    metrics = train.main(["--conf", conf, "--device", "cpu", store,
                          *[o.strip('"') for o in TINY]])
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["valid_loss"])
    obj = torch.load(os.path.join(tmp_path, "epoch-001.pt"), weights_only=False)
    assert all(v.dtype == torch.float32 for v in obj["model"].values())
