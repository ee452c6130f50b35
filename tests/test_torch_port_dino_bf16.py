"""DINO at its conf's default precision, bf16, against the JAX package at
dtype bfloat16, on the CPU from numpy-seeded inputs.

- B1 with DINO's block mask (6 crops of 9 tokens packed 3 to a row, C 32,
  2 heads of 16) and with a grouped bias (G = 2): the port's plain bf16
  version against JAX's ``fused_attention_layer`` at bf16 (its Pallas
  kernel in interpret mode), the output and every gradient; the limit is 3
  times JAX's own bf16-against-f32 error (its pure-jnp reference at f32),
  as tests/test_torch_port_bf16_ops.py holds the bias-free form.
- The packed-row attention's bf16 kernel order with the bias
  (csrc/attention_bf16_tma.cuh: each score leaves the accumulators as
  fmaf(s, scale·log₂e, bias·log₂e), the online softmax over 128-key tiles
  at every N), emulated in torch under a mask whose second block's queries
  find their first 128-key tile all masked (N 200 and 257: the rescale
  washes that tile out), against the plain versions within chip_smoke
  phase 3bf's limits.
- A tiny DINO (depth 2, dim 64, heads 32 wide, head to 128) at bf16, its
  local crops packed 3 to a row under the mask and sent to B1 (JAX: its
  Pallas kernel in interpret mode), everything else on einsum, the
  student's DropPath scales supplied to both sides (per sample on the
  globals, token level on the packed locals): both nets' outputs, the DINO
  loss and every student gradient within 3 times JAX's bf16 gap (JAX f32
  on its einsum path, fed the same scales).
- The head's logits are f32 and not rounded to bf16; what refuses bf16
  still does (Swin-S's arch type, B2 with a bias); one ``train_dino``
  epoch at bf16 on the CPU writes an f32 checkpoint.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.models.vit import DINOConfig as JaxDINOConfig
from vision_transformers_tpu.models.vit import TransformerLayer as JaxLayer
from vision_transformers_tpu.ops.fused_layer import _attn_layer_ref
from vision_transformers_tpu.ops.fused_layer import \
    fused_attention_layer as jax_fused_attention_layer
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.config.schema import load_config
from vision_transformers_tpu_torch.models import layers, vit
from vision_transformers_tpu_torch.models.vit import DINOConfig, VisionTransformer, pack_mask
from vision_transformers_tpu_torch.ops import fused_layer as fl
from vision_transformers_tpu_torch.ops import fused_layer1
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.train.trainer import check_supported
from vision_transformers_tpu_torch.train_dino import main as train_dino_main
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         state_dict_from_flax, to_torch)
from test_torch_port_attention_bf16 import _heads, _r, qkv_inputs, within
from test_torch_port_bf16_ops import (GAP_FACTOR, NAMES, assert_grad_within_gap,
                                      assert_within_gap, jax_inputs, make_args, port_inputs,
                                      row_scale)
from test_torch_port_vit_attention_tc import fake_cuda
from torch_port_threads import one_torch_thread  # noqa: F401

bf = torch.bfloat16
FWD_TOL, BWD_TOL = 1.6e-2, 3e-2  # chip_smoke.BF16_FWD_TOL, BF16_BWD_TOL
LOG2E, LN2 = 1.0 / math.log(2.0), math.log(2.0)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


# XLA's backend at its lowest LLVM optimization level: the JAX sides here are
# tiny, so their compiles, not their runs, take the time (the same HLO)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn):
    jitted = jax.jit(fn)
    return lambda *a: jitted.lower(*a).compile(compiler_options=FAST_COMPILE)(*a)


# ---------------------------------------------------------------------------
# B1 with the bias, plain bf16 version against JAX's Pallas kernel
# ---------------------------------------------------------------------------


def b1_jax(args, extra, r, H, dtype):
    """(out, grads of sum(out²)) of the JAX package's B1 with the f32 bias
    ``extra``: its Pallas kernel at bf16, its reference at f32."""
    inputs = jax_inputs(args, dtype) + ([jnp.asarray(r)] if r is not None else [])
    D = args[3].shape[1] // 3 // H
    e = jnp.asarray(extra)

    def f(*a):
        rs = a[7] if r is not None else None
        if dtype == jnp.float32:
            out = _attn_layer_ref(*a[:7], e, rs, H, D ** -0.5, 1e-6)
        else:
            out = jax_fused_attention_layer(*a[:7], H, e, rs, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    grad_fn = jax.value_and_grad(f, argnums=tuple(range(len(inputs))), has_aux=True)
    (_, out), grads = fast_jit(grad_fn)(*inputs)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def grouped_bias(G, H, N, seed):
    return np.random.default_rng(seed).standard_normal((G, H, N, N)).astype(np.float32)


# (B rows, N tokens, C, H, D, the bias, row scale): 6 crops of 9 tokens
# packed 3 to a row under DINO's mask; 4 rows under a grouped bias
B1_CASES = {"mask": (2, 27, 32, 2, 16, "mask", True), "grouped": (4, 27, 32, 2, 16, 2, False)}


@pytest.mark.parametrize("case", sorted(B1_CASES))
def test_b1_bf16_with_the_bias_within_jax_bf16_gap(case):
    B, N, C, H, D, kind, rows_scaled = B1_CASES[case]
    args = make_args(B, N, C, H, D, seed=23)
    extra = (np.asarray(pack_mask(3, N // 3, "cpu")) if kind == "mask"
             else grouped_bias(kind, H, N, seed=29))
    r = row_scale(B) if rows_scaled else None
    out_bf, grads_bf = b1_jax(args, extra, r, H, jnp.bfloat16)
    out_f32, grads_f32 = b1_jax(args, extra, r, H, jnp.float32)
    inputs = port_inputs(args, bf, grad=True)
    rs = torch.from_numpy(r).requires_grad_() if r is not None else None
    out = fl.fused_attention_layer(*inputs, H, extra=torch.from_numpy(extra), row_scale=rs)
    (out.float() ** 2).sum().backward()
    grads = [t.grad for t in inputs] + ([rs.grad] if rs is not None else [])
    assert out.dtype == bf
    assert_within_gap("out", out.detach().float().numpy(), out_bf, out_f32)
    for name, g, gb, gf in zip(NAMES, grads, grads_bf, grads_f32):
        assert_grad_within_gap(name, g.float().numpy(), gb, gf)
    if kind == "mask":  # a crop's output is blind to the other crops' tokens
        moved = inputs[0].detach().clone()
        moved[:, 9:] += 1.0
        with torch.no_grad():
            other = fl.fused_attention_layer(moved, *[t.detach() for t in inputs[1:]], H,
                                             extra=torch.from_numpy(extra),
                                             row_scale=rs.detach())
        assert torch.equal(other[:, :9], out.detach()[:, :9])


# ---------------------------------------------------------------------------
# the bf16 kernel's order with the bias, emulated
# ---------------------------------------------------------------------------


def emulate_fwd_bias(qkv, H, scale, bias):
    """(out, lse) in the forward kernel's order with the bias [H, N, N]:
    logits in the log₂ domain fmaf(s, scale·log₂e, bias·log₂e), the
    running max over the key tiles, p = 2^(logit − m) rounded to bf16 for
    P·V, the f32 sums rescaled by 2^(m_old − m_new)."""
    B, N, HD3 = qkv.shape
    HD = HD3 // 3
    q, k, v = (_heads(qkv[..., i * HD:(i + 1) * HD], H) for i in range(3))
    m = torch.full((B, H, N, 1), -math.inf)
    l = torch.zeros(B, H, N, 1)
    o = torch.zeros(B, H, N, HD // H)
    T = fl.packed_attention_bf16_route(N, bias=True)["key_tile"]
    for k0 in range(0, N, T):
        s = torch.addcmul(bias[:, :, k0:k0 + T] * LOG2E,
                          q @ k[:, :, k0:k0 + T].transpose(-1, -2), torch.tensor(scale * LOG2E))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _r(p) @ v[:, :, k0:k0 + T]
        m = m_new
    out = (o / l).permute(0, 2, 1, 3).reshape(B, N, HD).to(bf)
    return out, ((m + torch.log2(l)) * LN2)[..., 0]


def emulate_bwd_bias(qkv, out, lse, dout, H, scale, bias):
    """dqkv in the backward kernel's order with the bias: P = 2^(fmaf(s,
    scale·log₂e, bias·log₂e) − L) per 128-key × 64-query tile, P and
    dS·scale rounded before their products, dq's tiles summed in key-tile
    order."""
    B, N, HD3 = qkv.shape
    HD = HD3 // 3
    q, k, v = (_heads(qkv[..., i * HD:(i + 1) * HD], H) for i in range(3))
    do, o = _heads(dout, H), _heads(out, H)
    L2 = lse[..., None] * LOG2E
    delta = (do * o).sum(-1, keepdim=True)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, N, 128):
        ks = slice(k0, k0 + 128)
        dq_tile = torch.zeros_like(q)
        for q0 in range(0, N, 64):
            qs = slice(q0, q0 + 64)
            st = k[:, :, ks] @ q[:, :, qs].transpose(-1, -2)   # [keys, queries]
            logit = torch.addcmul(bias[:, qs, ks].transpose(-1, -2) * LOG2E, st,
                                  torch.tensor(scale * LOG2E))
            p = torch.exp2(logit - L2[:, :, qs].transpose(-1, -2))
            dpt = v[:, :, ks] @ do[:, :, qs].transpose(-1, -2)
            ds = p * (dpt - delta[:, :, qs].transpose(-1, -2)) * scale
            p, ds = _r(p), _r(ds)
            dv[:, :, ks] += p @ do[:, :, qs]
            dk[:, :, ks] += ds @ q[:, :, qs]
            dq_tile[:, :, qs] = ds.transpose(-1, -2) @ k[:, :, ks]
        dq = dq + dq_tile
    return torch.cat([_r(t).permute(0, 2, 1, 3).reshape(B, N, HD) for t in (dq, dk, dv)],
                     -1).to(bf)


def first_tile_masked(N):
    """A two-block mask [N, N]: the first block holds the first 128 keys,
    so the second block's queries find their first 128-key tile all
    masked."""
    blocks = torch.block_diag(torch.ones(128, 128), torch.ones(N - 128, N - 128))
    return torch.where(blocks > 0, 0.0, -1e9)


@pytest.mark.parametrize("N", [200, 257])
def test_emulated_bias_softmax_within_phase_3bf_limits(N):
    B, H, D = 2, 2, 32
    qkv, dout = qkv_inputs(B, N, H, D, seed=N)
    mask = first_tile_masked(N)
    bias = mask.expand(H, N, N)
    scale = D ** -0.5
    out, lse = emulate_fwd_bias(qkv, H, scale, bias)
    ref, ref_lse = fl.packed_attention_reference(qkv, H, extra=mask)
    within("out", out, ref, FWD_TOL)
    within("lse", lse, ref_lse, 1e-5)
    assert torch.isfinite(lse).all()
    # the masked first tile is washed out: the second block's out is its
    # own attention alone
    own, _ = fl.packed_attention_reference(qkv[:, 128:].contiguous(), H)
    within("second block", out[:, 128:], own, FWD_TOL)
    d = emulate_bwd_bias(qkv, out, lse, dout, H, scale, bias)
    plain = fl.attention_bwd_reference(qkv, out, lse, dout, H, scale, mask[None, None].expand(
        1, H, N, N), dtype=bf)[0]
    HD = H * D
    for i, name in enumerate(("dq", "dk", "dv")):
        within(name, d[..., i * HD:(i + 1) * HD], plain[..., i * HD:(i + 1) * HD], BWD_TOL)
    # the thin doors' CPU path is the plain version
    assert torch.equal(fl.packed_attention_bf16(qkv, H, extra=mask)[0], ref)
    assert torch.equal(fl.packed_attention_bf16_bwd(qkv, out, lse, dout, H, extra=mask),
                       plain.to(bf))


# ---------------------------------------------------------------------------
# a tiny DINO at bf16 against the JAX DINOModel at bf16
# ---------------------------------------------------------------------------

# globals 32 px / 4 → 65 tokens (unpacked: per-sample DropPath scales),
# locals 16 px → 17 tokens, packed 3 to a row (token-level scales)
ARCH = dict(image_size=32, window_size=4, depth=2, dim=64, n_head=2, dim_ff=128,
            drop_path=0.1, dim_head_out=128, depth_head=3, dim_head_ff=64,
            dim_head_bottleneck=32)
N_IMAGES, N_LOCAL, TEMP = 3, 3, 0.04


@pytest.fixture(scope="module")
def dino_setup():
    rng = np.random.default_rng([20, 1])
    crops = [rng.normal(size=(N_IMAGES, s, s, 3)).astype(np.float32)
             for s in [32] * 2 + [16] * N_LOCAL]
    center = (0.1 * rng.standard_normal((1, ARCH["dim_head_out"]))).astype(np.float32)
    keep = 1 - ARCH["drop_path"]
    # in call order, for the one layer at a rate above 0 (the ramp gives
    # layer 0 none): the globals' per-sample scales, then the packed locals'
    # token-level ones, the attention's before the FF's
    rows, seq = N_IMAGES * N_LOCAL // 3, 17
    glob = [(rng.random(2 * N_IMAGES) < keep).astype(np.float32) / keep for _ in range(2)]
    loc = [np.repeat((rng.random((rows, 3)) < keep).astype(np.float32) / keep, seq, axis=1)
           for _ in range(2)]
    glob[0][0], loc[0][0, :seq] = 0.0, 0.0  # a dropped sample and a dropped crop
    sd_s = seeded_state_dict(DINOConfig(**ARCH), seed=4)
    sd_t = seeded_state_dict(DINOConfig(**ARCH), seed=5)
    return crops, center, glob + loc, sd_s, sd_t


PACKED_SEQ = 51  # the locals' packed rows: 3 crops of 17 tokens


def packed_on_layer(batch=None, seq=None, default="einsum"):
    """The dispatch of the tests' bf16 runs, in both packages: B1 ('layer')
    at the packed locals' layer sites, einsum everywhere else."""
    return "layer" if default == "layer" and seq == PACKED_SEQ else "einsum"


def jax_dino(setup, dtype, layer, monkeypatch):
    """(student out, teacher out, loss, student grads by state_dict key) of
    the JAX package at ``dtype``: with ``layer`` the packed locals on B1
    (Pallas in interpret mode), else its CPU dispatch (einsum); the DropPath
    scales fed in call order to its layers' _row_scale (the 'layer' path's
    draws, and the einsum path's token-level ones) and to drop_path (the
    einsum path's per-sample ones)."""
    from vision_transformers_tpu.models import vit as jax_vit

    crops, center, scales, sd_s, sd_t = setup
    cfg = JaxDINOConfig(**ARCH)
    model = cfg.make(dtype=dtype)
    params = jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd_s)["params"])
    tparams = jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd_t)["params"])
    feed = iter([jnp.asarray(s) for s in scales])

    def row_scale(self, b, deterministic, pack=1, n=None):
        return None if deterministic or self.drop_path == 0.0 else next(feed)

    def drop_path(y, rate, rng, deterministic):
        return y * next(feed)[:, None, None].astype(y.dtype)

    monkeypatch.setattr(JaxLayer, "_row_scale", row_scale)
    monkeypatch.setattr(jax_vit, "drop_path", drop_path)
    if layer:
        monkeypatch.setattr(jax_ops, "attention_impl", packed_on_layer)
    jcrops = [jnp.asarray(c) for c in crops]

    def step(p, tp, jcrops):
        with jax_ops.forward_only():
            t_out = model.apply({"params": tp}, jcrops[:2]).astype(jnp.float32)

        def f(p):
            s_out = model.apply({"params": p}, jcrops, deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(0)})
            return jax_loss.dino_loss(s_out, t_out, jnp.asarray(center), TEMP,
                                      len(jcrops)), s_out

        (loss, s_out), grads = jax.value_and_grad(f, has_aux=True)(p)
        return s_out, t_out, loss, grads

    jax_ops.set_attention_impl(None, interpret=layer)
    try:
        s_out, t_out, loss, grads = fast_jit(step)(params, tparams, jcrops)
    finally:
        jax_ops.set_attention_impl(None)
        monkeypatch.undo()
    return (np.asarray(s_out, np.float32), np.asarray(t_out), float(loss),
            state_dict_from_flax(jax.tree.map(lambda a: np.asarray(a, np.float32), grads)))


def port_dino(setup, dtype, monkeypatch):
    """The same from the port, the packed locals on B1's autograd Function
    (its plain version on the CPU)."""
    crops, center, scales, sd_s, sd_t = setup
    student = DINOConfig(**ARCH).make(dtype=dtype)
    student.load_state_dict(to_torch(sd_s), strict=True)
    teacher = DINOConfig(**ARCH).make(dtype=dtype, drop_path=0.0)
    teacher.load_state_dict(to_torch(sd_t), strict=True)
    feed = iter([torch.from_numpy(s) for s in scales])

    def draw_drop_path(b, generator=None, pack=1, seq=None):
        return [(next(feed), next(feed)) if r else (None, None)
                for r in student.drop_path_rates]

    student.draw_drop_path = draw_drop_path
    monkeypatch.setattr(ops, "attention_impl", packed_on_layer)
    tcrops = [torch.from_numpy(c).permute(0, 3, 1, 2) for c in crops]
    with torch.no_grad(), ops.forward_only():
        t_out = teacher.eval()(tcrops[:2])
    s_out = student.train()(tcrops)
    loss = L.dino_loss(s_out, t_out.float(), torch.from_numpy(center), TEMP, len(crops))
    loss.backward()
    return s_out, t_out, loss, {k: p.grad for k, p in student.named_parameters()}


@pytest.fixture(scope="module")
def jax_dino_sides(dino_setup):
    mp = pytest.MonkeyPatch()
    try:
        return (jax_dino(dino_setup, jnp.bfloat16, True, mp),
                jax_dino(dino_setup, jnp.float32, False, mp))
    finally:
        mp.undo()


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def test_tiny_dino_bf16_within_jax_bf16_gap(dino_setup, jax_dino_sides, monkeypatch):
    (s_bf, t_bf, loss_bf, g_bf), (s_f32, t_f32, loss_f32, g_f32) = jax_dino_sides
    launches = (fl.BF16_LAUNCHES, fl.BIAS_LAUNCHES)
    calls = []
    layer = fl.fused_attention_layer

    def spy(*a, **kw):
        calls.append(kw.get("extra") is not None)
        return layer(*a, **kw)

    monkeypatch.setattr(ops, "fused_attention_layer", spy)
    s_out, t_out, loss, grads = port_dino(dino_setup, bf, monkeypatch)
    assert calls == [True] * ARCH["depth"]  # the packed locals took B1 with the mask
    assert (fl.BF16_LAUNCHES, fl.BIAS_LAUNCHES) == launches  # the CPU launches nothing
    # the logits leave the head in f32
    assert s_out.dtype == t_out.dtype == torch.float32
    assert s_out.shape == (N_IMAGES * (2 + N_LOCAL), ARCH["dim_head_out"])
    for name, ours, b, f in (("student", s_out, s_bf, s_f32), ("teacher", t_out, t_bf, t_f32)):
        assert rel(ours.detach().numpy(), b) <= GAP_FACTOR * rel(b, f), name
    assert abs(float(loss.detach()) - loss_bf) <= GAP_FACTOR * abs(loss_bf - loss_f32), (
        float(loss), loss_bf, loss_f32)
    # the frozen gain (norm_last_layer) is the port's buffer: no gradient
    assert sorted(grads) == sorted(set(g_bf) - {"head.last.weight_g"})
    for k, g in grads.items():
        assert g.dtype == torch.float32, k
        gap = rel(g_bf[k], g_f32[k])
        assert gap > 0 and rel(g.numpy(), g_bf[k]) <= GAP_FACTOR * gap, \
            f"{k}: {rel(g.numpy(), g_bf[k]):.3e} against {GAP_FACTOR} x {gap:.3e}"


def test_head_logits_are_f32_and_not_rounded(dino_setup, monkeypatch):
    """The prototype product takes the bf16-rounded normalised output and
    weight and gives f32 logits (JAX vit.py:620-625): its result holds
    values bf16 cannot, and equals the operands' f32 product."""
    _, _, _, sd_s, _ = dino_setup
    model = DINOConfig(**ARCH).make(dtype=bf)
    model.load_state_dict(to_torch(sd_s), strict=True)
    seen = []

    def spy(a, b):
        seen.append((a, b, layers.f32_out_product(a, b)))
        return seen[-1][2]

    monkeypatch.setattr(vit, "f32_out_product", spy)
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal((5, ARCH["dim"]))
                             .astype(np.float32)).to(bf)
    with torch.no_grad():
        out = model.head(feats)
    (a, b, res), = seen
    assert a.dtype == b.dtype == bf and out is res and out.dtype == torch.float32
    assert b.shape == (ARCH["dim_head_out"], ARCH["dim_head_bottleneck"])
    exact = a.double() @ b.double().t()
    assert torch.allclose(out.double(), exact, rtol=1e-6, atol=1e-7)
    rounded = out.to(bf).float()
    assert (out - rounded).abs().max() > 100 * (out.double() - exact).abs().max()
    # the f32 head: the Linear in f32, no bf16 operand
    model32 = DINOConfig(**ARCH).make()
    model32.load_state_dict(to_torch(sd_s), strict=True)
    with torch.no_grad():
        model32.head(feats.float())
    assert len(seen) == 1


def test_dino_bf16_checks():
    # check_supported takes dino at bf16, refuses PVT-S there
    c = load_config(os.path.join(ROOT, "configs", "dino_deit-s-16.conf"))
    assert c.precision == "bf16"
    check_supported(c)
    s = load_config(os.path.join(ROOT, "tests", "data", "pvt_s_port.conf"))
    with pytest.raises(NotImplementedError, match="§A2"):
        check_supported(s)
    # the nets carry the compute dtype through the trunk and the head
    net = DINOConfig(**ARCH).make(dtype=bf)
    assert isinstance(net, VisionTransformer) and net.dtype == net.head.dtype == bf
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_b2_bf16_still_refuses_a_bias(monkeypatch):
    """B2's bf16 form takes the bias (Swin-S's grouped bias) since; what it
    still refuses is the bias's gradient past one key tile (128 tokens)."""
    rng = np.random.default_rng(0)
    B, N, C, H, D, F = 4, 18, 32, 2, 16, 64
    args = [torch.from_numpy(a) for a in make_args(B, N, C, H, D, F)]
    args = [t if i in (1, 2, 7, 8) else t.to(bf) for i, t in enumerate(args)]
    extra = torch.from_numpy(rng.standard_normal((1, H, N, N)).astype(np.float32))
    with fake_cuda(monkeypatch) as lib:
        fused_layer1._cuda_fwd(*args, H, extra, 1, None, None, "silu", 0.25, 1e-6,
                               save=False)
        assert lib.calls["vtx_fused_transformer_layer_fwd_bf16"]["extra"] == extra.data_ptr()
    N = 130
    args = [torch.from_numpy(a) for a in make_args(B, N, C, H, D, F)]
    args = [t if i in (1, 2, 7, 8) else t.to(bf) for i, t in enumerate(args)]
    extra = torch.zeros((1, H, N, N))
    with fake_cuda(monkeypatch) as lib:
        out, res = fused_layer1._cuda_fwd(*args, H, extra, 1, None, None, "silu", 0.25, 1e-6,
                                          save=True)
        saved = fused_layer1.L1Saved(*args, extra, None, None, *res, H, "silu", 0.25, 1e-6)
        with pytest.raises(NotImplementedError, match="128 tokens"):
            fused_layer1._cuda_bwd(saved, torch.zeros_like(out), (False, False), True)
        assert "vtx_fused_transformer_layer_bwd_bf16" not in lib.calls


DINO_TINY = ["arch.depth=2", "arch.dim=64", "arch.n_head=2", "arch.dim_ff=128",
             "arch.image_size=32", "arch.window_size=8", "arch.dim_head_out=128",
             "arch.dim_head_ff=64", "arch.dim_head_bottleneck=32", "task.global_crop_size=32",
             "task.local_crop_size=16", "task.n_local_crop=2",
             "training.dataloader.batch_size=6", "training.epoch=1"]


def test_train_dino_epoch_at_bf16_writes_f32_checkpoint(tmp_path):
    """The conf's default precision, no override: the nets compute in bf16,
    and the checkpoint's nets, center and moments are f32; the entry sets
    bf16 products to reduce in f32, as the classification entry does."""
    store = f"checker.storage=[{{type: local, path: {tmp_path}}}]"
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True  # torch's default
    metrics = train_dino_main(["--conf", os.path.join(ROOT, "configs", "dino_deit-s-16.conf"),
                               "--device", "cpu", *DINO_TINY, store])
    assert np.isfinite(metrics["loss"])
    obj = torch.load(tmp_path / "epoch-001.pt", weights_only=False)
    for net in ("student", "teacher"):
        assert all(v.dtype == torch.float32 for v in obj[net].values()), net
    assert obj["center"].dtype == torch.float32
    moments = [v for v in obj["optimizer"].values() if isinstance(v, dict)]
    assert all(t.dtype == torch.float32 for m in moments for t in m.values()
               if isinstance(t, torch.Tensor))
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
