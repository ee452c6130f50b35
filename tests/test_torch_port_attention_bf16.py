"""The packed-row attention's bf16 form (csrc/attention_bf16_tma.cuh: wgmma
fed by TMA, B1's and B2's bias-free attention at bfloat16) checked on the
CPU through a torch emulation of its arithmetic order.

The forward takes key tiles of 128 keys under the online softmax (one tile
of 208 where 192 < N ≤ 208: ops/fused_layer.py::packed_attention_bf16_route):
per tile S in f32 from the bf16 q and k, the running max of
S·scale·log₂e, P = 2^(S·scale·log₂e − m) rounded to bf16 as the A operand
of P·V, the f32 sums rescaled by 2^(m_old − m_new); out = O / l rounded
once, lse = (m + log₂ l)·ln 2.  The backward takes L = lse·log₂e and Δ =
rowsum(dO ⊙ out) from the rounded out, and per 128-key tile and 64-query
tile P = 2^(Sᵀ·scale·log₂e − L), dSᵀ·scale = P ⊙ (dPᵀ − Δ)·scale; P and
dSᵀ·scale rounded as the A operands of dV += Pᵀ·dO and dK +=
(dSᵀ·scale)·Q, and dq's f32 tiles dS·K summed in key-tile order and
rounded once.

The emulation is held against the plain versions
(ops/fused_layer.py::packed_attention_reference, ::attention_bwd_reference)
within chip_smoke.py phase 3bf's limits (1.6e-2 forward, 3e-2 gradients,
of max(1, max|plain|)), and B1 with its attention emulated against the JAX
package's B1 at bfloat16 (the Pallas kernel in interpret mode) within 3x
JAX's own bf16-against-f32 error, as test_torch_port_bf16_ops.py does.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch.ops import _build, fused_layer as fl
from test_torch_port_bf16_ops import (NAMES, assert_grad_within_gap, assert_within_gap,
                                      b1_jax, make_args, port_inputs, row_scale)
from torch_port_threads import one_torch_thread  # noqa: F401

bf = torch.bfloat16
FWD_TOL, BWD_TOL = 1.6e-2, 3e-2  # chip_smoke.BF16_FWD_TOL, BF16_BWD_TOL
LOG2E, LN2 = 1.0 / math.log(2.0), math.log(2.0)


def _r(t):
    """t rounded to bf16, as f32."""
    return t.to(bf).float()


def _heads(t, H):
    B, N, HD = t.shape
    return t.reshape(B, N, H, HD // H).permute(0, 2, 1, 3).float()


def emulate_fwd(qkv, H, scale):
    """(out [B, N, H·D] bf16, lse [B, H, N] f32) in the forward kernel's
    order."""
    B, N, HD3 = qkv.shape
    HD = HD3 // 3
    q, k, v = (_heads(qkv[..., i * HD:(i + 1) * HD], H) for i in range(3))
    scale2 = scale * LOG2E
    m = torch.full((B, H, N, 1), -math.inf)
    l = torch.zeros(B, H, N, 1)
    o = torch.zeros(B, H, N, HD // H)
    T = fl.packed_attention_bf16_route(N)["key_tile"]
    for k0 in range(0, N, T):
        s = q @ k[:, :, k0:k0 + T].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _r(p) @ v[:, :, k0:k0 + T]
        m = m_new
    out = (o / l).permute(0, 2, 1, 3).reshape(B, N, HD).to(bf)
    return out, ((m + torch.log2(l)) * LN2)[..., 0]


def emulate_bwd(qkv, out, lse, dout, H, scale):
    """dqkv [B, N, 3·H·D] bf16 in the backward kernel's order."""
    B, N, HD3 = qkv.shape
    HD = HD3 // 3
    q, k, v = (_heads(qkv[..., i * HD:(i + 1) * HD], H) for i in range(3))
    do, o = _heads(dout, H), _heads(out, H)
    L = lse[..., None] * LOG2E
    delta = (do * o).sum(-1, keepdim=True)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, N, 128):
        kt, vt = k[:, :, k0:k0 + 128], v[:, :, k0:k0 + 128]
        dq_tile = torch.zeros_like(q)
        for q0 in range(0, N, 64):
            qs = slice(q0, q0 + 64)
            st = kt @ q[:, :, qs].transpose(-1, -2)    # [keys, queries]
            dpt = vt @ do[:, :, qs].transpose(-1, -2)
            if N == 1:  # a softmax over one key is 1 and has no gradient, exactly
                p, ds = torch.ones_like(st), torch.zeros_like(st)
            else:
                p = torch.exp2(st * (scale * LOG2E) - L[:, :, qs].transpose(-1, -2))
                ds = p * (dpt - delta[:, :, qs].transpose(-1, -2)) * scale
            p, ds = _r(p), _r(ds)
            dv[:, :, k0:k0 + 128] += p @ do[:, :, qs]
            dk[:, :, k0:k0 + 128] += ds @ q[:, :, qs]
            dq_tile[:, :, qs] = ds.transpose(-1, -2) @ kt
        dq = dq + dq_tile  # the key tiles' f32 dq in key-tile order
    return torch.cat([_r(t).permute(0, 2, 1, 3).reshape(B, N, HD) for t in (dq, dk, dv)],
                     -1).to(bf)


def qkv_inputs(B, N, H, D, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * D)).astype(np.float32)).to(bf)
    dout = torch.from_numpy(rng.standard_normal((B, N, H * D)).astype(np.float32)).to(bf)
    return qkv, dout


def within(name, k, p, tol):
    k, p = k.float(), p.float()
    assert torch.isfinite(k).all() and k.shape == p.shape, name
    lim = tol * max(1.0, p.abs().max().item())
    err = (k - p).abs().max().item()
    assert err <= lim, f"{name}: max|emulated-plain| {err:.3e} > {lim:.3e}"


# (B, H) per N: a few heads and images
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("N", [1, 65, 129, 197, 257])
def test_emulation_within_phase_3bf_limits_of_the_plain_versions(N, D):
    B, H = 2, 3
    qkv, dout = qkv_inputs(B, N, H, D, seed=N + D)
    scale = D ** -0.5
    out, lse = emulate_fwd(qkv, H, scale)
    ref, ref_lse = fl.packed_attention_reference(qkv, H)
    within("out", out, ref, FWD_TOL)
    within("lse", lse, ref_lse, 1e-5)
    d = emulate_bwd(qkv, out, lse, dout, H, scale)
    plain = fl.attention_bwd_reference(qkv, out, lse, dout, H, scale, dtype=bf)[0]
    HD = H * D
    for i, name in enumerate(("dq", "dk", "dv")):
        within(name, d[..., i * HD:(i + 1) * HD], plain[..., i * HD:(i + 1) * HD], BWD_TOL)
    # and against the thin door's CPU path (the same plain version)
    assert torch.equal(fl.packed_attention_bf16_bwd(qkv, out, lse, dout, H), plain.to(bf))


def test_one_key_has_no_gradient_but_dv():
    qkv, dout = qkv_inputs(3, 1, 2, 16, seed=5)
    out, lse = emulate_fwd(qkv, 2, 0.25)
    assert torch.equal(out, qkv[..., 64:])  # p = 1: out = v
    d = emulate_bwd(qkv, out, lse, dout, 2, 0.25)
    assert not d[..., :64].any()  # dq, dk exactly 0
    assert torch.equal(d[..., 64:], dout)  # dv = Pᵀ·dO = dO


def test_python_mirrors_the_kernels_tile_rules():
    src = (_build._CSRC / "attention_bf16_tma.cuh").read_text()
    assert re.search(r"DQ_SMEM_MAX_N = (\d+);", src).group(1) == str(fl.BF16_DQ_SMEM_MAX_N)
    assert re.search(r"constexpr int TK = (\d+);", src).group(1) == "128"
    assert re.search(r"constexpr int TQ = (\d+);", src).group(1) == "64"
    launch = (_build._CSRC / "attention_bf16.cu").read_text()
    assert "const bool wide = N > 192 && N <= 208;" in launch
    route = fl.packed_attention_bf16_route
    assert [route(n)["key_tile"] for n in (192, 193, 197, 208, 209)] == [128, 208, 208, 208, 128]
    assert [route(n)["dq"] for n in (197, 256, 257)] == ["shared memory"] * 2 + [
        "key-tile partials"]


# B1 with its attention emulated, against the JAX package's B1 at bf16


def b1_emulated(args, r, H):
    """(out, grads of sum(out²)) of B1 at bf16 on the port's plain steps,
    the attention forward and backward emulated."""
    x, g, b, wqkv, bqkv, wout, bout = port_inputs(args, bf)
    B, N, C = x.shape
    HD = wqkv.shape[1] // 3
    D = HD // H
    M, scale = B * N, D ** -0.5
    rs = torch.from_numpy(r) if r is not None else None
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + 1e-6)
    u = ((xf - mu) * rstd * g + b).to(bf)
    qkv = fl._dot(u, wqkv, bf) + bqkv
    acc, lse = emulate_fwd(qkv, H, scale)
    a = fl._dot(acc, wout, bf) + bout
    out = fl._residual(x, a, rs)
    dz2 = (2 * out.float()).reshape(M, C)  # d sum(out²)
    dacc, dwout, dbout, drs = fl.out_proj_bwd_reference(acc.reshape(M, HD), wout, bout, rs,
                                                        dz2, N)
    dqkv = emulate_bwd(qkv, acc, lse, dacc.reshape(B, N, HD), H, scale).reshape(M, 3 * HD)
    dx, dg, db, dwqkv, dbqkv = fl.qkv_proj_bwd_reference(
        x.reshape(M, C), mu.reshape(M), rstd.reshape(M), g, b, wqkv, bqkv, dqkv.float(), dz2)
    grads = [dx.reshape(B, N, C).to(bf), dg, db, dwqkv, dbqkv, dwout, dbout]
    return out, grads + ([drs] if rs is not None else [])


@pytest.fixture(scope="module")
def b1_case():
    B, N, C, H, D = 2, 129, 64, 2, 32  # two key tiles: the online rescale, the dq sum
    args = make_args(B, N, C, H, D, seed=29)
    r = row_scale(B)
    return H, args, r, {key: (b1_jax(args, rv, H, jnp.bfloat16),
                              b1_jax(args, rv, H, jnp.float32))
                        for key, rv in (("plain", None), ("rs", r))}


@pytest.mark.parametrize("rs", ["plain", "rs"])
def test_b1_with_the_emulated_attention_within_jax_bf16_gap(b1_case, rs):
    H, args, r, jax_out = b1_case
    (out_bf, grads_bf), (out_f32, grads_f32) = jax_out[rs]
    out, grads = b1_emulated(args, r if rs == "rs" else None, H)
    assert out.dtype == bf
    assert_within_gap("out", out.float().numpy(), out_bf, out_f32)
    for name, g, gb, gf in zip(NAMES, grads, grads_bf, grads_f32):
        assert_grad_within_gap(name, g.float().numpy(), gb, gf)
