"""The whole Halo layer off the NHWC feature map, forward and backward:

    z = x + rs_attn ⊙ OutProj(HaloAttn(QkvProj(LN₁(x)) + bias))
    o = z + rs_ff   ⊙ (act(LN₂(z)·W₁ + b₁)·W₂ + b₂)

Counterpart of ``vision_transformers_tpu/ops/fused_halo_layer.py::
fused_halo_layer``, same signature and weight semantics: x [B, H, W, C],
wqkv [C, 3·H·D] (q-heads | k-heads | v-heads, NO bias, as the reference's
qkv projection), wout [H·D, C], w1 [C, F], w2 [F, C], bias [n_head, w², k²]
the relative-position bias (differentiable), rs_attn / rs_ff optional [B]
per-sample DropPath scales, halo attention as in :mod:`.fused_halo`
(zero keys and values outside the map).

A call that needs gradients goes through a ``torch.autograd.Function``
whose forward keeps what the backward reads — qkv, acc, z, the FF
pre-activation hid, the LN₁ / LN₂ statistics and the softmax log-sum-exp
(the JAX kernel's "z+acc" save, fused_halo_layer.py:452-520, plus qkv, the
statistics, lse and hid, so the backward recomputes nothing but elementwise
values) — and whose backward returns the gradient of every input the JAX
rule does (fused_halo_layer.py:523-612): x, both LayerNorms, the four
weights, the three biases, ``bias`` and each row scale when it is asked
for.  A call that needs none (``torch.no_grad()``, eval and serving) saves
nothing.

A CPU tensor runs the plain torch versions (LN statistics f32, dots
f32-accumulated, softmax and activation f32); a CUDA tensor runs the
hand-written kernels of ``csrc/fused_halo.cu`` or raises, never the plain
versions.  The kernels take float32, ``activation="silu"``, heads up to
``MAX_DIM_HEAD`` wide and the geometry
:func:`.fused_halo.check_halo_geometry` admits.  Weights may be
any 2-D strided view (the model passes ``linear.weight.t()``; their
gradients come back in the view's layout).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .fused_halo import (attention_bwd_reference, attention_fwd_reference,
                         check_bias, check_halo_geometry, dbias_chunks, dq_partials)
from .fused_layer import (_default_scale, _dot, _ln_stats, _raise_on, _residual,
                          _splits, cast_like, check_f32, check_matrix, check_vector,
                          like_layout, out_proj_bwd_reference, ptr,
                          ff_half_bwd_reference, ff_half_fwd_reference,
                          qkv_proj_bwd_reference)

__all__ = ["fused_halo_layer", "fused_halo_layer_reference", "fused_halo_layer_fwd",
           "fused_halo_layer_bwd", "fused_halo_layer_fwd_reference",
           "fused_halo_layer_bwd_reference", "HaloSaved", "GRAD_NAMES", "LAUNCHES",
           "BWD_LAUNCHES"]

# kernel launches through this module's wrappers, forward and backward
# (chip_smoke.py reads them to show the main path went through the kernels)
LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_DIM_HEAD = 32  # the whole layer's own limit (the attention alone takes 64)

GRAD_NAMES = ("dx", "dln1_scale", "dln1_bias", "dwqkv", "dwout", "dbout",
              "dln2_scale", "dln2_bias", "dw1", "db1", "dw2", "db2", "dbias",
              "drs_attn", "drs_ff")


class HaloSaved(NamedTuple):
    """What the backward reads: the forward's inputs (bias contiguous f32)
    and residuals — qkv [B, H, W, 3HD], acc [B, H, W, HD], z [B, H, W, C],
    hid [B, H, W, F], mu1 / rstd1 / mu2 / rstd2 [B, H, W], lse
    [B, n_head, H·W]."""

    x: torch.Tensor
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wqkv: torch.Tensor
    wout: torch.Tensor
    bout: Optional[torch.Tensor]
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w1: torch.Tensor
    b1: Optional[torch.Tensor]
    w2: torch.Tensor
    b2: Optional[torch.Tensor]
    bias: torch.Tensor
    rs_attn: Optional[torch.Tensor]
    rs_ff: Optional[torch.Tensor]
    qkv: torch.Tensor
    acc: torch.Tensor
    z: torch.Tensor
    hid: torch.Tensor
    mu1: torch.Tensor
    rstd1: torch.Tensor
    lse: torch.Tensor
    mu2: torch.Tensor
    rstd2: torch.Tensor
    n_head: int
    activation: str
    window: int
    halo: int
    scale: float
    eps: float


N_SAVED_TENSORS = 24  # HaloSaved's tensor fields; the rest are attributes


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def fused_halo_layer_fwd_reference(x, ln1_scale, ln1_bias, wqkv, wout, bout,
                                   ln2_scale, ln2_bias, w1, b1, w2, b2, bias,
                                   n_head: int, rs_attn=None, rs_ff=None,
                                   activation: str = "silu", *, window: int,
                                   halo: int, scale: Optional[float] = None,
                                   eps: float = 1e-6):
    """Plain torch training forward: (out, :class:`HaloSaved`)."""
    scale = _default_scale(wqkv, n_head, scale)
    HD = wqkv.shape[1] // 3
    bias = bias.float().contiguous()
    xf = x.float()
    mu1, rstd1 = _ln_stats(xf, eps)
    u = ((xf - mu1) * rstd1 * ln1_scale.float() + ln1_bias.float()).to(x.dtype)
    qkv = _dot(u, wqkv, x.dtype)
    acc, lse = attention_fwd_reference(qkv[..., :HD], qkv[..., HD:2 * HD],
                                       qkv[..., 2 * HD:], bias, n_head, window, halo,
                                       scale)
    a = _dot(acc, wout, x.dtype)
    if bout is not None:
        a = a + bout
    z = _residual(x, a, rs_attn)
    out, hid, mu2, rstd2 = ff_half_fwd_reference(z, ln2_scale, ln2_bias, w1, b1, w2,
                                                 b2, rs_ff, activation, eps)
    return out, HaloSaved(x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale,
                          ln2_bias, w1, b1, w2, b2, bias, rs_attn, rs_ff, qkv, acc, z,
                          hid, mu1[..., 0], rstd1[..., 0], lse, mu2, rstd2, n_head,
                          activation, window, halo, scale, float(eps))


def fused_halo_layer_reference(*args, **kwargs):
    """Plain torch version of :func:`fused_halo_layer` (forward)."""
    return fused_halo_layer_fwd_reference(*args, **kwargs)[0]


def fused_halo_layer_bwd_reference(saved: HaloSaved, do: torch.Tensor,
                                   need_drs=(True, True)):
    """Plain torch backward on the saves, in the kernels' steps
    (csrc/fused_halo.cu): → the 15 gradients of ``GRAD_NAMES``; a bias
    grad is None where the bias is, a row scale's None without it or where
    ``need_drs`` says so."""
    s = saved
    B, H, W, C = s.x.shape
    HD = s.wqkv.shape[1] // 3
    M = B * H * W
    # FF half → dz
    dz, dg2, db2, dw1, db1f, dw2, db2f, drs_ff = ff_half_bwd_reference(
        s.z, s.ln2_scale, s.ln2_bias, s.w1, s.b1, s.w2, s.b2, s.rs_ff, s.hid, s.mu2,
        s.rstd2, s.activation, do, need_drs[1])
    # the out projection → dacc
    dacc, dwout, dbout, drs_attn = out_proj_bwd_reference(
        s.acc.reshape(M, HD), s.wout, s.bout, s.rs_attn, dz, H * W, need_drs[0])
    # halo attention → dqkv, dbias
    qkv = s.qkv.reshape(B, H, W, 3 * HD)
    dq, dk, dv, dbias = attention_bwd_reference(
        qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:], s.bias,
        s.acc.reshape(B, H, W, HD), s.lse, dacc.reshape(B, H, W, HD), s.n_head,
        s.window, s.halo, s.scale)
    dqkv = torch.cat([dq, dk, dv], -1).reshape(M, 3 * HD)
    # the qkv projection and LN₁, with the residual dz
    dx, dg1, db1, dwqkv, _ = qkv_proj_bwd_reference(
        s.x.reshape(M, C), s.mu1, s.rstd1, s.ln1_scale, s.ln1_bias, s.wqkv, None,
        dqkv, dz)
    return (dx.reshape(s.x.shape).to(s.x.dtype), dg1, db1, dwqkv, dwout, dbout, dg2,
            db2, dw1, db1f, dw2, db2f, cast_like(dbias, s.bias), drs_attn, drs_ff)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def _check(x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale, ln2_bias, w1, b1,
           w2, b2, bias, n_head, rs_attn, rs_ff, activation, window, halo):
    """Shape/type checks of the CUDA ops; returns (B, H, W, C, D, F)."""
    if activation != "silu":
        raise NotImplementedError(
            f"the CUDA kernel takes activation='silu', got {activation!r}")
    check_f32(x.device, x=x, ln1_scale=ln1_scale, ln1_bias=ln1_bias, wqkv=wqkv,
              wout=wout, bout=bout, ln2_scale=ln2_scale, ln2_bias=ln2_bias, w1=w1,
              b1=b1, w2=w2, b2=b2, bias=bias, rs_attn=rs_attn, rs_ff=rs_ff)
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, H, W, C] map, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    if wqkv.ndim != 2 or wqkv.shape[1] % (3 * n_head) or w1.ndim != 2:
        raise ValueError(f"wqkv must be [C, 3·H·D] with H={n_head} and w1 [C, F]; got "
                         f"{tuple(wqkv.shape)}, {tuple(w1.shape)}")
    HD = wqkv.shape[1] // 3
    D, Fdim = HD // n_head, w1.shape[1]
    if D > MAX_DIM_HEAD:
        raise NotImplementedError(
            f"the CUDA fused_halo_layer takes heads up to {MAX_DIM_HEAD} wide; got {D}")
    check_halo_geometry(H, W, n_head, D, window, halo)
    check_bias(bias, n_head, window, halo)
    check_vector("ln1_scale", ln1_scale, C)
    check_vector("ln1_bias", ln1_bias, C)
    check_matrix("wqkv", wqkv, C, 3 * HD)
    check_matrix("wout", wout, HD, C)
    check_vector("bout", bout, C)
    check_vector("ln2_scale", ln2_scale, C)
    check_vector("ln2_bias", ln2_bias, C)
    check_matrix("w1", w1, C, Fdim)
    check_vector("b1", b1, Fdim)
    check_matrix("w2", w2, Fdim, C)
    check_vector("b2", b2, C)
    check_vector("rs_attn", rs_attn, B)
    check_vector("rs_ff", rs_ff, B)
    return B, H, W, C, D, Fdim


def _cuda_fwd(x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale, ln2_bias, w1, b1,
              w2, b2, bias, n_head, rs_attn, rs_ff, activation, window, halo, scale,
              eps, save: bool):
    """The forward kernel: out, plus (qkv, acc, z, hid, mu1, rstd1, lse, mu2,
    rstd2) when ``save``."""
    global LAUNCHES
    B, H, W, C, D, Fdim = _check(x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale,
                                 ln2_bias, w1, b1, w2, b2, bias, n_head, rs_attn, rs_ff,
                                 activation, window, halo)
    from ._build import build

    lib = build()
    HD = n_head * D
    opts = dict(device=x.device, dtype=torch.float32)
    u = torch.empty((B, H, W, C), **opts)
    qkv = torch.empty((B, H, W, 3 * HD), **opts)
    acc = torch.empty((B, H, W, HD), **opts)
    z = torch.empty((B, H, W, C), **opts)
    hid = torch.empty((B, H, W, Fdim), **opts)
    af = torch.empty((B, H, W, Fdim), **opts) if save else None
    stats = [torch.empty((B, H, W), **opts) for _ in range(2)] + \
        [torch.empty((B, n_head, H * W), **opts)] + \
        [torch.empty((B, H, W), **opts) for _ in range(2)] if save else [None] * 5
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        LAUNCHES += 1
        err = lib.vtx_fused_halo_layer_fwd(
            ptr(x), ptr(ln1_scale), ptr(ln1_bias),
            ptr(wqkv), wqkv.stride(0), wqkv.stride(1),
            ptr(wout), wout.stride(0), wout.stride(1), ptr(bout),
            ptr(ln2_scale), ptr(ln2_bias),
            ptr(w1), w1.stride(0), w1.stride(1), ptr(b1),
            ptr(w2), w2.stride(0), w2.stride(1), ptr(b2),
            ptr(bias), ptr(rs_attn), ptr(rs_ff),
            ptr(u), ptr(qkv), ptr(acc), ptr(z), ptr(hid), ptr(af),
            *map(ptr, stats), ptr(out),
            B, H, W, C, n_head, D, Fdim, window, halo, ctypes.c_float(scale),
            ctypes.c_float(eps), stream)
    _raise_on(err, "fused_halo_layer")
    return out, (qkv, acc, z, hid, *stats)


def _cuda_bwd(saved: HaloSaved, do: torch.Tensor, need_drs):
    """The backward kernel sequence: the 15 gradients of ``GRAD_NAMES``."""
    global BWD_LAUNCHES
    s = saved
    x = s.x
    do = do.contiguous()
    check_f32(x.device, do=do, qkv=s.qkv, acc=s.acc, z=s.z, hid=s.hid, lse=s.lse)
    if do.shape != x.shape:
        raise ValueError(f"do must be {tuple(x.shape)}, got {tuple(do.shape)}")
    B, H, W, C = x.shape
    nh, window, halo = s.n_head, s.window, s.halo
    HD = s.wqkv.shape[1] // 3
    D, Fdim = HD // nh, s.w1.shape[1]
    M, k = B * H * W, window + 2 * halo
    S = (H // window) * (W // window)
    chunks = dbias_chunks(B * S, nh, window, halo, D)
    from ._build import build

    lib = build()
    opts = dict(device=x.device, dtype=torch.float32)
    splits = (_splits(HD, C, M), _splits(C, 3 * HD, M), _splits(C, Fdim, M),
              _splits(Fdim, C, M))
    wpart = max(splits[0] * HD * C, splits[1] * C * 3 * HD, splits[2] * C * Fdim,
                splits[3] * Fdim * C)
    chunks_c = -(-M // 128)  # csrc COLSUM_ROWS
    ws = dict(
        da=torch.empty((M, C), **opts) if s.rs_attn is not None or s.rs_ff is not None
        else None,
        af=torch.empty((M, Fdim), **opts), dh=torch.empty((M, Fdim), **opts),
        dz=torch.empty((M, C), **opts), dacc=torch.empty((M, HD), **opts),
        dq_part=dq_partials(k * k, M, D, nh, **opts),
        dqkv=torch.empty((M, 3 * HD), **opts), u=torch.empty((M, C), **opts),
        dln=torch.empty((M, C), **opts),
        dkvw=torch.empty((B * S * k * k * 2 * HD,), **opts),
        part=torch.empty((chunks * nh * window * window * k * k,), **opts))
    wpart_t = torch.empty((wpart,), **opts)
    cpart = torch.empty((chunks_c * max(C, 3 * HD, Fdim),), **opts)
    vec = lambda n, t: torch.empty((n,), **opts) if t is not None else None  # noqa: E731
    dx = torch.empty_like(x)
    dg1, db1, dg2, db2 = (torch.empty((C,), **opts) for _ in range(4))
    dwqkv, dwout, dw1, dw2 = map(like_layout, (s.wqkv, s.wout, s.w1, s.w2))
    dbout, db1f, db2f = vec(C, s.bout), vec(Fdim, s.b1), vec(C, s.b2)
    dbias = torch.empty_like(s.bias)
    drs_attn = vec(B, s.rs_attn) if need_drs[0] else None
    drs_ff = vec(B, s.rs_ff) if need_drs[1] else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        BWD_LAUNCHES += 1
        err = lib.vtx_fused_halo_layer_bwd(
            ptr(x), ptr(s.ln1_scale), ptr(s.ln1_bias),
            ptr(s.wqkv), s.wqkv.stride(0), s.wqkv.stride(1),
            ptr(s.wout), s.wout.stride(0), s.wout.stride(1), ptr(s.bout),
            ptr(s.ln2_scale), ptr(s.ln2_bias),
            ptr(s.w1), s.w1.stride(0), s.w1.stride(1), ptr(s.b1),
            ptr(s.w2), s.w2.stride(0), s.w2.stride(1), ptr(s.b2),
            ptr(s.bias), ptr(s.rs_attn), ptr(s.rs_ff),
            *map(ptr, (s.qkv, s.acc, s.z, s.hid, s.mu1, s.rstd1, s.lse, s.mu2,
                       s.rstd2, do)),
            *(ptr(ws[n]) for n in ("da", "af", "dh", "dz", "dacc", "dq_part", "dqkv",
                                   "u", "dln", "dkvw", "part")), chunks,
            ptr(wpart_t), *splits, ptr(cpart),
            ptr(dx), ptr(dg1), ptr(db1),
            ptr(dwqkv), dwqkv.stride(0), dwqkv.stride(1),
            ptr(dwout), dwout.stride(0), dwout.stride(1), ptr(dbout),
            ptr(dg2), ptr(db2),
            ptr(dw1), dw1.stride(0), dw1.stride(1), ptr(db1f),
            ptr(dw2), dw2.stride(0), dw2.stride(1), ptr(db2f),
            ptr(dbias), ptr(drs_attn), ptr(drs_ff),
            B, H, W, C, nh, D, Fdim, window, halo, ctypes.c_float(s.scale), stream)
    _raise_on(err, "fused_halo_layer backward")
    return (dx, dg1, db1, dwqkv, dwout, dbout, dg2, db2, dw1, db1f, dw2, db2f, dbias,
            drs_attn, drs_ff)


def fused_halo_layer_fwd(x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale,
                         ln2_bias, w1, b1, w2, b2, bias, n_head: int, rs_attn=None,
                         rs_ff=None, activation: str = "silu", *, window: int,
                         halo: int, scale: Optional[float] = None, eps: float = 1e-6):
    """Training forward with saves: (out, :class:`HaloSaved`) — the kernel
    for a CUDA tensor, the plain version for a CPU one."""
    scale = _default_scale(wqkv, n_head, scale)
    if x.is_cuda:
        bias = bias.float().contiguous()
        weights = (x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale, ln2_bias, w1,
                   b1, w2, b2, bias)
        out, res = _cuda_fwd(*weights, n_head, rs_attn, rs_ff, activation, window,
                             halo, scale, float(eps), save=True)
        return out, HaloSaved(*weights, rs_attn, rs_ff, *res, n_head, activation,
                              window, halo, scale, float(eps))
    if x.device.type == "cpu":
        return fused_halo_layer_fwd_reference(
            x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale, ln2_bias, w1, b1, w2,
            b2, bias, n_head, rs_attn, rs_ff, activation, window=window, halo=halo,
            scale=scale, eps=eps)
    raise NotImplementedError(f"no fused_halo_layer for device {x.device}")


def fused_halo_layer_bwd(saved: HaloSaved, do: torch.Tensor, need_drs=(True, True)):
    """Backward on the saves of :func:`fused_halo_layer_fwd` — the kernels
    for a CUDA tensor, the plain version for a CPU one."""
    if do.is_cuda:
        return _cuda_bwd(saved, do, need_drs)
    if do.device.type == "cpu":
        return fused_halo_layer_bwd_reference(saved, do, need_drs)
    raise NotImplementedError(f"no fused_halo_layer backward for {do.device}")


class _FusedHaloLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale, ln2_bias,
                w1, b1, w2, b2, bias, rs_attn, rs_ff, n_head, activation, window,
                halo, scale, eps):
        out, saved = fused_halo_layer_fwd(
            x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale, ln2_bias, w1, b1, w2,
            b2, bias, n_head, rs_attn, rs_ff, activation, window=window, halo=halo,
            scale=scale, eps=eps)
        ctx.save_for_backward(*saved[:N_SAVED_TENSORS])
        ctx.attrs = saved[N_SAVED_TENSORS:]
        return out

    @staticmethod
    def backward(ctx, do):
        saved = HaloSaved(*ctx.saved_tensors, *ctx.attrs)
        need = ctx.needs_input_grad
        grads = fused_halo_layer_bwd(saved, do, (need[13], need[14]))
        return (*grads, None, None, None, None, None, None)


def fused_halo_layer(x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale, ln2_bias,
                     w1, b1, w2, b2, bias, n_head: int, rs_attn=None, rs_ff=None,
                     activation: str = "silu", *, window: int, halo: int,
                     scale: Optional[float] = None, eps: float = 1e-6):
    """The whole Halo layer, differentiable:
    ``z = x + rs_attn ⊙ HaloAttn(LN₁(x)); o = z + rs_ff ⊙ FF(LN₂(z))``."""
    scale = _default_scale(wqkv, n_head, scale)
    tensors = (x, ln1_scale, ln1_bias, wqkv, wout, bout, ln2_scale, ln2_bias, w1, b1,
               w2, b2, bias, rs_attn, rs_ff)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return _FusedHaloLayer.apply(*tensors, n_head, activation, window, halo, scale,
                                     float(eps))
    if x.is_cuda:
        return _cuda_fwd(*tensors[:12], bias.float().contiguous(), n_head, rs_attn,
                         rs_ff, activation, window, halo, scale, float(eps),
                         save=False)[0]
    if x.device.type == "cpu":
        return fused_halo_layer_reference(*tensors[:13], n_head, rs_attn, rs_ff,
                                          activation, window=window, halo=halo,
                                          scale=scale, eps=eps)
    raise NotImplementedError(f"no fused_halo_layer for device {x.device}")
