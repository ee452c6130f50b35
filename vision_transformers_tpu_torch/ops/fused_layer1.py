"""Whole pre-LN transformer layer, both residual branches, forward and
backward:

    z = x + rs_attn ⊙ OutProj(MHSA(QkvProj(LN₁(x)) + extra))
    o = z + rs_ff   ⊙ (act(LN₂(z)·W₁ + b₁)·W₂ + b₂)

Counterpart of ``vision_transformers_tpu/ops/fused_layer1.py::
fused_transformer_layer``, same signature and weight semantics: w1 [C, F],
w2 [F, C], activation "silu" | "gelu" (tanh approximation), extra in any of
the three forms of :mod:`.fused_layer` (Swin passes the grouped
[G, H, m, m] relative-position bias + shift mask of its window groups),
rs_attn / rs_ff optional [B] per-sample DropPath scales, the rest as in
:mod:`.fused_layer`.

A call that needs gradients goes through a ``torch.autograd.Function``
whose forward keeps what the backward reads — qkv, acc, z, the FF
pre-activation hid, the LN₁ / LN₂ statistics and the softmax log-sum-exp —
(the JAX kernel's "z+acc+qkv" save, fused_layer1.py:458-476, plus the
statistics, lse and hid, so the backward recomputes nothing but elementwise
values) and whose backward returns the gradient of every input the JAX rule
does (fused_layer1.py:578-705): x, both LayerNorms, the four weights and
their biases, extra in the caller's form, and each row scale when it is
asked for.  A call that needs none (``torch.no_grad()``, eval and serving)
saves nothing.

A CPU tensor runs the plain torch versions
(:func:`fused_transformer_layer_reference`, the cast points of the JAX
kernel: LN statistics f32, dots f32-accumulated, softmax and activation f32;
:func:`fused_transformer_layer_fwd_reference` and
:func:`fused_transformer_layer_bwd_reference`).  A CUDA tensor runs the
hand-written kernels in ``csrc/fused_layer.cu`` (forward) and
``csrc/fused_layer1_bwd.cu`` (backward) or raises; it never falls back to
the plain versions.  The kernels take ``activation="silu"``, and in
float32 the bias only with heads up to 32 wide (Swin's are 32); anything
else on a CUDA tensor raises NotImplementedError.  With x bfloat16 (the JAX package's
default precision: weights and biases bfloat16, LN parameters, row scales
and the bias float32) every call runs the kernels' bf16 forms
(``csrc/fused_layer.cu``'s ``vtx_fused_transformer_layer_fwd_bf16``,
``csrc/fused_layer1_bwd.cu``'s ``vtx_fused_transformer_layer_bwd_bf16``,
the JAX kernel's rounding points, fused_layer1.py:91-171, 221-339): ViT's
eval step, DINO's teacher, and Swin-S's training and eval with the grouped
bias on the packed-row attention's bf16 form, the bias's gradient summed
there in f32 (windows of up to 128 tokens); the backward returns dx bf16,
the LN parameters', the bias's and the row scales' gradients f32 and the
weights' and biases' summed in f32 and rounded once to bf16.  Weights may be
any 2-D strided view (the model passes ``linear.weight.t()``; its strides
go to the kernels, nothing is copied, and their gradients come back in the
view's layout).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import fused_layer
from .fused_layer import (AttnSaved, _act, _default_scale, _dot, _ln, _raise_on,
                          _residual, _splits, bias_partials, attention_branch_reference,
                          attention_half_bwd_reference, bf16_attention_workspace,
                          cast_like, check_attention_args, check_bf16_dbias,
                          check_bf16_form, check_extra, check_vector, check_matrix,
                          dq_partials, extra_grad, extra_groups, ff_half_bwd_reference,
                          ff_half_fwd_reference, fused_attention_layer_fwd_reference,
                          like_layout, ptr)

__all__ = ["fused_transformer_layer", "fused_transformer_layer_reference",
           "fused_transformer_layer_fwd", "fused_transformer_layer_bwd",
           "fused_transformer_layer_fwd_reference",
           "fused_transformer_layer_bwd_reference", "L1Saved", "LAUNCHES",
           "BWD_LAUNCHES", "BF16_LAUNCHES", "BF16_BWD_LAUNCHES", "BF16_BIAS_LAUNCHES",
           "BF16_BIAS_BWD_LAUNCHES"]

# kernel launches through this module's wrappers, forward and backward
# (chip_smoke.py reads them to show the main path went through the kernels)
LAUNCHES = 0
BWD_LAUNCHES = 0
# ... and of those, the launches of the bf16 forms, and of those the ones
# with the bias
BF16_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0
BF16_BIAS_LAUNCHES = 0
BF16_BIAS_BWD_LAUNCHES = 0

GRAD_NAMES = ("dx", "dln1_scale", "dln1_bias", "dwqkv", "dbqkv", "dwout", "dbout",
              "dln2_scale", "dln2_bias", "dw1", "db1", "dw2", "db2", "dextra",
              "drs_attn", "drs_ff")


def fused_transformer_layer_reference(x, ln1_scale, ln1_bias, wqkv, bqkv, wout,
                                      bout, ln2_scale, ln2_bias, w1, b1, w2, b2,
                                      n_head: int, extra=None, rs_attn=None,
                                      rs_ff=None, activation: str = "silu",
                                      scale: Optional[float] = None,
                                      eps: float = 1e-6):
    """Plain torch version of :func:`fused_transformer_layer` (forward)."""
    scale = _default_scale(wqkv, n_head, scale)
    a = attention_branch_reference(x, ln1_scale, ln1_bias, wqkv, bqkv, wout,
                                   bout, n_head, extra, scale, eps)
    z = _residual(x, a, rs_attn)
    u2 = _ln(z, ln2_scale, ln2_bias, eps)
    hid = _dot(u2, w1, x.dtype)
    if b1 is not None:
        hid = hid + b1
    af = _act(hid.float(), activation).to(x.dtype)
    out = _dot(af, w2, x.dtype)
    if b2 is not None:
        out = out + b2
    return _residual(z, out, rs_ff)


# ---------------------------------------------------------------------------
# training forward (saves) and backward, plain versions
# ---------------------------------------------------------------------------


class L1Saved(NamedTuple):
    """What the backward reads: the forward's inputs (extra as the grouped
    [G, H, N, N] f32 form) and residuals — qkv [B, N, 3HD], acc [B, N, HD],
    z [B, N, C], hid [B, N, F] (the FF pre-activation), mu1 / rstd1 /
    mu2 / rstd2 [B, N], lse [B, H, N]."""

    x: torch.Tensor
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wqkv: torch.Tensor
    bqkv: Optional[torch.Tensor]
    wout: torch.Tensor
    bout: Optional[torch.Tensor]
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w1: torch.Tensor
    b1: Optional[torch.Tensor]
    w2: torch.Tensor
    b2: Optional[torch.Tensor]
    extra_g: Optional[torch.Tensor]
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
    scale: float
    eps: float


N_SAVED_TENSORS = 25  # L1Saved's tensor fields; the rest are attributes


def fused_transformer_layer_fwd_reference(x, ln1_scale, ln1_bias, wqkv, bqkv,
                                          wout, bout, ln2_scale, ln2_bias, w1,
                                          b1, w2, b2, n_head: int, extra=None,
                                          rs_attn=None, rs_ff=None,
                                          activation: str = "silu",
                                          scale: Optional[float] = None,
                                          eps: float = 1e-6):
    """Plain torch training forward: (out, :class:`L1Saved`), the same
    arithmetic as :func:`fused_transformer_layer_reference` plus the saves."""
    scale = _default_scale(wqkv, n_head, scale)
    B, N, _ = x.shape
    extra_g, _ = extra_groups(extra, B, n_head, N)
    z, att = fused_attention_layer_fwd_reference(
        x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, n_head, rs_attn, scale,
        eps, extra_g=extra_g)
    out, hid, mu2, rstd2 = ff_half_fwd_reference(z, ln2_scale, ln2_bias, w1, b1, w2,
                                                 b2, rs_ff, activation, eps)
    return out, L1Saved(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
                        ln2_bias, w1, b1, w2, b2, extra_g, rs_attn, rs_ff,
                        att.qkv, att.acc, z, hid, att.mu, att.rstd, att.lse,
                        mu2, rstd2, n_head, activation, scale, float(eps))


def _attn_saved(s: L1Saved) -> AttnSaved:
    """The attention half's view of the saves."""
    return AttnSaved(s.x, s.ln1_scale, s.ln1_bias, s.wqkv, s.bqkv, s.wout, s.bout,
                     s.rs_attn, s.qkv, s.acc, s.mu1, s.rstd1, s.lse, s.extra_g,
                     s.n_head, s.scale, s.eps)


def fused_transformer_layer_bwd_reference(saved: L1Saved, do: torch.Tensor,
                                          need_drs=(True, True),
                                          need_dextra: bool = True):
    """Plain torch backward on the saves, in the kernel's steps
    (csrc/fused_layer1_bwd.cu): → the 16 gradients of ``GRAD_NAMES``; a bias
    grad is None where the bias is, dextra (grouped [G, H, N, N]) None
    without extra or ``need_dextra``, a row scale's None without it or
    where ``need_drs`` says so."""
    s = saved
    dz, dg2, db2, dw1, db1f, dw2, db2f, drs_ff = ff_half_bwd_reference(
        s.z, s.ln2_scale, s.ln2_bias, s.w1, s.b1, s.w2, s.b2, s.rs_ff, s.hid, s.mu2,
        s.rstd2, s.activation, do, need_drs[1])
    # attention half, driven by dz
    dx, dg1, db1, dwqkv, dbqkv, dwout, dbout, drs_attn, dextra = \
        attention_half_bwd_reference(_attn_saved(saved), dz, need_drs[0], need_dextra)
    return (dx.reshape(saved.x.shape).to(saved.x.dtype), dg1, db1, dwqkv, dbqkv,
            dwout, dbout, dg2, db2, dw1, db1f, dw2, db2f, dextra, drs_attn, drs_ff)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def _check(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale, ln2_bias,
           w1, b1, w2, b2, n_head, extra_g, rs_attn, rs_ff, activation, **saves):
    """Shape/type checks of the CUDA ops (``saves``: the backward's saved
    activations, bf16 where x is); returns (B, N, C, H, D, F, bf16) with
    bf16 whether the call takes the kernels' bf16 forms."""
    if activation != "silu":
        raise NotImplementedError(
            f"the CUDA kernel takes activation='silu', got {activation!r}")
    B, N, C, H, D = check_attention_args(x, ln1_scale, ln1_bias, wqkv, bqkv,
                                         wout, bout, n_head)
    bf16 = check_bf16_form(
        x, D, dict(ln1_scale=ln1_scale, ln1_bias=ln1_bias, ln2_scale=ln2_scale,
                   ln2_bias=ln2_bias, extra=extra_g, rs_attn=rs_attn, rs_ff=rs_ff),
        wqkv=wqkv, bqkv=bqkv, wout=wout, bout=bout, w1=w1, b1=b1, w2=w2, b2=b2, **saves)
    # at bf16 the bias takes the packed-row core (any N, heads up to 64 wide)
    check_extra(extra_g, H, N, D, window_only=not bf16)
    if w1.ndim != 2:
        raise ValueError(f"w1 must be [C, F], got {tuple(w1.shape)}")
    Fdim = w1.shape[1]
    check_vector("ln2_scale", ln2_scale, C)
    check_vector("ln2_bias", ln2_bias, C)
    check_matrix("w1", w1, C, Fdim)
    check_vector("b1", b1, Fdim)
    check_matrix("w2", w2, Fdim, C)
    check_vector("b2", b2, C)
    check_vector("rs_attn", rs_attn, B)
    check_vector("rs_ff", rs_ff, B)
    return B, N, C, H, D, Fdim, bf16


def _cuda_fwd(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
              ln2_bias, w1, b1, w2, b2, n_head, extra_g, groups, rs_attn, rs_ff,
              activation, scale, eps, save: bool):
    """The forward kernel: out, plus (qkv, acc, z, hid, mu1, rstd1, lse, mu2,
    rstd2) when ``save``."""
    global LAUNCHES, BF16_LAUNCHES, BF16_BIAS_LAUNCHES
    B, N, C, H, D, Fdim, bf16 = _check(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                                       ln2_scale, ln2_bias, w1, b1, w2, b2, n_head,
                                       extra_g, rs_attn, rs_ff, activation)
    from ._build import build

    lib = build()
    M, HD = B * N, H * D
    opts = dict(device=x.device, dtype=torch.float32)
    act = dict(device=x.device, dtype=x.dtype)  # the activations' workspace
    u = torch.empty((M, C), **act)
    qkv = torch.empty((B, N, 3 * HD), **act)
    acc = torch.empty((B, N, HD), **act)
    z = torch.empty((B, N, C), **act)
    hid = torch.empty((B, N, Fdim), **act)
    af = torch.empty((M, Fdim), **act) if save else None
    stats = [torch.empty((B, N), **opts) for _ in range(2)] + \
        [torch.empty((B, H, N), **opts)] + \
        [torch.empty((B, N), **opts) for _ in range(2)] if save else [None] * 5
    out = torch.empty_like(x)
    entry = lib.vtx_fused_transformer_layer_fwd_bf16 if bf16 \
        else lib.vtx_fused_transformer_layer_fwd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        LAUNCHES += 1
        BF16_LAUNCHES += bf16
        BF16_BIAS_LAUNCHES += bf16 and extra_g is not None
        fused_layer.PACKED_BF16_LAUNCHES += bf16  # its attention's bf16 form
        fused_layer.PACKED_BF16_BIAS_LAUNCHES += bf16 and extra_g is not None
        err = entry(
            ptr(x), ptr(ln1_scale), ptr(ln1_bias),
            ptr(wqkv), wqkv.stride(0), wqkv.stride(1), ptr(bqkv),
            ptr(wout), wout.stride(0), wout.stride(1), ptr(bout),
            ptr(ln2_scale), ptr(ln2_bias),
            ptr(w1), w1.stride(0), w1.stride(1), ptr(b1),
            ptr(w2), w2.stride(0), w2.stride(1), ptr(b2),
            ptr(extra_g), groups, ptr(rs_attn), ptr(rs_ff),
            ptr(u), ptr(qkv), ptr(acc), ptr(z), ptr(hid), ptr(af),
            *map(ptr, stats), ptr(out),
            B, N, C, H, D, Fdim, ctypes.c_float(scale), ctypes.c_float(eps),
            stream)
    _raise_on(err, "fused_transformer_layer")
    return out, (qkv, acc, z, hid, *stats)


def _cuda_bwd(saved: L1Saved, do: torch.Tensor, need_drs, need_dextra: bool):
    """The backward kernel sequence: the 16 gradients of ``GRAD_NAMES``."""
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES, BF16_BIAS_BWD_LAUNCHES
    s = saved
    x = s.x
    do = do.contiguous()
    if do.shape != x.shape:
        raise ValueError(f"do must be {tuple(x.shape)}, got {tuple(do.shape)}")
    B, N, C, H, D, Fdim, bf16 = _check(
        x, s.ln1_scale, s.ln1_bias, s.wqkv, s.bqkv, s.wout, s.bout, s.ln2_scale, s.ln2_bias,
        s.w1, s.b1, s.w2, s.b2, s.n_head, s.extra_g, s.rs_attn, s.rs_ff, s.activation,
        do=do, qkv=s.qkv, acc=s.acc, z=s.z, hid=s.hid)
    HD = H * D
    M = B * N
    groups = 1 if s.extra_g is None else s.extra_g.shape[0]
    want_dextra = s.extra_g is not None and need_dextra
    if bf16 and want_dextra:
        check_bf16_dbias(N)
    from ._build import build

    lib = build()
    opts = dict(device=x.device, dtype=torch.float32)
    act = dict(device=x.device, dtype=x.dtype)  # the activations' workspace
    splits = (_splits(HD, C, M), _splits(C, 3 * HD, M), _splits(C, Fdim, M),
              _splits(Fdim, C, M))
    wpart = max(splits[0] * HD * C, splits[1] * C * 3 * HD, splits[2] * C * Fdim,
                splits[3] * Fdim * C)
    chunks = -(-M // 128)  # csrc COLSUM_ROWS
    if bf16:  # the FF half's da₀, then the attention's workspace (with the dbias sums)
        dq_part = bf16_attention_workspace(B, N, H, D, s.rs_attn is not None, opts, groups,
                                           want_dextra, M * Fdim if s.rs_ff is not None else 0)
        dbpart = None
    else:
        dq_part = dq_partials(N, M, HD, opts) if s.extra_g is None else None
        dbpart = bias_partials(B, groups, H, N, opts) if want_dextra else None
    ws = dict(
        af=torch.empty((M, Fdim), **act), dh=torch.empty((M, Fdim), **act),
        dz=torch.empty((M, C), **act), dacc=torch.empty((M, HD), **act),
        dq_part=dq_part, dqkv=torch.empty((M, 3 * HD), **act),
        dln=torch.empty((M, C), **opts), dbpart=dbpart,
        wpart=torch.empty((wpart,), **opts),
        cpart=torch.empty((chunks * max(C, 3 * HD, Fdim),), **opts))
    vec = lambda n, t: torch.empty((n,), **opts) if t is not None else None  # noqa: E731
    dx = torch.empty_like(x)
    dg1, db1, dg2, db2 = (torch.empty((C,), **opts) for _ in range(4))
    dwqkv, dwout, dw1, dw2 = map(like_layout, (s.wqkv, s.wout, s.w1, s.w2))
    dbqkv, dbout = vec(3 * HD, s.bqkv), vec(C, s.bout)
    db1f, db2f = vec(Fdim, s.b1), vec(C, s.b2)
    dextra = torch.empty_like(s.extra_g) if want_dextra else None
    drs_attn = vec(B, s.rs_attn) if need_drs[0] else None
    drs_ff = vec(B, s.rs_ff) if need_drs[1] else None
    entry = lib.vtx_fused_transformer_layer_bwd_bf16 if bf16 \
        else lib.vtx_fused_transformer_layer_bwd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        BWD_LAUNCHES += 1
        BF16_BWD_LAUNCHES += bf16
        BF16_BIAS_BWD_LAUNCHES += bf16 and s.extra_g is not None
        # its attention's bf16 form, with the bias and its gradient
        fused_layer.PACKED_BF16_BWD_LAUNCHES += bf16
        fused_layer.PACKED_BF16_BIAS_BWD_LAUNCHES += bf16 and s.extra_g is not None
        fused_layer.PACKED_BF16_DBIAS_BWD_LAUNCHES += bf16 and want_dextra
        err = entry(
            ptr(x), ptr(s.ln1_scale), ptr(s.ln1_bias),
            ptr(s.wqkv), s.wqkv.stride(0), s.wqkv.stride(1), ptr(s.bqkv),
            ptr(s.wout), s.wout.stride(0), s.wout.stride(1), ptr(s.bout),
            ptr(s.ln2_scale), ptr(s.ln2_bias),
            ptr(s.w1), s.w1.stride(0), s.w1.stride(1), ptr(s.b1),
            ptr(s.w2), s.w2.stride(0), s.w2.stride(1), ptr(s.b2),
            ptr(s.extra_g), groups, ptr(s.rs_attn), ptr(s.rs_ff),
            *map(ptr, (s.qkv, s.acc, s.z, s.hid, s.mu1, s.rstd1, s.lse, s.mu2,
                       s.rstd2, do)),
            *(ptr(ws[k]) for k in ("af", "dh", "dz", "dacc", "dq_part", "dqkv", "dln",
                                   "dbpart", "wpart")),
            *splits, ptr(ws["cpart"]),
            ptr(dx), ptr(dg1), ptr(db1),
            ptr(dwqkv), dwqkv.stride(0), dwqkv.stride(1), ptr(dbqkv),
            ptr(dwout), dwout.stride(0), dwout.stride(1), ptr(dbout),
            ptr(dg2), ptr(db2),
            ptr(dw1), dw1.stride(0), dw1.stride(1), ptr(db1f),
            ptr(dw2), dw2.stride(0), dw2.stride(1), ptr(db2f),
            ptr(dextra), ptr(drs_attn), ptr(drs_ff),
            B, N, C, H, D, Fdim, ctypes.c_float(s.scale), stream)
    _raise_on(err, "fused_transformer_layer backward")
    # the weights' and biases' gradients, summed in f32, in their dtype
    return (dx, dg1, db1, cast_like(dwqkv, s.wqkv), cast_like(dbqkv, s.bqkv),
            cast_like(dwout, s.wout), cast_like(dbout, s.bout), dg2, db2,
            cast_like(dw1, s.w1), cast_like(db1f, s.b1), cast_like(dw2, s.w2),
            cast_like(db2f, s.b2), dextra, drs_attn, drs_ff)


def fused_transformer_layer_fwd(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                                ln2_scale, ln2_bias, w1, b1, w2, b2, n_head: int,
                                extra=None, rs_attn=None, rs_ff=None,
                                activation: str = "silu",
                                scale: Optional[float] = None, eps: float = 1e-6):
    """Training forward with saves: (out, :class:`L1Saved`) — the kernel for
    a CUDA tensor, the plain version for a CPU one."""
    scale = _default_scale(wqkv, n_head, scale)
    weights = (x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
               ln2_bias, w1, b1, w2, b2)
    if x.is_cuda:
        B, N, _ = x.shape
        extra_g, groups = extra_groups(extra, B, n_head, N)
        out, res = _cuda_fwd(*weights, n_head, extra_g, groups, rs_attn, rs_ff,
                             activation, scale, float(eps), save=True)
        return out, L1Saved(*weights, extra_g, rs_attn, rs_ff, *res, n_head,
                            activation, scale, float(eps))
    if x.device.type == "cpu":
        return fused_transformer_layer_fwd_reference(
            *weights, n_head, extra, rs_attn, rs_ff, activation, scale, eps)
    raise NotImplementedError(f"no fused_transformer_layer for device {x.device}")


def fused_transformer_layer_bwd(saved: L1Saved, do: torch.Tensor,
                                need_drs=(True, True), need_dextra: bool = True):
    """Backward on the saves of :func:`fused_transformer_layer_fwd` — the
    kernel for a CUDA tensor, the plain version for a CPU one; dextra comes
    back in the grouped [G, H, N, N] form."""
    if do.is_cuda:
        return _cuda_bwd(saved, do, need_drs, need_dextra)
    if do.device.type == "cpu":
        return fused_transformer_layer_bwd_reference(saved, do, need_drs, need_dextra)
    raise NotImplementedError(f"no fused_transformer_layer backward for {do.device}")


class _FusedTransformerLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
                ln2_bias, w1, b1, w2, b2, extra, rs_attn, rs_ff, n_head,
                activation, scale, eps):
        out, saved = fused_transformer_layer_fwd(
            x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale, ln2_bias,
            w1, b1, w2, b2, n_head, extra, rs_attn, rs_ff, activation, scale, eps)
        ctx.save_for_backward(*saved[:N_SAVED_TENSORS])
        ctx.attrs = saved[N_SAVED_TENSORS:]
        ctx.extra = extra  # its form; the grouped copy is among the saves
        return out

    @staticmethod
    def backward(ctx, do):
        saved = L1Saved(*ctx.saved_tensors, *ctx.attrs)
        need = ctx.needs_input_grad
        grads = fused_transformer_layer_bwd(saved, do, (need[14], need[15]), need[13])
        return (*grads[:13], extra_grad(grads[13], ctx.extra), *grads[14:],
                None, None, None, None)


def fused_transformer_layer(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                            ln2_scale, ln2_bias, w1, b1, w2, b2, n_head: int,
                            extra=None, rs_attn=None, rs_ff=None,
                            activation: str = "silu",
                            scale: Optional[float] = None, eps: float = 1e-6):
    """Whole pre-LN transformer layer, differentiable:
    ``z = x + rs_attn ⊙ Attn(LN₁(x)); o = z + rs_ff ⊙ FF(LN₂(z))``."""
    scale = _default_scale(wqkv, n_head, scale)
    tensors = (x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
               ln2_bias, w1, b1, w2, b2, extra, rs_attn, rs_ff)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return _FusedTransformerLayer.apply(*tensors, n_head, activation, scale,
                                            float(eps))
    if x.is_cuda:
        B, N, _ = x.shape
        extra_g, groups = extra_groups(extra, B, n_head, N)
        return _cuda_fwd(*tensors[:13], n_head, extra_g, groups, rs_attn, rs_ff,
                         activation, scale, float(eps), save=False)[0]
    if x.device.type == "cpu":
        return fused_transformer_layer_reference(*tensors[:13], n_head, extra, rs_attn,
                                                 rs_ff, activation, scale, eps)
    raise NotImplementedError(f"no fused_transformer_layer for device {x.device}")
