"""Reduced-kv attention, forward and backward:

    out = softmax(q·kᵀ·scale + extra)·v

with q [B, G, M, D] and k, v [B, G, N, D], M ≠ N allowed, ``scale``
defaulting to 1/√D.  Counterpart of ``vision_transformers_tpu/ops/
fused_attention.py::fused_attention``, same signature and layouts: ``extra``
optional, broadcastable to [G, M, N], its gradient un-broadcast to the
caller's form (fused_attention.py:286-294).  PVT's spatial-reduction
attention and Twins' global sub-sampled attention take it when
:func:`ops.sra_impl` says ``fused``.

A call that needs gradients goes through a ``torch.autograd.Function``
whose forward keeps the output and the softmax log-sum-exp lse [B, G, M];
its backward is the JAX ``_bwd_kernel``'s math (fused_attention.py:92-146):
p from the saved lse, dv = pᵀ·do, dS = p ⊙ (dp − Σ dp ⊙ p), dq = dS·k·scale,
dk = dSᵀ·q·scale, dextra = Σ_b dS.

A CPU tensor runs the plain torch versions, :func:`attention_fwd_reference`
(the cast points of the JAX ``_fwd_kernel``, :67-89: scores f32, the
max-subtracted softmax in f32, then p·v) and
:func:`attention_bwd_reference`.  A CUDA tensor runs the hand-written
tensor-core kernels of ``csrc/fused_attention.cu`` (3xTF32, f32-accurate)
or raises; it never falls back to the plain versions.  The kernels take
float32, heads up to ``MAX_DIM_HEAD`` wide, any N ≥ 1 and the bias
``extra`` in any form broadcastable to [G, M, N], read in place through its
(g, m) strides; its gradient Σ_b dS is summed in b order on the card and
un-broadcast by :func:`extra_grad`.  Anything else on a CUDA tensor raises
NotImplementedError.  q, k and v may be strided views with a unit
stride along D — the heads of a projection's [B, rows, G·D] output, as the
models pass them — and their strides go to the kernels instead of a copy.
The output (and dq) is written in the [B, M, G·D] memory order the output
projection reads and returned as the [B, G, M, D] view; dk and dv come back
as [B, G, N, D] views of one [2, B, N, G, D] buffer.

The module also holds the packed-qkv self-attention of the JAX module
(fused_attention.py:418-535), :func:`fused_attention_qkv`: softmax(q·kᵀ·
scale + extra)·v per head straight from the projection's [B, N, 3·H·D]
output into [B, N, H·D], with the bias in the three forms of the JAX
``_qkv_extra_form`` (shared [N, N] / [H, N, N] / [1, N, N], or grouped
[G, H, N, N]) and its gradient un-broadcast to the caller's form.  ViT's
training path with dropout takes it (``ops.attention_impl`` default
``fused``), Swin under a ``fused`` force.  Its forward keeps lse (the
Pallas backward recomputes the softmax instead).  A CPU tensor runs
:func:`qkv_attention_fwd_reference` / :func:`qkv_attention_bwd_reference`;
a CUDA tensor runs the tensor-core kernels of
``csrc/fused_attention_qkv.cu`` (the core B6 runs, 3xTF32), which read qkv
and write out and dqkv in place in the packed layout, f32, heads up to 64
wide with or without the bias; anything else on a CUDA tensor raises
NotImplementedError.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from .fused_layer import _raise_on, _scores_bias, check_f32, dq_partials, extra_groups, ptr
from .fused_layer import extra_grad as layer_extra_grad

__all__ = ["fused_attention", "fused_attention_reference", "fused_attention_fwd",
           "fused_attention_bwd", "attention_fwd_reference", "attention_bwd_reference",
           "dkdv_chunks", "SraSaved", "LAUNCHES", "BWD_LAUNCHES", "fused_attention_qkv",
           "fused_attention_qkv_reference", "fused_attention_qkv_fwd",
           "fused_attention_qkv_bwd", "qkv_attention_fwd_reference",
           "qkv_attention_bwd_reference", "QkvSaved", "QKV_LAUNCHES", "QKV_BWD_LAUNCHES"]

# kernel launches through this module's wrappers, forward and backward
# (chip_smoke.py reads them to show the main path went through the kernels)
LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_DIM_HEAD = 64  # csrc DMAX: the widest head the kernels stage
_TILE = 64  # csrc attention_tc.cuh TQ = TK: the backward's queries / keys per tile
_SMS = 132  # H100 SXM; the backward holds one 8-warp block an SM


def _default_scale(D: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(D) if scale is None else float(scale)


def _scores(q, k, extra, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return s if extra is None else s + extra.float()


def attention_fwd_reference(q, k, v, extra, scale: float):
    """Plain forward with the saves: (out [B, G, M, D] in q's dtype, lse
    [B, G, M] f32)."""
    s = _scores(q, k, extra, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    out = torch.matmul((p / l).to(v.dtype).float(), v.float()).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def fused_attention_reference(q, k, v, extra=None, scale: Optional[float] = None):
    """Plain torch version of :func:`fused_attention` (forward)."""
    return attention_fwd_reference(q, k, v, extra, _default_scale(q.shape[-1], scale))[0]


def attention_bwd_reference(q, k, v, extra, lse, do, scale: float,
                            need_dextra: bool = True):
    """Plain backward, f32: → (dq, dk, dv, dextra) with dextra [G, M, N]
    (summed over B; None without ``extra`` or ``need_dextra``)."""
    f = torch.float32
    p = torch.exp(_scores(q, k, extra, scale) - lse[..., None].to(f))
    do = do.to(f)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.to(f).transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dextra = ds.sum(0) if extra is not None and need_dextra else None
    dq = torch.matmul(ds * scale, k.to(f))
    dk = torch.matmul((ds * scale).transpose(-1, -2), q.to(f))
    return dq, dk, dv, dextra


def extra_grad(dextra: Optional[torch.Tensor], extra: Optional[torch.Tensor]):
    """dextra [G, M, N] un-broadcast to the caller's ``extra``: summed over
    the leading dimensions it lacks and over each dimension it broadcasts
    (the JAX rule, fused_attention.py:286-294, for [M, N] and [1, M, N])."""
    if extra is None or dextra is None:
        return None
    d = dextra
    while d.ndim > extra.ndim:
        d = d.sum(0)
    for i, n in enumerate(extra.shape):
        if n == 1 and d.shape[i] != 1:
            d = d.sum(i, keepdim=True)
    return d.to(extra.dtype)


class SraSaved(NamedTuple):
    """What the backward reads: q, k, v, the bias (or None), the output and
    lse [B, G, M]."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    extra: Optional[torch.Tensor]
    out: torch.Tensor
    lse: torch.Tensor
    scale: float


N_SAVED_TENSORS = 6  # SraSaved's tensor fields; the rest are attributes


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def _unit_d(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its D stride is 1 (the kernels read rows in place),
    else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _check(q, k, v, extra=None):
    """Shapes and types the kernels take; returns (B, G, M, N, D)."""
    check_f32(q.device, q=q, k=k, v=v, extra=extra)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be [B, G, rows, D] tensors")
    B, G, M, D = q.shape
    N = k.shape[2]
    if tuple(k.shape) != (B, G, N, D) or tuple(v.shape) != (B, G, N, D):
        raise ValueError(f"k and v must be [{B}, {G}, N, {D}]; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if min(B, G, M, N, D) < 1:
        raise ValueError(f"empty attention problem {tuple(q.shape)} x {tuple(k.shape)}")
    if D > MAX_DIM_HEAD:
        raise NotImplementedError(
            f"the CUDA fused_attention holds heads up to {MAX_DIM_HEAD} wide; got {D}")
    if extra is not None:
        try:
            ok = torch.broadcast_shapes(extra.shape, (G, M, N)) == (G, M, N)
        except RuntimeError:
            ok = False
        if not ok:
            raise ValueError(f"extra {tuple(extra.shape)} does not broadcast to "
                             f"[{G}, {M}, {N}]")
    return B, G, M, N, D


def _bias_view(extra, G: int, M: int, N: int):
    """(extra as a [G, M, N] view with a unit stride along N, its g stride,
    its m stride), or (None, 0, 0): a broadcast dimension gets stride 0 and
    no copy is made unless N itself is broadcast."""
    if extra is None:
        return None, 0, 0
    e = extra.expand(G, M, N)
    if e.stride(2) != 1:
        e = e.contiguous()
    return e, e.stride(0), e.stride(1)


def dkdv_chunks(B: int, G: int, M: int, N: int) -> int:
    """Chunks of the M queries for the backward: a block per (chunk, key
    tile, g, b), about two waves of them, each chunk's dk / dv a partial
    summed in order afterwards; no chunk is empty."""
    q_tiles, key_tiles = -(-M // _TILE), -(-N // _TILE)
    chunks = max(1, min(q_tiles, 2 * _SMS // (B * G * key_tiles)))
    per = -(-q_tiles // chunks)
    return -(-q_tiles // per)


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _cuda_fwd(q, k, v, extra, scale, save: bool):
    """The forward kernel: out (the [B, G, M, D] view of a [B, M, G, D]
    buffer) and, when ``save``, lse [B, G, M]."""
    global LAUNCHES
    q, k, v = map(_unit_d, (q, k, v))
    B, G, M, N, D = _check(q, k, v, extra)
    e, e_sg, e_sm = _bias_view(extra, G, M, N)
    from ._build import build

    lib = build()
    opts = dict(device=q.device, dtype=torch.float32)
    out = torch.empty((B, M, G, D), **opts).permute(0, 2, 1, 3)
    lse = torch.empty((B, G, M), **opts) if save else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LAUNCHES += 1
        err = lib.vtx_fused_attention_fwd(
            ptr(q), *_strides(q), ptr(k), *_strides(k), ptr(v), *_strides(v),
            ptr(e), e_sg, e_sm, ptr(out), ptr(lse), B, G, M, N, D, ctypes.c_float(scale),
            stream)
    _raise_on(err, "fused_attention")
    return out, lse


def _cuda_bwd(saved: SraSaved, do: torch.Tensor, need_dextra: bool = True):
    """The backward kernel sequence: (dq, dk, dv, dextra [G, M, N] or None)."""
    global BWD_LAUNCHES
    q, k, v, extra, out, lse = saved[:N_SAVED_TENSORS]
    q, k, v, do = map(_unit_d, (q, k, v, do))
    check_f32(q.device, do=do, out=out, lse=lse)
    B, G, M, N, D = _check(q, k, v, extra)
    if do.shape != q.shape:
        raise ValueError(f"do must be {tuple(q.shape)}, got {tuple(do.shape)}")
    if out.permute(0, 2, 1, 3).stride() != (M * G * D, G * D, D, 1):
        raise ValueError("out must be the forward kernel's [B, M, G, D] buffer")
    e, e_sg, e_sm = _bias_view(extra, G, M, N)
    want_dextra = extra is not None and need_dextra
    chunks = dkdv_chunks(B, G, M, N)
    from ._build import build

    lib = build()
    opts = dict(device=q.device, dtype=torch.float32)
    dq_part = dq_partials(N, B * M, G * D, opts)
    dkv_part = torch.empty((2 * chunks * B * N * G * D,), **opts) if chunks > 1 else None
    dsbuf = torch.empty((B * G * M * N,), **opts) if want_dextra else None
    dq = torch.empty((B, M, G, D), **opts).permute(0, 2, 1, 3)
    dkv = torch.empty((2, B, N, G, D), **opts)
    dextra = torch.empty((G, M, N), **opts) if want_dextra else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        BWD_LAUNCHES += 1
        err = lib.vtx_fused_attention_bwd(
            ptr(q), *_strides(q), ptr(k), *_strides(k), ptr(v), *_strides(v),
            ptr(e), e_sg, e_sm, ptr(out), ptr(lse), ptr(do), *_strides(do), ptr(dq_part),
            ptr(dkv_part), chunks, ptr(dsbuf), ptr(dq), ptr(dkv), ptr(dextra), B, G, M, N,
            D, ctypes.c_float(saved.scale), stream)
    _raise_on(err, "fused_attention backward")
    return dq, dkv[0].permute(0, 2, 1, 3), dkv[1].permute(0, 2, 1, 3), dextra


def fused_attention_fwd(q, k, v, extra=None, scale: Optional[float] = None):
    """Training forward with saves: (out, :class:`SraSaved`) — the kernel for
    a CUDA tensor, the plain version for a CPU one."""
    scale = _default_scale(q.shape[-1], scale)
    if q.is_cuda:
        out, lse = _cuda_fwd(q, k, v, extra, scale, save=True)
    elif q.device.type == "cpu":
        out, lse = attention_fwd_reference(q, k, v, extra, scale)
    else:
        raise NotImplementedError(f"no fused_attention for device {q.device}")
    return out, SraSaved(q, k, v, extra, out, lse, scale)


def fused_attention_bwd(saved: SraSaved, do: torch.Tensor, need_dextra: bool = True):
    """Backward on the saves of :func:`fused_attention_fwd`: (dq, dk, dv,
    dextra [G, M, N] or None) — the kernels for a CUDA tensor, the plain
    version for a CPU one."""
    if do.is_cuda:
        return _cuda_bwd(saved, do, need_dextra)
    if do.device.type == "cpu":
        q, k, v, extra, _, lse = saved[:N_SAVED_TENSORS]
        dq, dk, dv, dextra = attention_bwd_reference(q, k, v, extra, lse, do,
                                                     saved.scale, need_dextra)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dextra
    raise NotImplementedError(f"no fused_attention backward for {do.device}")


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, extra, scale):
        out, saved = fused_attention_fwd(q, k, v, extra, scale)
        ctx.save_for_backward(*saved[:N_SAVED_TENSORS])
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        saved = SraSaved(*ctx.saved_tensors, ctx.scale)
        dq, dk, dv, dextra = fused_attention_bwd(saved, do, ctx.needs_input_grad[3])
        return dq, dk, dv, extra_grad(dextra, saved.extra), None


def fused_attention(q, k, v, extra=None, scale: Optional[float] = None):
    """softmax(q·kᵀ·scale + extra)·v, differentiable in q, k, v and extra:
    q [B, G, M, D], k / v [B, G, N, D], extra broadcastable to [G, M, N] or
    None → [B, G, M, D]."""
    scale = _default_scale(q.shape[-1], scale)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, extra)):
        return _FusedAttention.apply(q, k, v, extra, scale)
    if q.is_cuda:
        return _cuda_fwd(q, k, v, extra, scale, save=False)[0]
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, extra, scale)
    raise NotImplementedError(f"no fused_attention for device {q.device}")


# ---------------------------------------------------------------------------
# packed-qkv self-attention: fused_attention_qkv (B3)
# ---------------------------------------------------------------------------

# kernel launches through fused_attention_qkv's wrappers, forward and backward
QKV_LAUNCHES = 0
QKV_BWD_LAUNCHES = 0

def _qkv_heads(qkv: torch.Tensor, n_head: int):
    """[B, N, 3·H·D] → q, k, v as f32 [B, H, N, D]."""
    B, N, C3 = qkv.shape
    D = C3 // (3 * n_head)
    t = qkv.float().reshape(B, N, 3, n_head, D)
    return (t[:, :, i].permute(0, 2, 1, 3) for i in range(3))


def _qkv_scores(qkv, n_head, extra_g, scale):
    q, k, v = _qkv_heads(qkv, n_head)
    return _scores_bias(torch.matmul(q, k.transpose(-1, -2)) * scale, extra_g), q, k, v


def qkv_attention_fwd_reference(qkv, n_head: int, extra_g, scale: float):
    """Plain forward with the saves, the JAX ``_qkv_fwd_kernel``'s cast
    points (fused_attention.py:313-339: scores f32, max-subtracted softmax
    in f32, then p·v): (out [B, N, H·D] in qkv's dtype, lse [B, H, N] f32);
    ``extra_g`` the grouped bias [G, H, N, N] or None."""
    B, N, _ = qkv.shape
    s, _, _, v = _qkv_scores(qkv, n_head, extra_g, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    out = torch.matmul((p / l).to(qkv.dtype).float(), v)
    return (out.permute(0, 2, 1, 3).reshape(B, N, -1).to(qkv.dtype),
            (m + torch.log(l))[..., 0])


def fused_attention_qkv_reference(qkv, n_head: int, extra=None,
                                  scale: Optional[float] = None):
    """Plain torch version of :func:`fused_attention_qkv` (forward)."""
    B, N, C3 = qkv.shape
    scale = _default_scale(C3 // (3 * n_head), scale)
    extra_g, _ = extra_groups(extra, B, n_head, N)
    return qkv_attention_fwd_reference(qkv, n_head, extra_g, scale)[0]


def qkv_attention_bwd_reference(qkv, n_head: int, extra_g, do, scale: float,
                                need_dextra: bool = True):
    """Plain backward in the JAX ``_qkv_bwd_kernel``'s math
    (fused_attention.py:342-396): p recomputed, dv = pᵀ·do, dp = do·vᵀ,
    dS = p ⊙ (dp − Σ dp ⊙ p), dq = dS·k·scale, dk = dSᵀ·q·scale, dextra the
    sum of dS over each group's rows → (dqkv [B, N, 3·H·D] in qkv's dtype,
    dextra_g [G, H, N, N] f32 or None)."""
    B, N, _ = qkv.shape
    f = torch.float32
    s, q, k, v = _qkv_scores(qkv, n_head, extra_g, scale)
    p = torch.softmax(s, dim=-1)
    do = do.to(f).reshape(B, N, n_head, -1).permute(0, 2, 1, 3)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dextra_g = None
    if extra_g is not None and need_dextra:
        G = extra_g.shape[0]
        dextra_g = ds.reshape(G, B // G, *ds.shape[1:]).sum(1)
    dq = torch.matmul(ds * scale, k)
    dk = torch.matmul((ds * scale).transpose(-1, -2), q)
    dqkv = torch.stack([t.permute(0, 2, 1, 3) for t in (dq, dk, dv)], 2)
    return dqkv.reshape(qkv.shape).to(qkv.dtype), dextra_g


class QkvSaved(NamedTuple):
    """What B3's backward reads: qkv, the bias in its grouped [G, H, N, N]
    f32 form (or None), the output and lse [B, H, N]."""

    qkv: torch.Tensor
    extra_g: Optional[torch.Tensor]
    out: torch.Tensor
    lse: torch.Tensor
    n_head: int
    scale: float


N_QKV_SAVED_TENSORS = 4  # QkvSaved's tensor fields; the rest are attributes


def _check_qkv(qkv, n_head, extra_g):
    """Shapes and types B3's kernels take; returns (B, N, H, D)."""
    check_f32(qkv.device, qkv=qkv, extra=extra_g)
    if qkv.ndim != 3 or not qkv.is_contiguous():
        raise ValueError(f"qkv must be a contiguous [B, N, 3·H·D] tensor, got shape "
                         f"{tuple(qkv.shape)} strides {qkv.stride()}")
    B, N, C3 = qkv.shape
    if C3 % (3 * n_head) or min(B, N, C3) < 1:
        raise ValueError(f"qkv [B, N, 3·H·D] with H={n_head}: got {tuple(qkv.shape)}")
    D = C3 // (3 * n_head)
    if D > MAX_DIM_HEAD:
        raise NotImplementedError(
            f"the CUDA fused_attention_qkv holds heads up to {MAX_DIM_HEAD} wide; got "
            f"{D} (ROADMAP B)")
    if extra_g is not None:
        if extra_g.ndim != 4 or tuple(extra_g.shape[1:]) != (n_head, N, N) \
                or B % extra_g.shape[0] or not extra_g.is_contiguous():
            raise ValueError(f"extra must be a contiguous [G, {n_head}, {N}, {N}] with "
                             f"G dividing {B}, got {tuple(extra_g.shape)}")
    return B, N, n_head, D


def _groups(extra_g) -> int:
    return 1 if extra_g is None else extra_g.shape[0]


def _cuda_qkv_fwd(qkv, n_head, extra_g, scale, save: bool):
    """B3's forward kernel: out [B, N, H·D] and, when ``save``, lse."""
    global QKV_LAUNCHES
    B, N, H, D = _check_qkv(qkv, n_head, extra_g)
    from ._build import build

    lib = build()
    opts = dict(device=qkv.device, dtype=torch.float32)
    out = torch.empty((B, N, H * D), **opts)
    lse = torch.empty((B, H, N), **opts) if save else None
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        QKV_LAUNCHES += 1
        err = lib.vtx_fused_attention_qkv_fwd(
            ptr(qkv), ptr(extra_g), _groups(extra_g), ptr(out), ptr(lse), B, N, H, D,
            ctypes.c_float(scale), stream)
    _raise_on(err, "fused_attention_qkv")
    return out, lse


def _cuda_qkv_bwd(saved: QkvSaved, do: torch.Tensor, need_dextra: bool):
    """B3's backward kernel sequence: (dqkv, dextra_g or None)."""
    global QKV_BWD_LAUNCHES
    qkv, extra_g, out, lse = saved[:N_QKV_SAVED_TENSORS]
    do = do.contiguous()
    B, N, H, D = _check_qkv(qkv, saved.n_head, extra_g)
    check_f32(qkv.device, do=do, out=out, lse=lse)
    if do.shape != out.shape or tuple(out.shape) != (B, N, H * D):
        raise ValueError(f"do and out must be [{B}, {N}, {H * D}], got "
                         f"{tuple(do.shape)}, {tuple(out.shape)}")
    want_dextra = extra_g is not None and need_dextra
    from ._build import build

    lib = build()
    opts = dict(device=qkv.device, dtype=torch.float32)
    dq_part = dq_partials(N, B * N, H * D, opts)
    dsbuf = torch.empty((B, H, N, N), **opts) if want_dextra else None
    dqkv = torch.empty_like(qkv)
    dextra = torch.empty_like(extra_g) if want_dextra else None
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        QKV_BWD_LAUNCHES += 1
        err = lib.vtx_fused_attention_qkv_bwd(
            ptr(qkv), ptr(extra_g), _groups(extra_g), ptr(out), ptr(lse), ptr(do),
            ptr(dq_part), ptr(dsbuf), ptr(dqkv), ptr(dextra), B, N, H, D,
            ctypes.c_float(saved.scale), stream)
    _raise_on(err, "fused_attention_qkv backward")
    return dqkv, dextra


def fused_attention_qkv_fwd(qkv, n_head: int, extra=None, scale: Optional[float] = None):
    """Training forward with saves: (out, :class:`QkvSaved`) — the kernel for
    a CUDA tensor, the plain version for a CPU one; ``extra`` in any of the
    forms of :func:`fused_attention_qkv`."""
    B, N, C3 = qkv.shape
    scale = _default_scale(C3 // (3 * n_head), scale)
    extra_g, _ = extra_groups(extra, B, n_head, N)
    if qkv.is_cuda:
        out, lse = _cuda_qkv_fwd(qkv, n_head, extra_g, scale, save=True)
    elif qkv.device.type == "cpu":
        out, lse = qkv_attention_fwd_reference(qkv, n_head, extra_g, scale)
    else:
        raise NotImplementedError(f"no fused_attention_qkv for device {qkv.device}")
    return out, QkvSaved(qkv, extra_g, out, lse, n_head, scale)


def fused_attention_qkv_bwd(saved: QkvSaved, do: torch.Tensor, need_dextra: bool = True):
    """Backward on the saves of :func:`fused_attention_qkv_fwd`: (dqkv,
    dextra in the grouped [G, H, N, N] form or None) — the kernels for a
    CUDA tensor, the plain version for a CPU one."""
    if do.is_cuda:
        return _cuda_qkv_bwd(saved, do, need_dextra)
    if do.device.type == "cpu":
        return qkv_attention_bwd_reference(saved.qkv, saved.n_head, saved.extra_g, do,
                                           saved.scale, need_dextra)
    raise NotImplementedError(f"no fused_attention_qkv backward for {do.device}")


class _FusedAttentionQkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, extra, n_head, scale):
        out, saved = fused_attention_qkv_fwd(qkv, n_head, extra, scale)
        ctx.save_for_backward(*saved[:N_QKV_SAVED_TENSORS])
        ctx.attrs = saved[N_QKV_SAVED_TENSORS:]
        ctx.extra = extra  # its form; the grouped copy is among the saves
        return out

    @staticmethod
    def backward(ctx, do):
        saved = QkvSaved(*ctx.saved_tensors, *ctx.attrs)
        dqkv, dextra = fused_attention_qkv_bwd(saved, do, ctx.needs_input_grad[1])
        return dqkv, layer_extra_grad(dextra, ctx.extra), None, None


def fused_attention_qkv(qkv, n_head: int, extra=None, scale: Optional[float] = None):
    """Multi-head self-attention straight from the packed projection, the
    JAX ``fused_attention_qkv`` (fused_attention.py:437): qkv [B, N, 3·H·D]
    (q-heads | k-heads | v-heads) → [B, N, H·D], the out projection's
    input; ``extra`` an additive bias [N, N], [H, N, N] or [1, N, N] shared
    by every row, or [G, H, N, N] grouped over G contiguous batch groups
    (row b in group b // (B/G)); differentiable in qkv and extra, whose
    gradient comes back in the caller's form."""
    B, N, C3 = qkv.shape
    scale = _default_scale(C3 // (3 * n_head), scale)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (qkv, extra)):
        return _FusedAttentionQkv.apply(qkv, extra, n_head, scale)
    if qkv.is_cuda:
        return _cuda_qkv_fwd(qkv, n_head, extra_groups(extra, B, n_head, N)[0], scale,
                             save=False)[0]
    if qkv.device.type == "cpu":
        return fused_attention_qkv_reference(qkv, n_head, extra, scale)
    raise NotImplementedError(f"no fused_attention_qkv for device {qkv.device}")
