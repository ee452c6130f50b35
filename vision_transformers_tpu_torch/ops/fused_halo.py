"""Halo windowed attention straight off the feature map, forward and backward:

    out[b, y, x, h] = Σ_j softmax_j(q·k_j·scale + bias[h, i, j]) v_j

for the query at (y, x), the i-th of its window's w² (w = ``window``), over
the k² positions j of the k x k neighbourhood centred on the window
(k = w + 2·halo), row-major.  Neighbourhood positions outside the map are
zero keys and values (the reference zero-pads the projected kv): they score
``bias`` alone and take softmax mass.

Counterpart of ``vision_transformers_tpu/ops/fused_halo.py::
halo_attention_direct``, same signature and layouts: q [b, H, W, C], kv
[b, H, W, 2C] (k lanes, then v lanes), C = n_head·D with head h on lanes
[h·D, (h+1)·D), bias [n_head, w², k²] f32 and differentiable.  The
gradients of q, kv and bias come from a ``torch.autograd.Function`` whose
forward keeps the output and the softmax log-sum-exp lse [b, n_head, H·W]
(the JAX rule recomputes the scores twice; here the backward reads lse).
The projections around it (qkv in, out after) stay ``torch.matmul``, as the
JAX package computes them outside Pallas.

A CPU tensor runs the plain torch versions
(:func:`attention_fwd_reference`, :func:`attention_bwd_reference`: f32
scores, softmax and products, the kernels' steps); the whole Halo layer's
op (:mod:`.fused_halo_layer`) shares them.  A CUDA tensor runs the
hand-written kernels of ``csrc/fused_halo.cu`` or raises; it never falls
back to the plain versions.  The kernels take float32, heads up to
``MAX_DIM_HEAD`` wide, windows of up to ``MAX_QUERIES`` tokens and
2·halo ≤ window (each token lies in at most 2 x 2 neighbourhoods);
anything else on a CUDA tensor raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .fused_layer import _raise_on, check_f32, ptr

__all__ = ["halo_attention_direct", "halo_attention_direct_reference",
           "halo_attention_direct_fwd", "halo_attention_direct_bwd",
           "attention_fwd_reference", "attention_bwd_reference", "neighborhoods",
           "fold_neighborhoods", "windows", "unwindows", "DirectSaved", "LAUNCHES",
           "BWD_LAUNCHES"]

# kernel launches through this module's wrappers, forward and backward
# (chip_smoke.py reads them to show the main path went through the kernels)
LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_DIM_HEAD = 32  # csrc HDH: the register width of a head
MAX_QUERIES = 64   # csrc HQ: one query of a window per thread

# dk / dv blocks to aim the backward's chunking at: two waves of 132 SMs x
# the 6 blocks (37 KB of shared memory each) one SM holds
_DKDV_BLOCKS = 2 * 132 * 6


# ---------------------------------------------------------------------------
# windows and neighbourhoods (NHWC maps)
# ---------------------------------------------------------------------------


def windows(t: torch.Tensor, window: int) -> torch.Tensor:
    """[b, H, W, C] → [b, S, w², C]: S windows row-major, tokens row-major."""
    b, H, W, C = t.shape
    t = t.reshape(b, H // window, window, W // window, window, C).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, -1, window * window, C)


def unwindows(t: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`windows`: [b, S, w², C] → [b, H, W, C]."""
    b, C = t.shape[0], t.shape[-1]
    t = t.reshape(b, H // window, W // window, window, window, C).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, H, W, C)


def neighborhoods(t: torch.Tensor, window: int, halo: int) -> torch.Tensor:
    """[b, H, W, C] → [b, S, k², C]: each window's k x k neighbourhood,
    row-major, zero outside the map (the JAX ``halo_neighborhoods``, torch
    unfold's values)."""
    k = window + 2 * halo
    p = F.pad(t, (0, 0, halo, halo, halo, halo))
    p = p.unfold(1, k, window).unfold(2, k, window)  # [b, hs, ws, C, ky, kx]
    b, hs, ws, C = p.shape[:4]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(b, hs * ws, k * k, C)


def fold_neighborhoods(nb: torch.Tensor, window: int, halo: int, H: int,
                       W: int) -> torch.Tensor:
    """The adjoint of :func:`neighborhoods`: [b, S, k², C] → [b, H, W, C],
    each token the sum of its positions in every neighbourhood, positions
    outside the map dropped."""
    k = window + 2 * halo
    hs, ws = H // window, W // window
    b, C = nb.shape[0], nb.shape[-1]
    nb = nb.reshape(b, hs, ws, k, k, C)
    out = nb.new_zeros(b, H + 2 * halo, W + 2 * halo, C)
    for ky in range(k):
        for kx in range(k):
            out[:, ky:ky + (hs - 1) * window + 1:window,
                kx:kx + (ws - 1) * window + 1:window] += nb[:, :, :, ky, kx]
    return out[:, halo:halo + H, halo:halo + W]


def _split_heads(t: torch.Tensor, n_head: int) -> torch.Tensor:
    """[b, S, n, H·D] → [b, S, H, n, D] f32."""
    b, S, n, HD = t.shape
    return t.reshape(b, S, n, n_head, HD // n_head).permute(0, 1, 3, 2, 4).float()


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[b, S, H, n, D] → [b, S, n, H·D]."""
    b, S, H, n, D = t.shape
    return t.permute(0, 1, 3, 2, 4).reshape(b, S, n, H * D)


def _lse_tokens(lse: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    """[b, S, heads, w²] → [b, heads, H·W] (the kernels' layout)."""
    b, S, nh, n = lse.shape
    t = lse.permute(0, 2, 1, 3).reshape(b * nh, S, n, 1)
    return unwindows(t, window, H, W).reshape(b, nh, H * W)


def _lse_windows(lse: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`_lse_tokens`."""
    b, nh, _ = lse.shape
    t = windows(lse.reshape(b * nh, H, W, 1), window)
    return t.reshape(b, nh, -1, window * window).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in f32)
# ---------------------------------------------------------------------------


def _scores(q, k, bias, n_head, window, halo, scale):
    """(qw, kn, s): window queries [b, S, H, w², D], neighbourhood keys
    [b, S, H, k², D] and the biased scaled scores [b, S, H, w², k²]."""
    qw = _split_heads(windows(q, window), n_head)
    kn = _split_heads(neighborhoods(k, window, halo), n_head)
    s = torch.einsum("bshqd,bshkd->bshqk", qw, kn) * scale + bias.float()[None, None]
    return qw, kn, s


def attention_fwd_reference(q, k, v, bias, n_head: int, window: int, halo: int,
                            scale: float):
    """Halo attention on the maps q, k, v [b, H, W, HD] (any strides): →
    (out [b, H, W, HD] in q's dtype, lse [b, n_head, H·W] f32)."""
    _, H, W, _ = q.shape
    _, _, s = _scores(q, k, bias, n_head, window, halo, scale)
    vn = _split_heads(neighborhoods(v, window, halo), n_head)
    o = torch.einsum("bshqk,bshkd->bshqd", torch.softmax(s, dim=-1), vn)
    out = unwindows(_merge_heads(o), window, H, W).to(q.dtype)
    return out, _lse_tokens(torch.logsumexp(s, dim=-1), window, H, W)


def attention_bwd_reference(q, k, v, bias, out, lse, do, n_head: int, window: int,
                            halo: int, scale: float):
    """The plain backward in the kernels' steps, f32: Δ = rowsum(do ⊙ out),
    p from the saved lse, dv = pᵀ·do, dS = p ⊙ (do·vᵀ − Δ), dq = dS·k·s,
    dk = dSᵀ·q·s, dbias = Σ over images and windows of dS, and dk / dv
    folded back onto the map: → (dq, dk, dv [b, H, W, HD], dbias
    [n_head, w², k²])."""
    _, H, W, _ = q.shape
    qw, kn, s = _scores(q, k, bias, n_head, window, halo, scale)
    vn = _split_heads(neighborhoods(v, window, halo), n_head)
    dow = _split_heads(windows(do, window), n_head)
    delta = (dow * _split_heads(windows(out, window), n_head)).sum(-1, keepdim=True)
    p = torch.exp(s - _lse_windows(lse.float(), window, H, W)[..., None])
    dvn = torch.einsum("bshqk,bshqd->bshkd", p, dow)
    ds = p * (torch.einsum("bshqd,bshkd->bshqk", dow, vn) - delta)
    dq = torch.einsum("bshqk,bshkd->bshqd", ds, kn) * scale
    dkn = torch.einsum("bshqk,bshqd->bshkd", ds, qw) * scale
    fold = lambda t: fold_neighborhoods(_merge_heads(t), window, halo, H, W)  # noqa: E731
    return (unwindows(_merge_heads(dq), window, H, W), fold(dkn), fold(dvn),
            ds.sum((0, 1)))


def _default_scale(C: int, n_head: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(C // n_head) if scale is None else float(scale)


def halo_attention_direct_reference(q, kv, bias, window: int, halo: int, n_head: int,
                                    scale: Optional[float] = None):
    """Plain torch version of :func:`halo_attention_direct` (forward)."""
    C = q.shape[-1]
    scale = _default_scale(C, n_head, scale)
    return attention_fwd_reference(q, kv[..., :C], kv[..., C:], bias, n_head, window,
                                   halo, scale)[0]


class DirectSaved(NamedTuple):
    """What the backward reads: q, kv, bias (contiguous f32), the output and
    lse [b, n_head, H·W]."""

    q: torch.Tensor
    kv: torch.Tensor
    bias: torch.Tensor
    out: torch.Tensor
    lse: torch.Tensor
    window: int
    halo: int
    n_head: int
    scale: float


N_SAVED_TENSORS = 5  # DirectSaved's tensor fields; the rest are attributes


def halo_attention_direct_bwd_reference(saved: DirectSaved, do: torch.Tensor):
    """Plain backward on the saves: → (dq, dkv, dbias)."""
    q, kv, bias, out, lse = saved[:5]
    C = q.shape[-1]
    dq, dk, dv, dbias = attention_bwd_reference(
        q, kv[..., :C], kv[..., C:], bias, out, lse, do, saved.n_head, saved.window,
        saved.halo, saved.scale)
    return dq.to(q.dtype), torch.cat([dk, dv], -1).to(kv.dtype), dbias.to(bias.dtype)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def check_halo_geometry(H: int, W: int, n_head: int, D: int, window: int,
                        halo: int) -> None:
    """Raise for a map or head the CUDA kernels do not take."""
    if H % window or W % window:
        raise ValueError(f"the map {H}x{W} is not a whole number of {window}x{window} "
                         f"windows")
    if 2 * halo > window:
        raise NotImplementedError(
            f"the CUDA halo kernels need 2·halo ≤ window (got window {window}, halo "
            f"{halo}); the gather kernel for wider halos is not ported (ROADMAP B5)")
    if window * window > MAX_QUERIES or D > MAX_DIM_HEAD:
        raise NotImplementedError(
            f"the CUDA halo kernels take windows of up to {MAX_QUERIES} tokens and heads "
            f"up to {MAX_DIM_HEAD} wide; got window {window}, head width {D}")


def check_bias(bias: torch.Tensor, n_head: int, window: int, halo: int) -> None:
    k = window + 2 * halo
    want = (n_head, window * window, k * k)
    if tuple(bias.shape) != want or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous {list(want)} tensor, got shape "
                         f"{tuple(bias.shape)} strides {bias.stride()}")


def dbias_chunks(pairs: int, n_head: int, window: int, halo: int) -> int:
    """Chunks of the B·S (image, window) pairs for the dk / dv pass: one
    dbias partial [n_head, w², k²] each, summed in order afterwards."""
    k = window + 2 * halo
    key_tiles = -(-k * k // 64)  # csrc HKB
    return max(1, min(pairs, _DKDV_BLOCKS // (key_tiles * n_head)))


def _check_maps(q, kv, n_head):
    if q.ndim != 4 or not q.is_contiguous() or not kv.is_contiguous():
        raise ValueError("q and kv must be contiguous [b, H, W, C] / [b, H, W, 2C] maps")
    b, H, W, C = q.shape
    if tuple(kv.shape) != (b, H, W, 2 * C) or C % n_head:
        raise ValueError(f"kv must be [{b}, {H}, {W}, {2 * C}] with {n_head} heads; got "
                         f"{tuple(kv.shape)}")
    return b, H, W, C, C // n_head


def _cuda_fwd(q, kv, bias, window, halo, n_head, scale, save: bool):
    """The forward kernel: out, and lse [b, n_head, H·W] when ``save``."""
    global LAUNCHES
    check_f32(q.device, q=q, kv=kv, bias=bias)
    b, H, W, _, D = _check_maps(q, kv, n_head)
    check_halo_geometry(H, W, n_head, D, window, halo)
    check_bias(bias, n_head, window, halo)
    from ._build import build

    lib = build()
    out = torch.empty_like(q)
    lse = torch.empty((b, n_head, H * W), device=q.device, dtype=torch.float32) \
        if save else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LAUNCHES += 1
        err = lib.vtx_halo_attention_direct_fwd(
            ptr(q), ptr(kv), ptr(bias), ptr(out), ptr(lse), b, H, W, n_head, D,
            window, halo, ctypes.c_float(scale), stream)
    _raise_on(err, "halo_attention_direct")
    return out, lse


def _cuda_bwd(saved: DirectSaved, do: torch.Tensor):
    """The backward kernel sequence: (dq, dkv, dbias)."""
    global BWD_LAUNCHES
    q, kv, bias, out, lse = saved[:5]
    do = do.contiguous()
    check_f32(q.device, do=do, out=out, lse=lse)
    if do.shape != q.shape:
        raise ValueError(f"do must be {tuple(q.shape)}, got {tuple(do.shape)}")
    b, H, W, C = q.shape
    nh, window, halo = saved.n_head, saved.window, saved.halo
    k = window + 2 * halo
    S = (H // window) * (W // window)
    chunks = dbias_chunks(b * S, nh, window, halo)
    from ._build import build

    lib = build()
    opts = dict(device=q.device, dtype=torch.float32)
    delta = torch.empty((b * nh * H * W,), **opts)
    dkvw = torch.empty((b * S * k * k * 2 * C,), **opts)
    part = torch.empty((chunks * nh * window * window * k * k,), **opts)
    dq, dkv = torch.empty_like(q), torch.empty_like(kv)
    dbias = torch.empty_like(bias)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        BWD_LAUNCHES += 1
        err = lib.vtx_halo_attention_direct_bwd(
            ptr(q), ptr(kv), ptr(bias), ptr(out), ptr(lse), ptr(do), ptr(delta),
            ptr(dkvw), ptr(part), chunks, ptr(dq), ptr(dkv), ptr(dbias), b, H, W, nh,
            C // nh, window, halo, ctypes.c_float(saved.scale), stream)
    _raise_on(err, "halo_attention_direct backward")
    return dq, dkv, dbias


def halo_attention_direct_fwd(q, kv, bias, window: int, halo: int, n_head: int,
                              scale: Optional[float] = None):
    """Training forward with saves: (out, :class:`DirectSaved`) — the kernel
    for a CUDA tensor, the plain version for a CPU one."""
    scale = _default_scale(q.shape[-1], n_head, scale)
    bias = bias.float().contiguous()
    if q.is_cuda:
        out, lse = _cuda_fwd(q, kv, bias, window, halo, n_head, scale, save=True)
    elif q.device.type == "cpu":
        C = q.shape[-1]
        out, lse = attention_fwd_reference(q, kv[..., :C], kv[..., C:], bias, n_head,
                                           window, halo, scale)
    else:
        raise NotImplementedError(f"no halo_attention_direct for device {q.device}")
    return out, DirectSaved(q, kv, bias, out, lse, window, halo, n_head, scale)


def halo_attention_direct_bwd(saved: DirectSaved, do: torch.Tensor):
    """Backward on the saves of :func:`halo_attention_direct_fwd`: (dq, dkv,
    dbias) — the kernels for a CUDA tensor, the plain version for a CPU one."""
    if do.is_cuda:
        return _cuda_bwd(saved, do)
    if do.device.type == "cpu":
        return halo_attention_direct_bwd_reference(saved, do)
    raise NotImplementedError(f"no halo_attention_direct backward for {do.device}")


class _HaloAttentionDirect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, bias, window, halo, n_head, scale):
        out, saved = halo_attention_direct_fwd(q, kv, bias, window, halo, n_head, scale)
        ctx.save_for_backward(*saved[:N_SAVED_TENSORS])
        ctx.attrs = saved[N_SAVED_TENSORS:]
        return out

    @staticmethod
    def backward(ctx, do):
        saved = DirectSaved(*ctx.saved_tensors, *ctx.attrs)
        return (*halo_attention_direct_bwd(saved, do), None, None, None, None)


def halo_attention_direct(q, kv, bias, window: int, halo: int, n_head: int,
                          scale: Optional[float] = None):
    """Halo windowed attention straight off the maps, differentiable in q,
    kv and bias: q [b, H, W, C], kv [b, H, W, 2C] (k lanes, then v lanes),
    bias [n_head, w², k²] → [b, H, W, C]."""
    scale = _default_scale(q.shape[-1], n_head, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, kv, bias)):
        return _HaloAttentionDirect.apply(q, kv, bias.float().contiguous(), window,
                                          halo, n_head, scale)
    if q.is_cuda:
        return _cuda_fwd(q, kv, bias.float().contiguous(), window, halo, n_head, scale,
                         save=False)[0]
    if q.device.type == "cpu":
        return halo_attention_direct_reference(q, kv, bias, window, halo, n_head, scale)
    raise NotImplementedError(f"no halo_attention_direct for device {q.device}")
