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
back to the plain versions: two tensor-core kernels (3xTF32) of
``csrc/halo_attention_tc.cuh``, a block per head and chunk of windows with
the head's bias resident, one pass per window each way.  The kernels take
heads up to ``MAX_DIM_HEAD`` wide, windows of up to ``MAX_QUERIES`` tokens
and 2·halo ≤ window (each token lies in at most 2 x 2 neighbourhoods); at
bfloat16 (q and kv bf16, the bias f32) the core's bf16 form, heads up to
``BF16_MAX_DIM_HEAD`` wide and up to ``BF16_MAX_KEYS`` keys a window, the
plain versions at the JAX kernels' rounding (P normalized and rounded
before P·V, the backward's products in f32 on the bf16 inputs, dq and the
folded dkv rounded once); anything else on a CUDA tensor raises
NotImplementedError.

The module also holds the JAX module's gathered form, :func:`halo_attention`
(``fused_halo.py::halo_attention``, :145): the same softmax on the
neighbourhoods as the model gathers them, q [B', M, C] (a window's M
queries) against kv [B', N, 2C] (its N neighbourhood positions, zero rows
outside the map), bias [n_head, M, N] → [B', M, C], with any halo: Halo's
path where 2·halo > window.  The gather and its adjoint (the fold of dkv
back onto the map) stay torch data movement outside it, as in the JAX
package.  Its forward keeps lse [B', n_head, M]; its backward returns dq,
dkv [B', N, 2C] and dbias summed over the B' windows.  A CPU tensor runs
:func:`gathered_fwd_reference` / :func:`gathered_bwd_reference`; a CUDA
tensor runs the same two kernels as the direct op, in their gathered
addressing, heads up to ``MAX_DIM_HEAD`` wide, windows of up to
``MAX_QUERIES`` queries and any N (past one resident tile the keys
stream; the bf16 form: one tile, each window's dkv rounded), or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .fused_attention import attention_bwd_reference as sra_bwd_reference
from .fused_attention import attention_fwd_reference as sra_fwd_reference
from .fused_layer import _raise_on, _rb, check_bf16_form, check_f32, ptr

__all__ = ["halo_attention_direct", "halo_attention_direct_reference",
           "halo_attention_direct_fwd", "halo_attention_direct_bwd",
           "attention_fwd_reference", "attention_bwd_reference", "neighborhoods",
           "fold_neighborhoods", "windows", "unwindows", "DirectSaved", "LAUNCHES",
           "BWD_LAUNCHES", "halo_attention", "halo_attention_reference",
           "halo_attention_fwd", "halo_attention_bwd", "gathered_fwd_reference",
           "gathered_bwd_reference", "GatherSaved", "HALO_GATHER_LAUNCHES",
           "HALO_GATHER_BWD_LAUNCHES", "BF16_LAUNCHES", "BF16_BWD_LAUNCHES",
           "HALO_GATHER_BF16_LAUNCHES", "HALO_GATHER_BF16_BWD_LAUNCHES"]

# kernel launches through this module's wrappers, forward and backward
# (chip_smoke.py reads them to show the main path went through the kernels):
# the direct op's and the gathered op's
LAUNCHES = 0
BWD_LAUNCHES = 0
HALO_GATHER_LAUNCHES = 0
HALO_GATHER_BWD_LAUNCHES = 0
# ... and of those, the launches of the core's bf16 form
BF16_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0
HALO_GATHER_BF16_LAUNCHES = 0
HALO_GATHER_BF16_BWD_LAUNCHES = 0

MAX_DIM_HEAD = 64  # csrc halo_attention_tc.cuh: heads 32 or 64 wide in shared memory
MAX_QUERIES = 64   # four 16-row query slices of a window
# the core's bf16 form (csrc halo_attention_tc.cuh, E = BF16): heads up to 32
# wide and a window's keys in one tile, so the forward normalizes P before it
# rounds and the backward sums Δ = Σ p·dP over the window's keys
BF16_MAX_DIM_HEAD = 32
BF16_MAX_KEYS = 144

# backward blocks to aim the chunking at: two waves of 132 SMs x the one
# block (up to 8 warps, ~185 KB of shared memory) an SM holds
_BWD_BLOCKS = 2 * 132


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
    (out [b, H, W, HD] in q's dtype, lse [b, n_head, H·W] f32).  bf16: P
    normalized, then rounded before P·V (fused_halo.py:62, :272;
    fused_halo_layer.py:136)."""
    _, H, W, _ = q.shape
    _, _, s = _scores(q, k, bias, n_head, window, halo, scale)
    vn = _split_heads(neighborhoods(v, window, halo), n_head)
    o = torch.einsum("bshqk,bshkd->bshqd", _rb(torch.softmax(s, dim=-1), v.dtype), vn)
    out = unwindows(_merge_heads(o), window, H, W).to(q.dtype)
    return out, _lse_tokens(torch.logsumexp(s, dim=-1), window, H, W)


def attention_bwd_reference(q, k, v, bias, out, lse, do, n_head: int, window: int,
                            halo: int, scale: float, round_products: bool = False):
    """The plain backward in the kernels' steps, f32: Δ = rowsum(do ⊙ out),
    p from the saved lse, dv = pᵀ·do, dS = p ⊙ (do·vᵀ − Δ), dq = dS·k·s,
    dk = dSᵀ·q·s, dbias = Σ over images and windows of dS, and dk / dv
    folded back onto the map: → (dq, dk, dv [b, H, W, HD], dbias
    [n_head, w², k²]), f32.  With bf16 inputs Δ = Σ_j p·dP (the JAX
    kernels' form, fused_halo.py:105, :324, fused_halo_layer.py:345; at
    f32 the same sum), and with ``round_products`` (the whole layer's
    backward, fused_halo_layer.py:337-356) P and dS·s rounded before their
    products and each window's dq, dk, dv rounded before the fold; without
    it (the attention alone, fused_halo.py:72-118, :282-338) the products
    are f32 on the bf16 inputs.  The fold sums in f32 and the caller rounds
    once (where the JAX kernels fold a band's windows in f32 and the bands
    in bf16, fused_halo.py:338-356, fused_halo_layer.py:361-405)."""
    _, H, W, _ = q.shape
    dt = q.dtype
    qw, kn, s = _scores(q, k, bias, n_head, window, halo, scale)
    vn = _split_heads(neighborhoods(v, window, halo), n_head)
    dow = _split_heads(windows(do, window), n_head)
    p = torch.exp(s - _lse_windows(lse.float(), window, H, W)[..., None])
    dp = torch.einsum("bshqd,bshkd->bshqk", dow, vn)
    if dt == torch.float32:
        delta = (dow * _split_heads(windows(out, window), n_head)).sum(-1, keepdim=True)
    else:
        delta = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if round_products:
        dsb = _rb(ds * scale, dt)
        dvn = _rb(torch.einsum("bshqk,bshqd->bshkd", _rb(p, dt), dow), dt)
        dq = _rb(torch.einsum("bshqk,bshkd->bshqd", dsb, kn), dt)
        dkn = _rb(torch.einsum("bshqk,bshqd->bshkd", dsb, qw), dt)
    else:
        dvn = torch.einsum("bshqk,bshqd->bshkd", p, dow)
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
            f"the map-resident halo kernels need 2·halo ≤ window (got window {window}, "
            f"halo {halo}); a wider halo takes the gathered halo_attention")
    if window * window > MAX_QUERIES or D > MAX_DIM_HEAD:
        raise NotImplementedError(
            f"the CUDA halo kernels take windows of up to {MAX_QUERIES} tokens and heads "
            f"up to {MAX_DIM_HEAD} wide; got window {window}, head width {D}")


def check_bf16_halo(D: int, n_keys: int) -> None:
    """Raise for a head width or key count the core's bf16 form does not
    take."""
    if D > BF16_MAX_DIM_HEAD or n_keys > BF16_MAX_KEYS:
        raise NotImplementedError(
            f"the bf16 halo attention takes heads up to {BF16_MAX_DIM_HEAD} wide and up to "
            f"{BF16_MAX_KEYS} keys a window (one key tile); got head width {D}, {n_keys} "
            f"keys (ROADMAP.md B.2)")


def check_bias(bias: torch.Tensor, n_head: int, window: int, halo: int) -> None:
    k = window + 2 * halo
    want = (n_head, window * window, k * k)
    if tuple(bias.shape) != want or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous {list(want)} tensor, got shape "
                         f"{tuple(bias.shape)} strides {bias.stride()}")


def dbias_chunks(pairs: int, n_head: int, window: int, halo: int, dim_head: int) -> int:
    """Chunks of the B·S (image, window) pairs for the backward: one dbias
    partial [n_head, w², k²] each, summed in order afterwards."""
    return _chunks(pairs, n_head, (window + 2 * halo) ** 2, dim_head)


def key_tiles(n_keys: int, dim_head: int) -> int:
    """The backward's key tiles of a window (csrc hta::bwd_key_tile: 144 keys
    at heads up to 32 wide, 72 at 64); past one, dq comes as a partial per
    tile, summed in order."""
    return -(-n_keys // (144 if dim_head <= 32 else 72))


def _chunks(pairs: int, n_head: int, n_keys: int, dim_head: int) -> int:
    """Backward chunks of ``pairs`` windows of ``n_keys`` keys each: a block
    per (chunk, head, key tile)."""
    return max(1, min(pairs, 65535, _BWD_BLOCKS // (key_tiles(n_keys, dim_head) * n_head)))


def dq_partials(n_keys: int, rows: int, dim_head: int, n_head: int, **opts):
    """The dq partials' workspace [key tiles·rows·HD], or None with one key
    tile."""
    kt = key_tiles(n_keys, dim_head)
    return torch.empty((kt * rows * n_head * dim_head,), **opts) if kt > 1 else None


def _check_maps(q, kv, n_head):
    if q.ndim != 4 or not q.is_contiguous() or not kv.is_contiguous():
        raise ValueError("q and kv must be contiguous [b, H, W, C] / [b, H, W, 2C] maps")
    b, H, W, C = q.shape
    if tuple(kv.shape) != (b, H, W, 2 * C) or C % n_head:
        raise ValueError(f"kv must be [{b}, {H}, {W}, {2 * C}] with {n_head} heads; got "
                         f"{tuple(kv.shape)}")
    return b, H, W, C, C // n_head


def _check_direct(q, kv, bias, n_head, window, halo, **acts):
    """The direct op's checks (``acts``: the backward's activations, in q's
    dtype); returns (b, H, W, D, bf16) with bf16 whether the call takes the
    core's bf16 form."""
    b, H, W, _, D = _check_maps(q, kv, n_head)
    bf16 = check_bf16_form(q, D, dict(bias=bias), kv=kv, **acts)
    check_halo_geometry(H, W, n_head, D, window, halo)
    if bf16:
        check_bf16_halo(D, (window + 2 * halo) ** 2)
    check_bias(bias, n_head, window, halo)
    return b, H, W, D, bf16


def _cuda_fwd(q, kv, bias, window, halo, n_head, scale, save: bool):
    """The forward kernel: out, and lse [b, n_head, H·W] when ``save``."""
    global LAUNCHES, BF16_LAUNCHES
    b, H, W, D, bf16 = _check_direct(q, kv, bias, n_head, window, halo)
    from ._build import build

    lib = build()
    out = torch.empty_like(q)
    lse = torch.empty((b, n_head, H * W), device=q.device, dtype=torch.float32) \
        if save else None
    entry = lib.vtx_halo_attention_direct_fwd_bf16 if bf16 \
        else lib.vtx_halo_attention_direct_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LAUNCHES += 1
        BF16_LAUNCHES += bf16
        err = entry(
            ptr(q), ptr(kv), ptr(bias), ptr(out), ptr(lse), b, H, W, n_head, D,
            window, halo, ctypes.c_float(scale), stream)
    _raise_on(err, "halo_attention_direct")
    return out, lse


def _cuda_bwd(saved: DirectSaved, do: torch.Tensor):
    """The backward kernel sequence: (dq, dkv, dbias)."""
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES
    q, kv, bias, out, lse = saved[:5]
    do = do.contiguous()
    nh, window, halo = saved.n_head, saved.window, saved.halo
    b, H, W, D, bf16 = _check_direct(q, kv, bias, nh, window, halo, do=do, out=out)
    check_f32(q.device, lse=lse)
    if do.shape != q.shape:
        raise ValueError(f"do must be {tuple(q.shape)}, got {tuple(do.shape)}")
    C, k = q.shape[-1], window + 2 * halo
    S = (H // window) * (W // window)
    chunks = dbias_chunks(b * S, nh, window, halo, D)
    from ._build import build

    lib = build()
    opts = dict(device=q.device, dtype=torch.float32)
    dkvw = torch.empty((b * S * k * k * 2 * C,), **opts)
    part = torch.empty((chunks * nh * window * window * k * k,), **opts)
    dq_part = dq_partials(k * k, b * H * W, D, nh, **opts)
    dq, dkv = torch.empty_like(q), torch.empty_like(kv)
    dbias = torch.empty_like(bias)
    entry = lib.vtx_halo_attention_direct_bwd_bf16 if bf16 \
        else lib.vtx_halo_attention_direct_bwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        BWD_LAUNCHES += 1
        BF16_BWD_LAUNCHES += bf16
        err = entry(
            ptr(q), ptr(kv), ptr(bias), ptr(out), ptr(lse), ptr(do), ptr(dkvw),
            ptr(part), chunks, ptr(dq_part), ptr(dq), ptr(dkv), ptr(dbias), b, H, W, nh,
            D, window, halo, ctypes.c_float(saved.scale), stream)
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


# ---------------------------------------------------------------------------
# the gathered form: halo_attention (B5b)
# ---------------------------------------------------------------------------


def _gathered_heads(q, kv, n_head):
    """q [B', M, C], kv [B', N, 2C] → q, k, v as [B', heads, rows, D] views."""
    C = q.shape[-1]
    return (_heads(t, n_head) for t in (q, kv[..., :C], kv[..., C:]))


def _heads(t, n_head):
    return t.unflatten(-1, (n_head, -1)).transpose(1, 2)


def _rows(t):
    """[B', heads, rows, D] → [B', rows, heads·D]."""
    return t.transpose(1, 2).flatten(-2)


def gathered_fwd_reference(q, kv, bias, n_head: int, scale: float):
    """softmax(q·kᵀ·scale + bias)·v per head, f32 — the reduced-kv
    attention's plain forward (``fused_attention.attention_fwd_reference``,
    the cast points of the JAX kernels) on the heads: → (out [B', M, C] in
    q's dtype, lse [B', n_head, M] f32)."""
    out, lse = sra_fwd_reference(*_gathered_heads(q, kv, n_head), bias, scale)
    return _rows(out), lse


def gathered_bwd_reference(q, kv, bias, lse, do, n_head: int, scale: float):
    """The plain backward, f32, the reduced-kv attention's on the heads (p
    from the saved lse, dv = pᵀ·do, dS = p ⊙ (dp − Σ dp ⊙ p), dq = dS·k·s,
    dk = dSᵀ·q·s, dbias = Σ over the windows of dS): → (dq [B', M, C], dkv
    [B', N, 2C], dbias [n_head, M, N])."""
    dq, dk, dv, dbias = sra_bwd_reference(*_gathered_heads(q, kv, n_head), bias, lse,
                                          _heads(do, n_head), scale)
    return (_rows(dq).to(q.dtype), torch.cat([_rows(dk), _rows(dv)], -1).to(kv.dtype),
            dbias.to(bias.dtype))


def halo_attention_reference(q, kv, bias, n_head: int, scale: Optional[float] = None):
    """Plain torch version of :func:`halo_attention` (forward)."""
    scale = _default_scale(q.shape[-1], n_head, scale)
    return gathered_fwd_reference(q, kv, bias, n_head, scale)[0]


class GatherSaved(NamedTuple):
    """What the gathered backward reads: q, kv, bias (contiguous f32), the
    output and lse [B', n_head, M]."""

    q: torch.Tensor
    kv: torch.Tensor
    bias: torch.Tensor
    out: torch.Tensor
    lse: torch.Tensor
    n_head: int
    scale: float


def _check_gathered(q, kv, bias, n_head, **acts):
    """Shapes, layouts and limits the gathered kernels take (``acts``: the
    backward's activations, in q's dtype); returns (B', M, N, D, bf16) with
    bf16 whether the call takes the core's bf16 form."""
    if q.ndim != 3 or kv.ndim != 3 or not q.is_contiguous() or not kv.is_contiguous():
        raise ValueError("q and kv must be contiguous [B', M, C] / [B', N, 2C] tensors")
    B, M, C = q.shape
    N = kv.shape[1]
    if kv.shape[0] != B or kv.shape[2] != 2 * C or C % n_head or min(B, M, N) < 1:
        raise ValueError(f"kv must be [{B}, N, {2 * C}] with {n_head} heads dividing "
                         f"{C}; got q {tuple(q.shape)}, kv {tuple(kv.shape)}")
    D = C // n_head
    bf16 = check_bf16_form(q, D, dict(bias=bias), kv=kv, **acts)
    if tuple(bias.shape) != (n_head, M, N) or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous [{n_head}, {M}, {N}] tensor, got "
                         f"shape {tuple(bias.shape)} strides {bias.stride()}")
    if M > MAX_QUERIES or D > MAX_DIM_HEAD:
        raise NotImplementedError(
            f"the CUDA halo_attention takes windows of up to {MAX_QUERIES} queries and "
            f"heads up to {MAX_DIM_HEAD} wide; got {M} queries, head width {D} "
            f"(ROADMAP B)")
    if bf16:
        check_bf16_halo(D, N)
    return B, M, N, D, bf16


def _cuda_gathered_fwd(q, kv, bias, n_head, scale, save: bool):
    """The gathered forward kernel: out, and lse [B', n_head, M] when
    ``save``."""
    global HALO_GATHER_LAUNCHES, HALO_GATHER_BF16_LAUNCHES
    B, M, N, D, bf16 = _check_gathered(q, kv, bias, n_head)
    from ._build import build

    lib = build()
    out = torch.empty_like(q)
    lse = torch.empty((B, n_head, M), device=q.device, dtype=torch.float32) \
        if save else None
    entry = lib.vtx_halo_attention_fwd_bf16 if bf16 else lib.vtx_halo_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        HALO_GATHER_LAUNCHES += 1
        HALO_GATHER_BF16_LAUNCHES += bf16
        err = entry(ptr(q), ptr(kv), ptr(bias), ptr(out), ptr(lse), B, M, N, n_head, D,
                    ctypes.c_float(scale), stream)
    _raise_on(err, "halo_attention")
    return out, lse


def _cuda_gathered_bwd(saved: GatherSaved, do: torch.Tensor):
    """The gathered backward kernel sequence: (dq, dkv, dbias), dq and dkv
    written in place in q's and kv's layouts."""
    global HALO_GATHER_BWD_LAUNCHES, HALO_GATHER_BF16_BWD_LAUNCHES
    q, kv, bias, out, lse = saved[:5]
    do = do.contiguous()
    B, M, N, D, bf16 = _check_gathered(q, kv, bias, saved.n_head, do=do, out=out)
    check_f32(q.device, lse=lse)
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"do and out must be {tuple(q.shape)}, got {tuple(do.shape)}, "
                         f"{tuple(out.shape)}")
    nh = saved.n_head
    chunks = _chunks(B, nh, N, D)
    from ._build import build

    lib = build()
    opts = dict(device=q.device, dtype=torch.float32)
    part = torch.empty((chunks * nh * M * N,), **opts)
    dq_part = dq_partials(N, B * M, D, nh, **opts)
    dq, dkv, dbias = torch.empty_like(q), torch.empty_like(kv), torch.empty_like(bias)
    entry = lib.vtx_halo_attention_bwd_bf16 if bf16 else lib.vtx_halo_attention_bwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        HALO_GATHER_BWD_LAUNCHES += 1
        HALO_GATHER_BF16_BWD_LAUNCHES += bf16
        err = entry(
            ptr(q), ptr(kv), ptr(bias), ptr(out), ptr(lse), ptr(do), ptr(part), chunks,
            ptr(dq_part), ptr(dq), ptr(dkv), ptr(dbias), B, M, N, nh, D,
            ctypes.c_float(saved.scale), stream)
    _raise_on(err, "halo_attention backward")
    return dq, dkv, dbias


def halo_attention_fwd(q, kv, bias, n_head: int, scale: Optional[float] = None):
    """Training forward with saves: (out, :class:`GatherSaved`) — the kernel
    for a CUDA tensor, the plain version for a CPU one."""
    scale = _default_scale(q.shape[-1], n_head, scale)
    bias = bias.float().contiguous()
    if q.is_cuda:
        out, lse = _cuda_gathered_fwd(q, kv, bias, n_head, scale, save=True)
    elif q.device.type == "cpu":
        out, lse = gathered_fwd_reference(q, kv, bias, n_head, scale)
    else:
        raise NotImplementedError(f"no halo_attention for device {q.device}")
    return out, GatherSaved(q, kv, bias, out, lse, n_head, scale)


def halo_attention_bwd(saved: GatherSaved, do: torch.Tensor):
    """Backward on the saves of :func:`halo_attention_fwd`: (dq, dkv, dbias)
    — the kernels for a CUDA tensor, the plain version for a CPU one."""
    if do.is_cuda:
        return _cuda_gathered_bwd(saved, do)
    if do.device.type == "cpu":
        return gathered_bwd_reference(saved.q, saved.kv, saved.bias, saved.lse, do,
                                      saved.n_head, saved.scale)
    raise NotImplementedError(f"no halo_attention backward for {do.device}")


class _HaloAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, bias, n_head, scale):
        out, saved = halo_attention_fwd(q, kv, bias, n_head, scale)
        ctx.save_for_backward(*saved[:5])
        ctx.attrs = saved[5:]
        return out

    @staticmethod
    def backward(ctx, do):
        saved = GatherSaved(*ctx.saved_tensors, *ctx.attrs)
        return (*halo_attention_bwd(saved, do), None, None)


def halo_attention(q, kv, bias, n_head: int, scale: Optional[float] = None):
    """Halo attention on gathered neighbourhoods, differentiable in q, kv and
    bias: q [B', M, C] (a window's queries, heads on lanes h·D), kv
    [B', N, 2C] (its neighbourhood, k lanes then v lanes), bias
    [n_head, M, N] → [B', M, C]."""
    scale = _default_scale(q.shape[-1], n_head, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, kv, bias)):
        return _HaloAttention.apply(q, kv, bias.float().contiguous(), n_head, scale)
    if q.is_cuda:
        return _cuda_gathered_fwd(q, kv, bias.float().contiguous(), n_head, scale,
                                  save=False)[0]
    if q.device.type == "cpu":
        return halo_attention_reference(q, kv, bias, n_head, scale)
    raise NotImplementedError(f"no halo_attention for device {q.device}")
