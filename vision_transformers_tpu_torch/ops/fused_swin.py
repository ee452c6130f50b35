"""Whole Swin layer on the feature map, forward and backward:

    o = roll(SwinLayer(roll(x, −s)), +s),   x, o [B, H, W, C]

with SwinLayer the pre-LN layer of :mod:`.fused_layer1` on window pairs,

    z = x + rs_attn ⊙ OutProj(MHSA(QkvProj(LN₁(x)) + extra))
    o = z + rs_ff   ⊙ (silu(LN₂(z)·W₁ + b₁)·W₂ + b₂),

s = w/2 on shifted layers and 0 on the others.  Counterpart of
``vision_transformers_tpu/ops/fused_swin.py::fused_swin_layer``, same
signature and semantics: a window-row band of the (rolled) map holds wspp =
W/(pack·w) pairs of ``pack`` windows; pair (b, g = wy·wspp + p) is m =
pack·w² tokens in the LAYOUT-NATIVE order ``t = r·(pack·w) + c`` (row r of
the band, column c across the pair's windows), not the partition order
(window, row, col) the model builds its bias slabs in — the caller permutes
the slabs once with :func:`swin_token_perm`.  ``extra`` is [G, H, m, m]
(G = hs·wspp, pair (b, g) takes group g: the shifted layers' shift mask)
or [1, H, m, m] (one slab for every pair: the unshifted layers);
``rs_attn`` / ``rs_ff`` are optional per-SAMPLE [B] DropPath scales, their
gradients summed over the sample's windows.  The per-pair arithmetic is
:mod:`.fused_layer1`'s; only where the rows come from differs.

A call that needs gradients goes through a ``torch.autograd.Function``
whose backward returns the gradient of every input the JAX rule does
(fused_swin.py:687-697): x, both LayerNorms, the four weights and their
biases, extra in the caller's [1 | G, H, m, m] form, and each row scale
([B]) when it is asked for.

A CPU tensor runs the plain torch versions: :func:`fused_swin_layer_reference`
(roll, the pairs in layout-native order as rows, :mod:`.fused_layer1`'s plain
math per pair, the rows put back, unroll), :func:`fused_swin_layer_fwd_reference`
and :func:`fused_swin_layer_bwd_reference`.  A CUDA tensor runs the
hand-written kernels of ``csrc/fused_swin.cu`` or raises; it never falls
back to the plain versions.  The kernels read and write the map in place
through a row → pixel table (:func:`map_rows`): no roll, partition,
unpartition or unroll pass runs around them.  They take float32,
``activation="silu"`` and heads up to 32 wide with the bias (Swin's are 32);
anything else on a CUDA tensor raises NotImplementedError (ROADMAP B).
Weights may be any 2-D strided view (the model passes ``linear.weight.t()``;
nothing is copied, and their gradients come back in the view's layout).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .fused_layer import (MAX_BIAS_DIM_HEAD, _default_scale, _raise_on, _splits,
                          check_attention_args, check_f32, check_matrix, check_vector,
                          like_layout, ptr)
from .fused_layer1 import (GRAD_NAMES, N_SAVED_TENSORS, L1Saved,
                           fused_transformer_layer_bwd_reference,
                           fused_transformer_layer_fwd_reference,
                           fused_transformer_layer_reference)

__all__ = ["fused_swin_layer", "fused_swin_layer_reference", "fused_swin_layer_fwd",
           "fused_swin_layer_bwd", "fused_swin_layer_fwd_reference",
           "fused_swin_layer_bwd_reference", "swin_token_perm", "map_rows", "SwinSaved",
           "GRAD_NAMES", "LAUNCHES", "BWD_LAUNCHES"]

# kernel launches through this module's wrappers, forward and backward
# (chip_smoke.py reads them to show the main path went through the kernels)
LAUNCHES = 0
BWD_LAUNCHES = 0


def swin_token_perm(window: int, pack: int) -> np.ndarray:
    """``perm[t_native] = t_partition``: maps this kernel's layout-native
    token order (row-major across the pair's columns) to the partition
    order (window, row, col) the packed bias/mask slabs are built in.
    Apply as ``slab[..., perm, :][..., :, perm]``."""
    w = window
    perm = np.empty(pack * w * w, np.int64)
    for r in range(w):
        for wi in range(pack):
            for c in range(w):
                perm[r * (pack * w) + wi * w + c] = wi * w * w + r * w + c
    return perm


class _Geometry(NamedTuple):
    B: int
    H: int
    W: int
    C: int
    window: int
    pack: int
    shift: bool
    G: int  # pairs per sample, hs·wspp
    m: int  # tokens per pair, pack·w²


def _geometry(x: torch.Tensor, extra: torch.Tensor, window: int, pack: int,
              shift: bool) -> _Geometry:
    if x.ndim != 4:
        raise ValueError(f"x must be a [B, H, W, C] map, got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if H % window or W % (pack * window):
        raise ValueError(f"a {H}x{W} map does not split into {window}x{window} windows "
                         f"in pairs of {pack}")
    G, m = (H // window) * (W // (pack * window)), pack * window * window
    if extra is None or extra.ndim != 4 or extra.shape[0] not in (1, G) \
            or tuple(extra.shape[2:]) != (m, m):
        raise ValueError(f"extra must be [1 or {G}, H, {m}, {m}], got "
                         f"{None if extra is None else tuple(extra.shape)}")
    return _Geometry(B, H, W, C, window, pack, bool(shift), G, m)


def _to_rows(x: torch.Tensor, geo: _Geometry) -> torch.Tensor:
    """[B, H, W, C] → [B, G, m, C]: roll by −w/2 when shifted, then the
    pairs of each window-row band in layout-native token order."""
    B, H, W, C, w, pack, shift, G, m = geo
    if shift:
        x = torch.roll(x, (-(w // 2), -(w // 2)), (1, 2))
    x = x.reshape(B, H // w, w, W // (pack * w), pack * w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, G, m, C)


def _from_rows(rows: torch.Tensor, geo: _Geometry) -> torch.Tensor:
    """The inverse of :func:`_to_rows` (and its adjoint: a permutation)."""
    B, H, W, C, w, pack, shift, G, m = geo
    x = rows.reshape(B, H // w, W // (pack * w), w, pack * w, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, H, W, C)
    if shift:
        x = torch.roll(x, (w // 2, w // 2), (1, 2))
    return x


@functools.lru_cache(maxsize=64)
def _map_rows_cached(H: int, W: int, window: int, pack: int, shift: bool,
                     device: str) -> torch.Tensor:
    pix = torch.arange(H * W, dtype=torch.int32).reshape(1, H, W, 1)
    geo = _Geometry(1, H, W, 1, window, pack, shift, (H // window) *
                    (W // (pack * window)), pack * window * window)
    return _to_rows(pix, geo).reshape(H * W).contiguous().to(device)


def map_rows(H: int, W: int, window: int, pack: int, shift: bool,
             device="cpu") -> torch.Tensor:
    """The kernels' map addressing: int32 [H·W], entry g·m + t the pixel
    (y·W + x) of the map that token t of pair g holds —
    ``((wy·w + r + s) mod H)·W + (p·pack·w + c + s) mod W`` for
    t = r·(pack·w) + c, g = wy·wspp + p.  Row b·H·W + i of the kernels'
    sample-major pair rows lives at pixel b·H·W + table[i]: the roll by −s
    on the way in, and the roll by +s on the way out lands on the same
    pixel."""
    return _map_rows_cached(H, W, window, pack, bool(shift), str(device))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _group_major(rows: torch.Tensor) -> torch.Tensor:
    """[B, G, m, C] → [G·B, m, C], :mod:`.fused_layer1`'s row order (row
    g·B + b in group g)."""
    B, G, m, C = rows.shape
    return rows.transpose(0, 1).reshape(G * B, m, C)


def _sample_major(rows: torch.Tensor, B: int) -> torch.Tensor:
    GB, m, C = rows.shape
    return rows.reshape(GB // B, B, m, C).transpose(0, 1)


def _tile(rs: Optional[torch.Tensor], G: int) -> Optional[torch.Tensor]:
    return None if rs is None else rs.repeat(G)


def fused_swin_layer_reference(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                               ln2_scale, ln2_bias, w1, b1, w2, b2, n_head: int,
                               extra, rs_attn=None, rs_ff=None,
                               activation: str = "silu", *, window: int, shift: bool,
                               pack: int = 1, scale: Optional[float] = None,
                               eps: float = 1e-6):
    """Plain torch version of :func:`fused_swin_layer` (forward): the pairs
    as rows, :func:`.fused_layer1.fused_transformer_layer_reference` on
    them (pair (b, g) with group g's bias and sample b's row scales), the
    rows put back."""
    geo = _geometry(x, extra, window, pack, shift)
    rows = _group_major(_to_rows(x, geo))
    out = fused_transformer_layer_reference(
        rows, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale, ln2_bias, w1, b1,
        w2, b2, n_head, extra, _tile(rs_attn, geo.G), _tile(rs_ff, geo.G), activation,
        scale, eps)
    return _from_rows(_sample_major(out, geo.B), geo)


class SwinSaved(NamedTuple):
    """What the backward reads: the whole layer's saves (:class:`.fused_layer1.
    L1Saved`) and the map geometry.  The kernels' saves hold the map x and
    the residuals on sample-major pair rows (qkv, acc, z, hid [B·H·W, ·],
    the statistics [B·H·W], lse [B·G, heads, m]) with rs_attn / rs_ff [B];
    the plain version's hold the group-major rows and the tiled scales."""

    layer: L1Saved
    geometry: _Geometry


def fused_swin_layer_fwd_reference(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                                   ln2_scale, ln2_bias, w1, b1, w2, b2, n_head: int,
                                   extra, rs_attn=None, rs_ff=None,
                                   activation: str = "silu", *, window: int,
                                   shift: bool, pack: int = 1,
                                   scale: Optional[float] = None, eps: float = 1e-6):
    """Plain torch training forward: (out, :class:`SwinSaved`)."""
    geo = _geometry(x, extra, window, pack, shift)
    rows = _group_major(_to_rows(x, geo))
    out, saved = fused_transformer_layer_fwd_reference(
        rows, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale, ln2_bias, w1, b1,
        w2, b2, n_head, extra, _tile(rs_attn, geo.G), _tile(rs_ff, geo.G), activation,
        scale, eps)
    return _from_rows(_sample_major(out, geo.B), geo), SwinSaved(saved, geo)


def _per_sample(drs: Optional[torch.Tensor], G: int) -> Optional[torch.Tensor]:
    """A tiled row scale's gradient [G·B] → [B], summed over the groups."""
    return None if drs is None else drs.reshape(G, -1).sum(0)


def fused_swin_layer_bwd_reference(saved: SwinSaved, do: torch.Tensor,
                                   need_drs=(True, True), need_dextra: bool = True):
    """Plain torch backward → the 16 gradients of ``GRAD_NAMES``: dx on the
    map, dextra in the caller's [1 | G, H, m, m] form, drs_attn / drs_ff
    [B] (None where not given or not asked for)."""
    geo = saved.geometry
    grads = list(fused_transformer_layer_bwd_reference(
        saved.layer, _group_major(_to_rows(do, geo)), need_drs, need_dextra))
    grads[0] = _from_rows(_sample_major(grads[0], geo.B), geo)
    grads[14] = _per_sample(grads[14], geo.G)
    grads[15] = _per_sample(grads[15], geo.G)
    return tuple(grads)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def _check(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale, ln2_bias,
           w1, b1, w2, b2, n_head, extra, rs_attn, rs_ff, activation, geo):
    """Shape/type checks of the CUDA ops; returns (heads, D, F)."""
    if activation != "silu":
        raise NotImplementedError(
            f"the CUDA kernel takes activation='silu', got {activation!r} (ROADMAP B)")
    check_f32(x.device, x=x, ln1_scale=ln1_scale, ln1_bias=ln1_bias, wqkv=wqkv,
              bqkv=bqkv, wout=wout, bout=bout, ln2_scale=ln2_scale,
              ln2_bias=ln2_bias, w1=w1, b1=b1, w2=w2, b2=b2, extra=extra,
              rs_attn=rs_attn, rs_ff=rs_ff)
    if not x.is_contiguous():
        raise ValueError(f"x must be a contiguous map, got strides {x.stride()}")
    B, H, W, C = x.shape
    _, _, _, H_, D = check_attention_args(x.view(B, H * W, C), ln1_scale, ln1_bias,
                                          wqkv, bqkv, wout, bout, n_head)
    if D > MAX_BIAS_DIM_HEAD:
        raise NotImplementedError(
            f"the CUDA kernel takes the bias with heads up to {MAX_BIAS_DIM_HEAD} wide; "
            f"got {D} (ROADMAP B)")
    if extra.shape[1] != H_ or not extra.is_contiguous():
        raise ValueError(f"extra must be a contiguous [1 or {geo.G}, {H_}, {geo.m}, "
                         f"{geo.m}] tensor, got {tuple(extra.shape)}")
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
    return H_, D, Fdim


def _cuda_fwd(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale, ln2_bias,
              w1, b1, w2, b2, n_head, extra, rs_attn, rs_ff, activation, scale, eps,
              geo: _Geometry, save: bool):
    """The forward kernels: out, plus (qkv, acc, z, hid, mu1, rstd1, lse,
    mu2, rstd2) when ``save``."""
    global LAUNCHES
    nh, D, Fdim = _check(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
                         ln2_bias, w1, b1, w2, b2, n_head, extra, rs_attn, rs_ff,
                         activation, geo)
    from ._build import build

    lib = build()
    B, H, W, C = x.shape
    M, HD, P = B * H * W, nh * D, B * geo.G
    pix = map_rows(H, W, geo.window, geo.pack, geo.shift, x.device)
    opts = dict(device=x.device, dtype=torch.float32)
    u = torch.empty((M, C), **opts)
    qkv = torch.empty((M, 3 * HD), **opts)
    acc = torch.empty((M, HD), **opts)
    z = torch.empty((M, C), **opts)
    hid = torch.empty((M, Fdim), **opts)
    af = torch.empty((M, Fdim), **opts) if save else None
    stats = [torch.empty((M,), **opts) for _ in range(2)] + \
        [torch.empty((P, nh, geo.m), **opts)] + \
        [torch.empty((M,), **opts) for _ in range(2)] if save else [None] * 5
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        LAUNCHES += 1
        err = lib.vtx_fused_swin_layer_fwd(
            ptr(x), ptr(ln1_scale), ptr(ln1_bias),
            ptr(wqkv), wqkv.stride(0), wqkv.stride(1), ptr(bqkv),
            ptr(wout), wout.stride(0), wout.stride(1), ptr(bout),
            ptr(ln2_scale), ptr(ln2_bias),
            ptr(w1), w1.stride(0), w1.stride(1), ptr(b1),
            ptr(w2), w2.stride(0), w2.stride(1), ptr(b2),
            ptr(extra), extra.shape[0], ptr(rs_attn), ptr(rs_ff), ptr(pix),
            ptr(u), ptr(qkv), ptr(acc), ptr(z), ptr(hid), ptr(af),
            *map(ptr, stats), ptr(out),
            B, H, W, C, nh, D, Fdim, geo.window, geo.pack,
            ctypes.c_float(scale), ctypes.c_float(eps), stream)
    _raise_on(err, "fused_swin_layer")
    return out, (qkv, acc, z, hid, *stats)


def _cuda_bwd(saved: SwinSaved, do: torch.Tensor, need_drs, need_dextra: bool):
    """The backward kernels: the 16 gradients of ``GRAD_NAMES``."""
    global BWD_LAUNCHES
    s, geo = saved
    x = s.x
    do = do.contiguous()
    check_f32(x.device, do=do, qkv=s.qkv, acc=s.acc, z=s.z, hid=s.hid, lse=s.lse)
    if do.shape != x.shape:
        raise ValueError(f"do must be {tuple(x.shape)}, got {tuple(do.shape)}")
    B, H, W, C = x.shape
    nh = s.n_head
    HD = s.wqkv.shape[1] // 3
    D = HD // nh
    Fdim = s.w1.shape[1]
    M = B * H * W
    from ._build import build

    lib = build()
    pix = map_rows(H, W, geo.window, geo.pack, geo.shift, x.device)
    opts = dict(device=x.device, dtype=torch.float32)
    splits = (_splits(HD, C, M), _splits(C, 3 * HD, M), _splits(C, Fdim, M),
              _splits(Fdim, C, M))
    wpart = max(splits[0] * HD * C, splits[1] * C * 3 * HD, splits[2] * C * Fdim,
                splits[3] * Fdim * C)
    chunks = -(-M // 128)  # csrc COLSUM_ROWS
    ws = dict(
        dor=torch.empty((M, C), **opts),
        da=torch.empty((M, C), **opts) if s.rs_attn is not None or s.rs_ff is not None
        else None,
        af=torch.empty((M, Fdim), **opts), dh=torch.empty((M, Fdim), **opts),
        dz=torch.empty((M, C), **opts), dacc=torch.empty((M, HD), **opts),
        delta=torch.empty((B * geo.G, nh, geo.m), **opts),
        dqkv=torch.empty((M, 3 * HD), **opts),
        u=torch.empty((M, C), **opts), dln=torch.empty((M, C), **opts),
        dsbuf=torch.empty((B * geo.G, nh, geo.m, geo.m), **opts) if need_dextra
        else None,
        wpart=torch.empty((wpart,), **opts),
        cpart=torch.empty((chunks * max(C, 3 * HD, Fdim),), **opts))
    vec = lambda n, t: torch.empty((n,), **opts) if t is not None else None  # noqa: E731
    dx = torch.empty_like(x)
    dg1, db1, dg2, db2 = (torch.empty((C,), **opts) for _ in range(4))
    dwqkv, dwout, dw1, dw2 = map(like_layout, (s.wqkv, s.wout, s.w1, s.w2))
    dbqkv, dbout = vec(3 * HD, s.bqkv), vec(C, s.bout)
    db1f, db2f = vec(Fdim, s.b1), vec(C, s.b2)
    dextra = torch.empty_like(s.extra_g) if need_dextra else None
    drs_attn = vec(B, s.rs_attn) if need_drs[0] else None
    drs_ff = vec(B, s.rs_ff) if need_drs[1] else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        BWD_LAUNCHES += 1
        err = lib.vtx_fused_swin_layer_bwd(
            ptr(x), ptr(s.ln1_scale), ptr(s.ln1_bias),
            ptr(s.wqkv), s.wqkv.stride(0), s.wqkv.stride(1), ptr(s.bqkv),
            ptr(s.wout), s.wout.stride(0), s.wout.stride(1), ptr(s.bout),
            ptr(s.ln2_scale), ptr(s.ln2_bias),
            ptr(s.w1), s.w1.stride(0), s.w1.stride(1), ptr(s.b1),
            ptr(s.w2), s.w2.stride(0), s.w2.stride(1), ptr(s.b2),
            ptr(s.extra_g), s.extra_g.shape[0], ptr(s.rs_attn), ptr(s.rs_ff), ptr(pix),
            *map(ptr, (s.qkv, s.acc, s.z, s.hid, s.mu1, s.rstd1, s.lse, s.mu2,
                       s.rstd2, do)),
            *(ptr(ws[k]) for k in ("dor", "da", "af", "dh", "dz", "dacc", "delta",
                                   "dqkv", "u", "dln", "dsbuf", "wpart")),
            *splits, ptr(ws["cpart"]),
            ptr(dx), ptr(dg1), ptr(db1),
            ptr(dwqkv), dwqkv.stride(0), dwqkv.stride(1), ptr(dbqkv),
            ptr(dwout), dwout.stride(0), dwout.stride(1), ptr(dbout),
            ptr(dg2), ptr(db2),
            ptr(dw1), dw1.stride(0), dw1.stride(1), ptr(db1f),
            ptr(dw2), dw2.stride(0), dw2.stride(1), ptr(db2f),
            ptr(dextra), ptr(drs_attn), ptr(drs_ff),
            B, H, W, C, nh, D, Fdim, geo.window, geo.pack, ctypes.c_float(s.scale),
            stream)
    _raise_on(err, "fused_swin_layer backward")
    return (dx, dg1, db1, dwqkv, dbqkv, dwout, dbout, dg2, db2, dw1, db1f, dw2,
            db2f, dextra, drs_attn, drs_ff)


def fused_swin_layer_fwd(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
                         ln2_bias, w1, b1, w2, b2, n_head: int, extra, rs_attn=None,
                         rs_ff=None, activation: str = "silu", *, window: int,
                         shift: bool, pack: int = 1, scale: Optional[float] = None,
                         eps: float = 1e-6):
    """Training forward with saves: (out, :class:`SwinSaved`) — the kernels
    for a CUDA tensor, the plain version for a CPU one."""
    scale = _default_scale(wqkv, n_head, scale)
    weights = (x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale, ln2_bias, w1,
               b1, w2, b2)
    if x.is_cuda:
        geo = _geometry(x, extra, window, pack, shift)
        out, res = _cuda_fwd(*weights, n_head, extra, rs_attn, rs_ff, activation, scale,
                             float(eps), geo, save=True)
        return out, SwinSaved(L1Saved(*weights, extra, rs_attn, rs_ff, *res, n_head,
                                      activation, scale, float(eps)), geo)
    if x.device.type == "cpu":
        return fused_swin_layer_fwd_reference(
            *weights, n_head, extra, rs_attn, rs_ff, activation, window=window,
            shift=shift, pack=pack, scale=scale, eps=eps)
    raise NotImplementedError(f"no fused_swin_layer for device {x.device}")


def fused_swin_layer_bwd(saved: SwinSaved, do: torch.Tensor, need_drs=(True, True),
                         need_dextra: bool = True):
    """Backward on the saves of :func:`fused_swin_layer_fwd` — the kernels
    for a CUDA tensor, the plain version for a CPU one."""
    if do.is_cuda:
        return _cuda_bwd(saved, do, need_drs, need_dextra)
    if do.device.type == "cpu":
        return fused_swin_layer_bwd_reference(saved, do, need_drs, need_dextra)
    raise NotImplementedError(f"no fused_swin_layer backward for {do.device}")


class _FusedSwinLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
                ln2_bias, w1, b1, w2, b2, extra, rs_attn, rs_ff, n_head, activation,
                scale, eps, window, shift, pack):
        out, saved = fused_swin_layer_fwd(
            x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale, ln2_bias, w1, b1,
            w2, b2, n_head, extra, rs_attn, rs_ff, activation, window=window,
            shift=shift, pack=pack, scale=scale, eps=eps)
        ctx.save_for_backward(*saved.layer[:N_SAVED_TENSORS])
        ctx.attrs = saved.layer[N_SAVED_TENSORS:]
        ctx.geometry = saved.geometry
        return out

    @staticmethod
    def backward(ctx, do):
        saved = SwinSaved(L1Saved(*ctx.saved_tensors, *ctx.attrs), ctx.geometry)
        need = ctx.needs_input_grad
        grads = fused_swin_layer_bwd(saved, do, (need[14], need[15]), need[13])
        return (*grads, None, None, None, None, None, None, None)


def fused_swin_layer(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
                     ln2_bias, w1, b1, w2, b2, n_head: int, extra, rs_attn=None,
                     rs_ff=None, activation: str = "silu", *, window: int, shift: bool,
                     pack: int = 1, scale: Optional[float] = None, eps: float = 1e-6):
    """Whole Swin layer on the map [B, H, W, C], differentiable (see the
    module docstring)."""
    scale = _default_scale(wqkv, n_head, scale)
    tensors = (x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale, ln2_bias, w1,
               b1, w2, b2, extra, rs_attn, rs_ff)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return _FusedSwinLayer.apply(*tensors, n_head, activation, scale, float(eps),
                                     window, bool(shift), pack)
    if x.is_cuda:
        geo = _geometry(x, extra, window, pack, shift)
        return _cuda_fwd(*tensors[:13], n_head, extra, rs_attn, rs_ff, activation, scale,
                         float(eps), geo, save=False)[0]
    if x.device.type == "cpu":
        return fused_swin_layer_reference(*tensors[:13], n_head, extra, rs_attn, rs_ff,
                                          activation, window=window, shift=shift,
                                          pack=pack, scale=scale, eps=eps)
    raise NotImplementedError(f"no fused_swin_layer for device {x.device}")
