"""Fused pre-LN attention residual branch, forward and backward:

    z = x + r ⊙ OutProj(MHSA(QkvProj(LN(x))))

Counterpart of ``vision_transformers_tpu/ops/fused_layer.py::
fused_attention_layer``, same signature and weight semantics: x [B, N, C],
ln_scale/ln_bias [C], wqkv [C, 3·H·D] laid out q-heads | k-heads | v-heads,
wout [H·D, C], extra optional additive attention bias in the JAX op's
three forms (``ops/fused_block.py:233-243``): [N, N] or [H, N, N] shared by
every row, or grouped [G, H, N, N] with B % G == 0, row b taking group
b // (B/G) — Swin's window groups —, row_scale optional [B] per-sample
DropPath scale.

A call that needs gradients goes through a ``torch.autograd.Function``
whose forward keeps the residuals the backward reads — qkv, the attention
output acc, the LN statistics mu / rstd and the softmax log-sum-exp lse —
as the JAX ``custom_vjp`` does (fused_layer.py:422-427,493-499,569-674).
A call that needs none (``torch.no_grad()``, the serving path) saves
nothing.

A CPU tensor runs the plain torch versions: the forward
:func:`fused_attention_layer_reference` (the cast points of the JAX
package's ``_attn_layer_ref``, fused_layer.py:502-542: LN statistics f32,
dots f32-accumulated, softmax f32) and the backward
:func:`fused_attention_layer_bwd_reference`.  A CUDA tensor runs the
hand-written kernels in ``csrc/fused_layer.cu`` (forward) and
``csrc/fused_layer_bwd.cu`` (backward) or raises; it never falls back to
the plain versions.  The kernels take float32 and ``extra=None`` (the bias
rides in the whole-layer kernel, :mod:`.fused_layer1`, which Swin takes;
this op's backward takes it with the DINO slice); anything else on a CUDA
tensor raises NotImplementedError.  The weights may
be any 2-D strided view: the model passes ``linear.weight.t()``, and the
wrapper hands those strides to the kernels instead of copying the weights;
their gradients come back in the view's shape and layout.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

__all__ = ["fused_attention_layer", "fused_attention_layer_reference",
           "fused_attention_layer_bwd_reference", "AttnSaved", "LAUNCHES",
           "BWD_LAUNCHES"]

# kernel launches through this module's wrappers, forward and backward
# (chip_smoke.py reads them to show the main path went through the kernels)
LAUNCHES = 0
BWD_LAUNCHES = 0

# largest head width the attention kernels hold in registers (csrc DMAX)
MAX_DIM_HEAD = 64


def _ln_stats(xf: torch.Tensor, eps: float):
    """f32 LayerNorm statistics in the fast-variance form: (mu, rstd)."""
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return mu, torch.rsqrt(var + eps)


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics in the fast-variance form."""
    xf = x.float()
    mu, rstd = _ln_stats(xf, eps)
    return ((xf - mu) * rstd * g.float() + b.float()).to(x.dtype)


def _dot(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[..., K] · [K, N], accumulated in f32, cast to the compute dtype."""
    return torch.matmul(a.float(), w.float()).to(dtype)


def _heads(t: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, N, H·D] → [B, H, N, D] (f32)."""
    B, N, HD = t.shape
    return t.reshape(B, N, n_head, HD // n_head).permute(0, 2, 1, 3).float()


def extra_groups(extra: Optional[torch.Tensor], B: int, n_head: int, N: int):
    """The JAX ``_extra_form``: (extra as contiguous f32 [G, H, N, N] or
    None, G).  [N, N] and [H, N, N] broadcast to one group."""
    if extra is None:
        return None, 1
    if extra.ndim == 4:
        G = extra.shape[0]
        if B % G:
            raise ValueError(f"batch {B} not divisible by extra groups {G}")
        return extra.float().contiguous(), G
    return extra.float().expand(n_head, N, N)[None].contiguous(), 1


def extra_grad(dextra_g: Optional[torch.Tensor], extra: Optional[torch.Tensor]):
    """The gradient of the grouped bias [G, H, N, N] in the caller's form of
    ``extra`` (fused_layer1.py:677-687): summed over what was broadcast."""
    if extra is None or dextra_g is None:
        return None
    d = dextra_g
    if extra.ndim < 4:
        d = d[0]
        if extra.ndim == 2:
            d = d.sum(0)
        elif extra.shape[0] == 1 and d.shape[0] != 1:
            d = d.sum(0, keepdim=True)
    return d.to(extra.dtype)


def _scores_bias(s: torch.Tensor, extra_g: Optional[torch.Tensor]) -> torch.Tensor:
    """s [B, H, N, N] + the grouped bias of each row's group."""
    if extra_g is None:
        return s
    B = s.shape[0]
    G = extra_g.shape[0]
    return (s.reshape(G, B // G, *s.shape[1:]) + extra_g[:, None]).reshape(s.shape)


def attention_branch_reference(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                               n_head, extra, scale, eps):
    """OutProj(MHSA(QkvProj(LN(x)) + extra)) — the branch without the
    residual; ``extra`` in any of the three forms."""
    B, N, C = x.shape
    HD = wqkv.shape[1] // 3
    D = HD // n_head
    u = _ln(x, ln_scale, ln_bias, eps)
    qkv = _dot(u, wqkv, x.dtype)
    if bqkv is not None:
        qkv = qkv + bqkv
    q, k, v = (qkv[..., i * HD:(i + 1) * HD].reshape(B, N, n_head, D).float()
               for i in range(3))
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    if extra is not None:
        if extra.ndim == 4:
            s = _scores_bias(s, extra_groups(extra, B, n_head, N)[0])
        else:
            s = s + extra.float()
    p = torch.softmax(s, dim=-1).to(x.dtype)
    acc = torch.einsum("bhnm,bmhd->bnhd", p.float(), v).to(x.dtype).reshape(B, N, HD)
    a = _dot(acc, wout, x.dtype)
    if bout is not None:
        a = a + bout
    return a


def _residual(x, a, rs):
    """x + rs ⊙ a, rs [B] per sample (the leading dim) or None."""
    if rs is not None:
        a = a * rs.reshape(-1, *([1] * (a.ndim - 1))).to(a.dtype)
    return x + a


def _default_scale(wqkv, n_head, scale):
    return 1.0 / math.sqrt(wqkv.shape[1] // 3 // n_head) if scale is None else float(scale)


def fused_attention_layer_reference(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                                    n_head: int, extra=None, row_scale=None,
                                    scale: Optional[float] = None, eps: float = 1e-6):
    """Plain torch version of :func:`fused_attention_layer` (forward)."""
    scale = _default_scale(wqkv, n_head, scale)
    a = attention_branch_reference(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                                   n_head, extra, scale, eps)
    return _residual(x, a, row_scale)


# ---------------------------------------------------------------------------
# training forward (saves) and backward, plain versions
# ---------------------------------------------------------------------------


class AttnSaved(NamedTuple):
    """What the backward reads: the forward's inputs and residuals.
    qkv [B, N, 3HD], acc [B, N, HD], mu / rstd [B, N], lse [B, H, N]."""

    x: torch.Tensor
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    wqkv: torch.Tensor
    bqkv: Optional[torch.Tensor]
    wout: torch.Tensor
    bout: Optional[torch.Tensor]
    row_scale: Optional[torch.Tensor]
    qkv: torch.Tensor
    acc: torch.Tensor
    mu: torch.Tensor
    rstd: torch.Tensor
    lse: torch.Tensor
    n_head: int
    scale: float
    eps: float


def fused_attention_layer_fwd_reference(x, ln_scale, ln_bias, wqkv, bqkv, wout,
                                        bout, n_head: int, row_scale=None,
                                        scale: Optional[float] = None,
                                        eps: float = 1e-6, extra_g=None):
    """Plain torch training forward: (out, :class:`AttnSaved`), the same
    arithmetic as :func:`fused_attention_layer_reference` plus the saves;
    ``extra_g`` the grouped bias [G, H, N, N] (the whole layer's)."""
    scale = _default_scale(wqkv, n_head, scale)
    B, N, C = x.shape
    HD = wqkv.shape[1] // 3
    xf = x.float()
    mu, rstd = _ln_stats(xf, eps)
    u = ((xf - mu) * rstd * ln_scale.float() + ln_bias.float()).to(x.dtype)
    qkv = _dot(u, wqkv, x.dtype)
    if bqkv is not None:
        qkv = qkv + bqkv
    q, k, v = (_heads(qkv[..., i * HD:(i + 1) * HD], n_head) for i in range(3))
    s = _scores_bias(torch.einsum("bhnd,bhmd->bhnm", q, k) * scale, extra_g)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    acc = torch.einsum("bhnm,bhmd->bnhd", p, v).to(x.dtype).reshape(B, N, HD)
    a = _dot(acc, wout, x.dtype)
    if bout is not None:
        a = a + bout
    out = _residual(x, a, row_scale)
    return out, AttnSaved(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, row_scale,
                          qkv, acc, mu[..., 0], rstd[..., 0], lse, n_head, scale, eps)


def out_proj_bwd_reference(acc2, wout, bout, rs, dz2, rows_per_scale: int,
                           need_drs: bool = True):
    """Steps 1-2 of the attention half's plain backward, f32, given the
    branch input acc2 [M, HD] and dz2 [M, C] f32: → (dacc [M, HD] f32, dwout,
    dbout, drs); ``rows_per_scale`` rows per sample of the row scale."""
    f = torch.float32
    acc2 = acc2.to(f)
    rsr = None if rs is None else rs.to(f).repeat_interleave(rows_per_scale)[:, None]
    # 1. da = r ⊙ dz; dwout = accᵀ·da; dbout = Σ_rows da
    da = dz2 if rs is None else dz2 * rsr
    dwout = acc2.t() @ da
    dbout = da.sum(0) if bout is not None else None
    # 2. dacc₀ = dz·woutᵀ; dr (reassociated); dacc = r ⊙ dacc₀
    dacc = dz2 @ wout.to(f).t()
    drs = None
    if rs is not None:
        if need_drs:
            per_row = (dacc * acc2).sum(1)
            if bout is not None:
                per_row = per_row + dz2 @ bout.to(f)
            drs = per_row.reshape(-1, rows_per_scale).sum(1).to(rs.dtype)
        dacc = dacc * rsr
    return dacc, cast_like(dwout, wout), cast_like(dbout, bout), drs


def qkv_proj_bwd_reference(x2, mu, rstd, g, b, wqkv, bqkv, dqkv, dz2):
    """Steps 4-6 of the attention half's plain backward, f32, given x2
    [M, C], its saved LN statistics, dqkv [M, 3HD] and the residual's
    cotangent dz2 [M, C]: → (dx [M, C] f32, dln_scale, dln_bias, dwqkv,
    dbqkv)."""
    f = torch.float32
    M = x2.shape[0]
    # 4. u from the saved statistics; dwqkv = uᵀ·dqkv; dbqkv = Σ_rows dqkv
    xhat = (x2.to(f) - mu.reshape(M, 1)) * rstd.reshape(M, 1)
    u = xhat * g.to(f) + b.to(f)
    dwqkv = u.t() @ dqkv
    dbqkv = dqkv.sum(0) if bqkv is not None else None
    # 5. dln = dqkv·wqkvᵀ
    dln = dqkv @ wqkv.to(f).t()
    # 6. LN backward (fused_layer.py:79-87)
    dx, dg, db = ln_bwd_reference(dln, xhat, rstd.reshape(M, 1), g, dz2)
    return dx, cast_like(dg, g), cast_like(db, b), cast_like(dwqkv, wqkv), \
        cast_like(dbqkv, bqkv)


def attention_half_bwd_reference(saved: AttnSaved, dz2: torch.Tensor,
                                 need_drs: bool = True, extra_g=None,
                                 need_dextra: bool = False):
    """The attention half's plain backward in the kernel's steps
    (csrc/fused_layer_bwd.cu), f32, given dz2 [B·N, C] f32: → (dx [B·N, C]
    f32, dln_scale, dln_bias, dwqkv, dbqkv, dwout, dbout, drs, dextra_g)
    with ``extra_g`` the grouped bias [G, H, N, N] the scores carried and
    dextra_g its gradient [G, H, N, N] (when ``need_dextra``)."""
    x, g, b, wqkv, bqkv, wout, bout, rs = saved[:8]
    B, N, C = x.shape
    H, scale = saved.n_head, saved.scale
    HD = wqkv.shape[1] // 3
    M = B * N
    f = torch.float32
    # 1-2. the out projection
    dacc, dwout, dbout, drs = out_proj_bwd_reference(
        saved.acc.reshape(M, HD), wout, bout, rs, dz2, N, need_drs)
    # 3. attention backward: p from the saved log-sum-exp
    q, k, v = (_heads(saved.qkv[..., i * HD:(i + 1) * HD], H) for i in range(3))
    do = _heads(dacc.reshape(B, N, HD), H)
    o = _heads(saved.acc, H)
    delta = (do * o).sum(-1, keepdim=True)
    s = _scores_bias(torch.einsum("bhnd,bhmd->bhnm", q, k) * scale, extra_g)
    p = torch.exp(s - saved.lse[..., None].to(f))
    dv = torch.einsum("bhnm,bhnd->bhmd", p, do)
    ds = p * (torch.einsum("bhnd,bhmd->bhnm", do, v) - delta)
    dextra_g = None
    if extra_g is not None and need_dextra:
        G = extra_g.shape[0]
        dextra_g = ds.reshape(G, B // G, H, N, N).sum(1)
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, k) * scale
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, q) * scale
    dqkv = torch.cat([t.permute(0, 2, 1, 3).reshape(M, HD) for t in (dq, dk, dv)], -1)
    # 4-6. the qkv projection and LN
    dx, dg, db, dwqkv, dbqkv = qkv_proj_bwd_reference(
        x.reshape(M, C), saved.mu, saved.rstd, g, b, wqkv, bqkv, dqkv, dz2)
    return dx, dg, db, dwqkv, dbqkv, dwout, dbout, drs, dextra_g


def ln_bwd_reference(dln, xhat, rstd, g, dres):
    """LayerNorm backward (fused_layer.py:79-87) plus the residual's
    cotangent dres: (dx, dg, db), f32."""
    dxhat = dln * g.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = dres + rstd * (dxhat - m1 - xhat * m2)
    return dx, (dln * xhat).sum(0), dln.sum(0)


def cast_like(t: Optional[torch.Tensor], like: Optional[torch.Tensor]):
    return None if t is None else t.to(like.dtype)


def fused_attention_layer_bwd_reference(saved: AttnSaved, dz: torch.Tensor,
                                        need_drs: bool = True):
    """Plain torch backward on the saved residuals, in the kernel's steps
    (csrc/fused_layer_bwd.cu): → (dx, dln_scale, dln_bias, dwqkv, dbqkv,
    dwout, dbout, drs); a bias grad is None where the bias is, drs None
    without a row scale or ``need_drs``."""
    x = saved.x
    dx, *grads, _ = attention_half_bwd_reference(
        saved, dz.reshape(-1, x.shape[-1]).float(), need_drs)
    return (dx.reshape(x.shape).to(x.dtype), *grads)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_f32(device: torch.device, **tensors: Optional[torch.Tensor]) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x is on {device}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"the CUDA kernel takes float32; {name} is {t.dtype}")


def check_vector(name: str, t: Optional[torch.Tensor], n: int) -> None:
    if t is not None and (tuple(t.shape) != (n,) or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous [{n}] vector, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")


def check_matrix(name: str, t: torch.Tensor, rows: int, cols: int) -> None:
    # any 2-D strides: the kernel reads element (k, n) at k·s0 + n·s1
    if tuple(t.shape) != (rows, cols):
        raise ValueError(f"{name} must be [{rows}, {cols}], got {tuple(t.shape)}")


def check_attention_args(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head):
    """Shape/layout checks shared by both CUDA ops; returns (B, N, C, H, D)."""
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, N, C] tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, N, C = x.shape
    if wqkv.ndim != 2 or wqkv.shape[1] % (3 * n_head):
        raise ValueError(f"wqkv must be [C, 3·H·D] with H={n_head}, got "
                         f"{tuple(wqkv.shape)}")
    HD = wqkv.shape[1] // 3
    D = HD // n_head
    if D > MAX_DIM_HEAD:
        raise NotImplementedError(
            f"the attention kernel holds heads up to {MAX_DIM_HEAD} wide; got {D}")
    check_vector("ln_scale", ln_scale, C)
    check_vector("ln_bias", ln_bias, C)
    check_matrix("wqkv", wqkv, C, 3 * HD)
    check_vector("bqkv", bqkv, 3 * HD)
    check_matrix("wout", wout, HD, C)
    check_vector("bout", bout, C)
    return B, N, C, n_head, D


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} CUDA launch failed: cudaError_t {err}")


def _cuda_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head, row_scale,
              scale, eps, save: bool):
    """The forward kernel: out, plus (qkv, acc, mu, rstd, lse) when ``save``."""
    global LAUNCHES
    check_f32(x.device, x=x, ln_scale=ln_scale, ln_bias=ln_bias, wqkv=wqkv,
              bqkv=bqkv, wout=wout, bout=bout, row_scale=row_scale)
    B, N, C, H, D = check_attention_args(x, ln_scale, ln_bias, wqkv, bqkv,
                                         wout, bout, n_head)
    check_vector("row_scale", row_scale, B)
    from ._build import build

    lib = build()
    M, HD = B * N, H * D
    opts = dict(device=x.device, dtype=torch.float32)
    u = torch.empty((M, C), **opts)
    qkv = torch.empty((B, N, 3 * HD), **opts)
    acc = torch.empty((B, N, HD), **opts)
    mu, rstd, lse = ((torch.empty((B, N), **opts), torch.empty((B, N), **opts),
                      torch.empty((B, H, N), **opts)) if save else (None, None, None))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        LAUNCHES += 1
        err = lib.vtx_fused_attention_layer_fwd(
            ptr(x), ptr(ln_scale), ptr(ln_bias),
            ptr(wqkv), wqkv.stride(0), wqkv.stride(1), ptr(bqkv),
            ptr(wout), wout.stride(0), wout.stride(1), ptr(bout), ptr(row_scale),
            ptr(u), ptr(qkv), ptr(acc), ptr(mu), ptr(rstd), ptr(lse), ptr(out),
            B, N, C, H, D, ctypes.c_float(scale), ctypes.c_float(eps), stream)
    _raise_on(err, "fused_attention_layer")
    return out, (qkv, acc, mu, rstd, lse)


def like_layout(w: torch.Tensor) -> torch.Tensor:
    """An empty gradient for weight view ``w``, in its layout when that is
    dense (the [in, out] view of a torch [out, in] weight is), else
    contiguous."""
    if w.is_contiguous() or w.t().is_contiguous():
        return torch.empty_strided(w.shape, w.stride(), dtype=torch.float32,
                                   device=w.device)
    return torch.empty(w.shape, dtype=torch.float32, device=w.device)


_SM_WAVE = 4 * 132  # GEMM blocks to aim a split-K weight gradient at


def _splits(rows: int, cols: int, k: int) -> int:
    """K-slabs for a split-K weight-gradient GEMM of [rows, cols] over k
    (csrc/common.cuh tiles: 128 x 64, k slabs of at least 256)."""
    tiles = -(-rows // 128) * -(-cols // 64)
    return max(1, min(-(-_SM_WAVE // tiles), k // 256))


def _cuda_bwd(saved: AttnSaved, dz: torch.Tensor, need_drs: bool):
    """The backward kernel sequence: (dx, dg, db, dwqkv, dbqkv, dwout, dbout,
    drs)."""
    global BWD_LAUNCHES
    x, g, b, wqkv, bqkv, wout, bout, rs = saved[:8]
    dz = dz.contiguous()
    check_f32(x.device, dz=dz, qkv=saved.qkv, acc=saved.acc, lse=saved.lse)
    if dz.shape != x.shape:
        raise ValueError(f"dz must be {tuple(x.shape)}, got {tuple(dz.shape)}")
    B, N, C = x.shape
    H = saved.n_head
    HD = wqkv.shape[1] // 3
    D = HD // H
    M = B * N
    from ._build import build

    lib = build()
    opts = dict(device=x.device, dtype=torch.float32)
    s_out, s_qkv = _splits(HD, C, M), _splits(C, 3 * HD, M)
    chunks = -(-M // 128)  # csrc COLSUM_ROWS
    ws = dict(
        da=torch.empty((M, C), **opts) if rs is not None else None,
        dacc=torch.empty((M, HD), **opts), delta=torch.empty((B, H, N), **opts),
        dqkv=torch.empty((M, 3 * HD), **opts), u=torch.empty((M, C), **opts),
        dln=torch.empty((M, C), **opts),
        wpart=torch.empty((max(s_out * HD * C, s_qkv * C * 3 * HD),), **opts),
        cpart=torch.empty((chunks * max(C, 3 * HD),), **opts))
    dx = torch.empty_like(x)
    dg, db = torch.empty((C,), **opts), torch.empty((C,), **opts)
    dwqkv, dwout = like_layout(wqkv), like_layout(wout)
    dbqkv = torch.empty((3 * HD,), **opts) if bqkv is not None else None
    dbout = torch.empty((C,), **opts) if bout is not None else None
    drs = torch.empty((B,), **opts) if rs is not None and need_drs else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        BWD_LAUNCHES += 1
        err = lib.vtx_fused_attention_layer_bwd(
            ptr(x), ptr(g), ptr(b),
            ptr(wqkv), wqkv.stride(0), wqkv.stride(1), ptr(bqkv),
            ptr(wout), wout.stride(0), wout.stride(1), ptr(bout),
            ptr(rs), ptr(saved.qkv), ptr(saved.acc), ptr(saved.mu),
            ptr(saved.rstd), ptr(saved.lse), ptr(dz),
            *(ptr(ws[k]) for k in ("da", "dacc", "delta", "dqkv", "u", "dln")),
            ptr(ws["wpart"]), s_out, s_qkv, ptr(ws["cpart"]),
            ptr(dx), ptr(dg), ptr(db),
            ptr(dwqkv), dwqkv.stride(0), dwqkv.stride(1), ptr(dbqkv),
            ptr(dwout), dwout.stride(0), dwout.stride(1), ptr(dbout), ptr(drs),
            B, N, C, H, D, ctypes.c_float(saved.scale), stream)
    _raise_on(err, "fused_attention_layer backward")
    return dx, dg, db, dwqkv, dbqkv, dwout, dbout, drs


def fused_attention_layer_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                              n_head: int, row_scale=None,
                              scale: Optional[float] = None, eps: float = 1e-6):
    """Training forward with saves: (out, :class:`AttnSaved`) — the kernel
    for a CUDA tensor, the plain version for a CPU one."""
    scale = _default_scale(wqkv, n_head, scale)
    if x.is_cuda:
        out, res = _cuda_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head,
                             row_scale, scale, float(eps), save=True)
        return out, AttnSaved(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                              row_scale, *res, n_head, scale, float(eps))
    if x.device.type == "cpu":
        return fused_attention_layer_fwd_reference(
            x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head, row_scale,
            scale, eps)
    raise NotImplementedError(f"no fused_attention_layer for device {x.device}")


def fused_attention_layer_bwd(saved: AttnSaved, dz: torch.Tensor,
                              need_drs: bool = True):
    """Backward on the saves of :func:`fused_attention_layer_fwd` — the
    kernel for a CUDA tensor, the plain version for a CPU one."""
    if dz.is_cuda:
        return _cuda_bwd(saved, dz, need_drs)
    if dz.device.type == "cpu":
        return fused_attention_layer_bwd_reference(saved, dz, need_drs)
    raise NotImplementedError(f"no fused_attention_layer backward for {dz.device}")


class _FusedAttentionLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, row_scale,
                n_head, scale, eps):
        out, saved = fused_attention_layer_fwd(x, ln_scale, ln_bias, wqkv, bqkv,
                                               wout, bout, n_head, row_scale,
                                               scale, eps)
        ctx.save_for_backward(*saved[:13])
        ctx.attrs = saved[13:]
        return out

    @staticmethod
    def backward(ctx, dz):
        saved = AttnSaved(*ctx.saved_tensors, *ctx.attrs)
        grads = fused_attention_layer_bwd(saved, dz, ctx.needs_input_grad[7])
        return (*grads, None, None, None)


def fused_attention_layer(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                          n_head: int, extra=None, row_scale=None,
                          scale: Optional[float] = None, eps: float = 1e-6):
    """Pre-LN attention residual branch, fused:
    ``x + row_scale ⊙ OutProj(MHSA(QkvProj(LN(x))))``, differentiable."""
    scale = _default_scale(wqkv, n_head, scale)
    if x.is_cuda and extra is not None:
        raise NotImplementedError("the CUDA kernels take extra=None")
    tensors = (x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, row_scale)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
    if needs_grad and extra is None:
        return _FusedAttentionLayer.apply(*tensors, n_head, scale, float(eps))
    if x.is_cuda:
        return _cuda_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head,
                         row_scale, scale, float(eps), save=False)[0]
    if x.device.type == "cpu":
        # with extra, a gradient comes from torch autograd of the plain version
        return fused_attention_layer_reference(
            x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head, extra,
            row_scale, scale, eps)
    raise NotImplementedError(f"no fused_attention_layer for device {x.device}")
