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
output acc, the LN statistics mu / rstd, the softmax log-sum-exp lse and
the bias in its grouped form — as the JAX ``custom_vjp`` does
(fused_layer.py:422-427,493-499,569-674).  The backward returns the
bias's gradient, in the caller's form, only when the bias requires one
(Twins' block mask does not).  A call that needs none
(``torch.no_grad()``, the serving path) saves nothing.

A CPU tensor runs the plain torch versions: the forward
:func:`fused_attention_layer_reference` (the cast points of the JAX
package's ``_attn_layer_ref``, fused_layer.py:502-542: LN statistics f32,
dots f32-accumulated, softmax f32) and the backward
:func:`fused_attention_layer_bwd_reference`.  A CUDA tensor runs the
hand-written kernels in ``csrc/fused_layer.cu`` (forward) and
``csrc/fused_layer_bwd.cu`` (backward) or raises; it never falls back to
the plain versions.  The kernels take float32, or bfloat16 (below), and
heads up to ``MAX_DIM_HEAD`` wide.  A bias call over windows of up to ``MAX_BIAS_TOKENS`` tokens with
heads up to ``MAX_BIAS_DIM_HEAD`` wide (Twins' and Swin's: 98 tokens, heads
32 wide) runs on the tensor-core window attention
(``csrc/window_attention_tc.cuh``, :func:`window_on_bias`); every other call
— without a bias (ViT), or with one at heads 64 wide (DINO's packed local
crops: 111 tokens under the block-diagonal −1e9 mask) — on the packed-row
tensor-core attention (``csrc/attention_tc.cuh``, any number of tokens),
whose backward takes dq as per key-tile partials (:func:`dq_partials`).
Anything else on a CUDA tensor raises NotImplementedError.  The weights may
be any 2-D strided view: the model passes ``linear.weight.t()``, and the
wrapper hands those strides to the kernels instead of copying the weights;
their gradients come back in the view's shape and layout.

bf16, the JAX package's default precision: with x bfloat16 the op computes
at the JAX kernel's rounding points (fused_layer.py:116-166, 183-339): the
activations, weights and biases bfloat16 (the model casts them at each use),
the LN parameters and the row scale float32, every product accumulated in
f32 and rounded once, the softmax and the LN statistics f32, the row scale
rounded to bf16 before it scales.  The backward returns dx in bf16, the
LN parameters' gradients and drs in f32, and the weights' and biases'
gradients summed in f32 and rounded once to their bf16 dtype.  On the card
the bias-free call runs the kernels' bf16 forms (``csrc/fused_layer.cu`` /
``fused_layer_bwd.cu``'s ``_bf16`` entries, on the GEMM core's bf16 form
and the packed-row attention's, ``csrc/attention_bf16_tma.cuh``: wgmma fed
by TMA, heads a multiple of 8 up to 64 wide, its backward's workspace
:func:`packed_attention_bf16_floats`), with or without the bias: DINO's
block mask on its packed local crops (111 tokens) and Swin-S's grouped
bias take it as the JAX kernel does, s = q·kᵀ·scale + extra in f32 before
the max.  The bias's gradient at bf16 (Swin-S's relative-position bias)
comes from the same core's backward, dS summed in f32 per chunk of each
group's windows on chip and the chunks summed in order, over windows of
up to ``MAX_BIAS_TOKENS`` tokens (one key tile); a longer call that asks
for it raises NotImplementedError.  The plain versions round where the
kernels do.

The FF residual branch has its own op here, as in the JAX module
(fused_layer.py:701-971): :func:`fused_ff_layer`, ``x + row_scale ⊙
(act(LN(x)·W₁ + b₁)·W₂ + b₂)`` with act silu or tanh-gelu and b₁, b₂,
row_scale each optional.  Its forward saves the pre-activation and the LN
statistics (the Pallas backward recomputes them); its backward returns dx,
dln_scale, dln_bias, dW₁, db₁, dW₂, db₂ and drs.  A CPU tensor runs
:func:`fused_ff_layer_reference` / :func:`fused_ff_layer_bwd_reference`, a
CUDA tensor the kernels of ``csrc/fused_layer.cu`` (forward) and
``csrc/fused_layer1_bwd.cu`` (backward), f32 only, or raises.
"""

from __future__ import annotations

import functools

import ctypes
import math
from typing import NamedTuple, Optional

import torch

__all__ = ["fused_attention_layer", "fused_attention_layer_reference",
           "fused_attention_layer_bwd_reference", "AttnSaved", "LAUNCHES",
           "BWD_LAUNCHES", "BIAS_LAUNCHES", "BIAS_BWD_LAUNCHES", "fused_ff_layer",
           "fused_ff_layer_reference", "fused_ff_layer_fwd", "fused_ff_layer_bwd",
           "fused_ff_layer_fwd_reference", "fused_ff_layer_bwd_reference", "FFSaved",
           "FF_GRAD_NAMES", "FF_LAUNCHES", "FF_BWD_LAUNCHES", "BF16_LAUNCHES",
           "BF16_BWD_LAUNCHES", "BF16_TODO", "packed_attention_bf16",
           "packed_attention_bf16_bwd", "packed_attention_reference",
           "packed_attention_bf16_floats", "PACKED_BF16_LAUNCHES",
           "PACKED_BF16_BWD_LAUNCHES", "BF16_BIAS_LAUNCHES", "BF16_BIAS_BWD_LAUNCHES",
           "PACKED_BF16_BIAS_LAUNCHES", "PACKED_BF16_BIAS_BWD_LAUNCHES",
           "PACKED_BF16_DBIAS_BWD_LAUNCHES"]

# kernel launches through this module's wrappers, forward and backward
# (chip_smoke.py reads them to show the main path went through the kernels),
# and of those the launches that carried the bias
LAUNCHES = 0
BWD_LAUNCHES = 0
BIAS_LAUNCHES = 0
BIAS_BWD_LAUNCHES = 0
# ... and of those the launches of the bf16 forms, and of those the ones
# with the bias
BF16_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0
BF16_BIAS_LAUNCHES = 0
BF16_BIAS_BWD_LAUNCHES = 0
# the launches of the packed-row attention's bf16 form
# (csrc/attention_bf16_tma.cuh), forward and backward: one in each bf16 call
# of B1 and B2 (fused_layer1.py) and of the thin doors below; and of those
# the ones with the bias
PACKED_BF16_LAUNCHES = 0
PACKED_BF16_BWD_LAUNCHES = 0
PACKED_BF16_BIAS_LAUNCHES = 0
PACKED_BF16_BIAS_BWD_LAUNCHES = 0
# ... and of the backward's, the launches that summed the bias's gradient
PACKED_BF16_DBIAS_BWD_LAUNCHES = 0

# where the bf16 forms still to write are queued, by the item each waits on
BF16_TODO = ("its bf16 form is not written yet (ROADMAP.md §A2's bf16 queue: B4, B5a "
             "and B5b item 3, Halo-S; B6 item 4, PVT-S and Twins-SVT-S; B3 item 5, ViT "
             "with dropout; B8 item 6; B9 item 7; B7 item 8)")

# widest head the attention takes (csrc DMAX: the packed-row tensor-core
# core, attention_tc.cuh, stages heads 32 or 64 floats wide)
MAX_DIM_HEAD = 64
# widest head the window attention takes with the additive bias (csrc
# EXTRA_DMAX) ...
MAX_BIAS_DIM_HEAD = 32
# ... and most tokens (csrc wta::NMAX)
MAX_BIAS_TOKENS = 128


def window_on_bias(has_bias: bool, N: int, D: int) -> bool:
    """Whether an f32 B1 / B2 attention call runs on the window attention
    (csrc window_on_bias): a bias, N ≤ ``MAX_BIAS_TOKENS`` and heads up to
    ``MAX_BIAS_DIM_HEAD`` wide; every other call on the packed-row core.
    At bf16 every call, with a bias or not, takes the packed-row core's bf16
    form (the bias's gradient too): the window attention has no bf16
    form."""
    return has_bias and N <= MAX_BIAS_TOKENS and D <= MAX_BIAS_DIM_HEAD


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


def _rb(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t (f32) as ``dtype`` would hold it, in f32: rounded where dtype is
    bf16 (a step the backward's kernels round), t itself in f32."""
    return t if dtype == torch.float32 else t.to(dtype).float()


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
    qkv [B, N, 3HD], acc [B, N, HD], mu / rstd [B, N], lse [B, H, N], the
    bias in its grouped [G, H, N, N] f32 form (or None)."""

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
    extra_g: Optional[torch.Tensor]
    n_head: int
    scale: float
    eps: float


N_SAVED_TENSORS = 14  # AttnSaved's tensor fields; the rest are attributes


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
    p = _rb(torch.softmax(s, dim=-1), x.dtype)
    acc = torch.einsum("bhnm,bhmd->bnhd", p, v).to(x.dtype).reshape(B, N, HD)
    a = _dot(acc, wout, x.dtype)
    if bout is not None:
        a = a + bout
    out = _residual(x, a, row_scale)
    return out, AttnSaved(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, row_scale,
                          qkv, acc, mu[..., 0], rstd[..., 0], lse, extra_g, n_head,
                          scale, eps)


def out_proj_bwd_reference(acc2, wout, bout, rs, dz2, rows_per_scale: int,
                           need_drs: bool = True):
    """Steps 1-2 of the attention half's plain backward, f32, given the
    branch input acc2 [M, HD] and dz2 [M, C] f32: → (dacc [M, HD] f32, dwout,
    dbout, drs); ``rows_per_scale`` rows per sample of the row scale.  With
    acc2 bf16, da and dacc are rounded as the bf16 kernels round them."""
    f, dt = torch.float32, acc2.dtype
    acc2 = acc2.to(f)
    rsr = None if rs is None else rs.to(f).repeat_interleave(rows_per_scale)[:, None]
    # 1. da = r ⊙ dz (r rounded first, as the forward's); dwout = accᵀ·da;
    # dbout = Σ_rows da
    da = dz2 if rs is None else _rb(dz2 * _rb(rsr, dt), dt)
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
    return _rb(dacc, dt), cast_like(dwout, wout), cast_like(dbout, bout), drs


def qkv_proj_bwd_reference(x2, mu, rstd, g, b, wqkv, bqkv, dqkv, dz2):
    """Steps 4-6 of the attention half's plain backward, f32, given x2
    [M, C], its saved LN statistics, dqkv [M, 3HD] and the residual's
    cotangent dz2 [M, C]: → (dx [M, C] f32, dln_scale, dln_bias, dwqkv,
    dbqkv).  With x2 bf16, u and the LN's part of dx are rounded as the
    bf16 kernels round them."""
    f, dt = torch.float32, x2.dtype
    M = x2.shape[0]
    # 4. u from the saved statistics; dwqkv = uᵀ·dqkv; dbqkv = Σ_rows dqkv
    xhat = (x2.to(f) - mu.reshape(M, 1)) * rstd.reshape(M, 1)
    u = _rb(xhat * g.to(f) + b.to(f), dt)
    dwqkv = u.t() @ dqkv
    dbqkv = dqkv.sum(0) if bqkv is not None else None
    # 5. dln = dqkv·wqkvᵀ
    dln = dqkv @ wqkv.to(f).t()
    # 6. LN backward (fused_layer.py:79-87)
    dx, dg, db = ln_bwd_reference(dln, xhat, rstd.reshape(M, 1), g, dz2, dt)
    return dx, cast_like(dg, g), cast_like(db, b), cast_like(dwqkv, wqkv), \
        cast_like(dbqkv, bqkv)


def attention_bwd_reference(qkv, out, lse, dout, n_head: int, scale: float, extra_g=None,
                            dtype=torch.float32):
    """The packed-row attention's plain backward: (dqkv [B, N, 3·H·D] f32,
    as ``dtype`` holds it, and dS [B, H, N, N] f32) from qkv, the forward's
    out and lse [B, H, N] and dout [B, N, H·D] (read in f32), P from the
    log-sum-exp and Δ = rowsum(dout ⊙ out).  bf16: P and dS·scale rounded before their products,
    each of dq, dk, dv once after (the bf16 kernels' points, and the JAX
    kernel's)."""
    B, N, HD3 = qkv.shape
    HD = HD3 // 3
    f = torch.float32
    q, k, v = (_heads(qkv[..., i * HD:(i + 1) * HD], n_head) for i in range(3))
    do, o = _heads(dout, n_head), _heads(out, n_head)
    delta = (do * o).sum(-1, keepdim=True)
    s = _scores_bias(torch.einsum("bhnd,bhmd->bhnm", q, k) * scale, extra_g)
    p = torch.exp(s - lse[..., None].to(f))
    dv = torch.einsum("bhnm,bhnd->bhmd", _rb(p, dtype), do)
    ds = p * (torch.einsum("bhnd,bhmd->bhnm", do, v) - delta)
    if dtype == f:
        dq = torch.einsum("bhnm,bhmd->bhnd", ds, k) * scale
        dk = torch.einsum("bhnm,bhnd->bhmd", ds, q) * scale
    else:
        dsb = _rb(ds * scale, dtype)
        dq = torch.einsum("bhnm,bhmd->bhnd", dsb, k)
        dk = torch.einsum("bhnm,bhnd->bhmd", dsb, q)
    dqkv = torch.cat([_rb(t.permute(0, 2, 1, 3).reshape(B, N, HD), dtype)
                      for t in (dq, dk, dv)], -1)
    return dqkv, ds


def attention_half_bwd_reference(saved: AttnSaved, dz2: torch.Tensor,
                                 need_drs: bool = True, need_dextra: bool = False):
    """The attention half's plain backward in the kernel's steps
    (csrc/fused_layer_bwd.cu), f32, given dz2 [B·N, C] f32: → (dx [B·N, C]
    f32, dln_scale, dln_bias, dwqkv, dbqkv, dwout, dbout, drs, dextra_g)
    with dextra_g the gradient [G, H, N, N] of the grouped bias the scores
    carried (when ``need_dextra``)."""
    x, g, b, wqkv, bqkv, wout, bout, rs = saved[:8]
    extra_g = saved.extra_g
    B, N, C = x.shape
    H, scale = saved.n_head, saved.scale
    HD = wqkv.shape[1] // 3
    M = B * N
    # 1-2. the out projection
    dacc, dwout, dbout, drs = out_proj_bwd_reference(
        saved.acc.reshape(M, HD), wout, bout, rs, dz2, N, need_drs)
    # 3. attention backward: p from the saved log-sum-exp
    dqkv, ds = attention_bwd_reference(saved.qkv, saved.acc, saved.lse,
                                       dacc.reshape(B, N, HD), H, scale, extra_g, x.dtype)
    dqkv = dqkv.reshape(M, 3 * HD)
    dextra_g = None
    if extra_g is not None and need_dextra:
        G = extra_g.shape[0]
        dextra_g = ds.reshape(G, B // G, H, N, N).sum(1)
    # 4-6. the qkv projection and LN
    dx, dg, db, dwqkv, dbqkv = qkv_proj_bwd_reference(
        x.reshape(M, C), saved.mu, saved.rstd, g, b, wqkv, bqkv, dqkv, dz2)
    return dx, dg, db, dwqkv, dbqkv, dwout, dbout, drs, dextra_g


def ln_bwd_reference(dln, xhat, rstd, g, dres, dtype=torch.float32):
    """LayerNorm backward (fused_layer.py:79-87) plus the residual's
    cotangent dres: (dx, dg, db), f32; with ``dtype`` bf16 the LN's part and
    dx rounded (the JAX kernel's dz + dx_ln.astype(bf16))."""
    dxhat = dln * g.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = _rb(dres + _rb(rstd * (dxhat - m1 - xhat * m2), dtype), dtype)
    return dx, (dln * xhat).sum(0), dln.sum(0)


def cast_like(t: Optional[torch.Tensor], like: Optional[torch.Tensor]):
    return None if t is None else t.to(like.dtype)


def fused_attention_layer_bwd_reference(saved: AttnSaved, dz: torch.Tensor,
                                        need_drs: bool = True,
                                        need_dextra: bool = True):
    """Plain torch backward on the saved residuals, in the kernel's steps
    (csrc/fused_layer_bwd.cu): → (dx, dln_scale, dln_bias, dwqkv, dbqkv,
    dwout, dbout, drs, dextra_g); a bias grad is None where the bias is,
    drs None without a row scale or ``need_drs``, dextra_g (grouped
    [G, H, N, N]) None without the bias or ``need_dextra``."""
    x = saved.x
    dx, *grads = attention_half_bwd_reference(
        saved, dz.reshape(-1, x.shape[-1]).float(), need_drs, need_dextra)
    return (dx.reshape(x.shape).to(x.dtype), *grads)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_f32(device: torch.device, **tensors: Optional[torch.Tensor]) -> None:
    """Every tensor on ``device`` and float32; a bfloat16 one raises
    NotImplementedError naming the queue of the bf16 forms still to write
    (it is never cast and sent on)."""
    check_dtype(device, torch.float32, **tensors)


def check_dtype(device: torch.device, dtype: torch.dtype,
                **tensors: Optional[torch.Tensor]) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x is on {device}")
        if t.dtype != dtype:
            todo = f"; {BF16_TODO}" if t.dtype == torch.bfloat16 else ""
            raise NotImplementedError(
                f"the CUDA kernel takes {dtype}; {name} is {t.dtype}{todo}")


def check_bf16_form(x: torch.Tensor, D: int, params: dict, **acts) -> bool:
    """Whether the call takes the kernels' bf16 form (x bfloat16): then
    ``acts`` (the activations, weights, biases) bfloat16, ``params`` (the
    LN parameters, row scales, the bias) float32 and heads a multiple of 8
    wide; else every tensor float32.  Raises NotImplementedError on what no
    form takes."""
    if x.dtype != torch.bfloat16:
        check_f32(x.device, x=x, **acts, **params)
        return False
    check_dtype(x.device, torch.bfloat16, x=x, **acts)
    check_dtype(x.device, torch.float32, **params)
    if D % 8:
        raise NotImplementedError(
            f"the bf16 kernels take heads a multiple of 8 wide; got {D}")
    return True


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
            f"the attention kernel takes heads up to {MAX_DIM_HEAD} wide; got {D}")
    check_vector("ln_scale", ln_scale, C)
    check_vector("ln_bias", ln_bias, C)
    check_matrix("wqkv", wqkv, C, 3 * HD)
    check_vector("bqkv", bqkv, 3 * HD)
    check_matrix("wout", wout, HD, C)
    check_vector("bout", bout, C)
    return B, N, C, n_head, D


def check_extra(extra_g: Optional[torch.Tensor], H: int, N: int, D: int,
                window_only: bool = False) -> None:
    """The grouped bias [G, H, N, N] the kernels take.  B1 takes it at any
    head width the attention takes; with ``window_only`` (B2's f32 form,
    whose bias calls — Swin's — stay on the window attention) heads up to
    ``MAX_BIAS_DIM_HEAD`` wide and N up to ``MAX_BIAS_TOKENS``."""
    if extra_g is None:
        return
    if window_only and D > MAX_BIAS_DIM_HEAD:
        raise NotImplementedError(
            f"the CUDA kernel takes the bias with heads up to {MAX_BIAS_DIM_HEAD} "
            f"wide; got {D}")
    if window_only and N > MAX_BIAS_TOKENS:
        raise NotImplementedError(
            f"the CUDA kernel takes the bias over up to {MAX_BIAS_TOKENS} tokens; "
            f"got {N}")
    if extra_g.ndim != 4 or tuple(extra_g.shape[1:]) != (H, N, N):
        raise ValueError(f"extra must be [G, {H}, {N}, {N}], got {tuple(extra_g.shape)}")


def check_bf16_dbias(N: int) -> None:
    """The bf16 attention sums the bias's gradient over one key tile:
    windows of up to ``MAX_BIAS_TOKENS`` tokens (csrc attention_bf16.cu)."""
    if N > MAX_BIAS_TOKENS:
        raise NotImplementedError(
            f"the bf16 attention's bias gradient takes up to {MAX_BIAS_TOKENS} tokens "
            f"(one key tile); got {N}")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} CUDA launch failed: cudaError_t {err}")


def _cuda_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head, extra_g, groups,
              row_scale, scale, eps, save: bool):
    """The forward kernel: out, plus (qkv, acc, mu, rstd, lse) when ``save``;
    ``extra_g`` the grouped bias [G, H, N, N] (``groups`` = G) or None."""
    global LAUNCHES, BIAS_LAUNCHES, BF16_LAUNCHES, PACKED_BF16_LAUNCHES, \
        BF16_BIAS_LAUNCHES, PACKED_BF16_BIAS_LAUNCHES
    B, N, C, H, D = check_attention_args(x, ln_scale, ln_bias, wqkv, bqkv,
                                         wout, bout, n_head)
    bf16 = check_bf16_form(x, D, dict(ln_scale=ln_scale, ln_bias=ln_bias,
                                      row_scale=row_scale, extra=extra_g),
                           wqkv=wqkv, bqkv=bqkv, wout=wout, bout=bout)
    check_extra(extra_g, H, N, D)
    check_vector("row_scale", row_scale, B)
    from ._build import build

    lib = build()
    M, HD = B * N, H * D
    opts = dict(device=x.device, dtype=torch.float32)
    act = dict(device=x.device, dtype=x.dtype)  # the activations' workspace
    u = torch.empty((M, C), **act)
    qkv = torch.empty((B, N, 3 * HD), **act)
    acc = torch.empty((B, N, HD), **act)
    mu, rstd, lse = ((torch.empty((B, N), **opts), torch.empty((B, N), **opts),
                      torch.empty((B, H, N), **opts)) if save else (None, None, None))
    out = torch.empty_like(x)
    entry = lib.vtx_fused_attention_layer_fwd_bf16 if bf16 else lib.vtx_fused_attention_layer_fwd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        LAUNCHES += 1
        BIAS_LAUNCHES += extra_g is not None
        BF16_LAUNCHES += bf16
        PACKED_BF16_LAUNCHES += bf16
        BF16_BIAS_LAUNCHES += bf16 and extra_g is not None
        PACKED_BF16_BIAS_LAUNCHES += bf16 and extra_g is not None
        err = entry(
            ptr(x), ptr(ln_scale), ptr(ln_bias),
            ptr(wqkv), wqkv.stride(0), wqkv.stride(1), ptr(bqkv),
            ptr(wout), wout.stride(0), wout.stride(1), ptr(bout),
            ptr(extra_g), groups, ptr(row_scale),
            ptr(u), ptr(qkv), ptr(acc), ptr(mu), ptr(rstd), ptr(lse), ptr(out),
            B, N, C, H, D, ctypes.c_float(scale), ctypes.c_float(eps), stream)
    _raise_on(err, "fused_attention_layer")
    return out, (qkv, acc, mu, rstd, lse)


def like_layout(w: torch.Tensor) -> torch.Tensor:
    """An empty f32 gradient for weight view ``w``, in its layout when that
    is dense (the [in, out] view of a torch [out, in] weight is), else
    contiguous."""
    if w.is_contiguous() or w.t().is_contiguous():
        return torch.empty_strided(w.shape, w.stride(), dtype=torch.float32,
                                   device=w.device)
    return torch.empty(w.shape, dtype=torch.float32, device=w.device)


_SMS = 132  # the H100's SMs: the GEMM core runs one persistent block on each


@functools.lru_cache(maxsize=None)
def window_chunks(P: int, G: int, H: int) -> int:
    """Chunks of each group's windows or images in the bias gradient's sum,
    the f32 window attention's backward and the bf16 packed-row
    attention's (csrc/common.cuh bias_chunks): the fewest c whose rounds of
    blocks (one an SM) times the windows a block takes, ⌈G·H·c / 132⌉·⌈R /
    c⌉ for R = P / G, come within 5% of the least over c ≤ R.  Their dbias
    partials are [chunks, G, H, N, N]."""
    R, GH = P // G, G * H

    def cost(c):
        return -(-GH * c // _SMS) * -(-R // c)

    best = min(cost(c) for c in range(1, R + 1))
    return next(c for c in range(1, R + 1) if 20 * cost(c) <= 21 * best)


def bias_partials(P: int, G: int, H: int, N: int, opts) -> torch.Tensor:
    """The window attention backward's dbias partials workspace."""
    return torch.empty((window_chunks(P, G, H), G, H, N, N), **opts)


def _splits(rows: int, cols: int, k: int) -> int:
    """K-slabs for a split-K weight-gradient GEMM of [rows, cols] over k
    (csrc/gemm_tc.cu: 128 x 128 tiles, 128 x 64 where 64-column ones pad
    cols less, walked by one persistent block an SM): the fewest slabs, each
    at least 512 deep (32 of its 16-deep steps), that give every SM two
    tiles or more and leave at most a tenth of the last round's blocks
    idle; failing that, the count that idles least."""
    bn = 64 if -(-cols // 64) * 64 < -(-cols // 128) * 128 else 128
    tiles = -(-rows // 128) * -(-cols // bn)
    counts = range(1, max(1, k // 512) + 1)

    def idle(s):  # the idle share of the rounds of tiles·s over the SMs
        room = -(-tiles * s // _SMS) * _SMS
        return (room - tiles * s) / room

    return next((s for s in counts if tiles * s >= 2 * _SMS and idle(s) <= 0.1),
                min(counts, key=lambda s: (idle(s), s)))


def dq_partials(n_keys: int, rows: int, width: int, opts) -> Optional[torch.Tensor]:
    """The dq partials of csrc/attention_tc.cuh's backward (B1's and B2's
    f32 attention off the window attention, B3, B6, B8): [ceil(n_keys / 64),
    rows, width] f32, one a 64-key tile, summed in key-tile order; None with
    one key tile."""
    key_tiles = -(-n_keys // 64)
    return torch.empty((key_tiles, rows, width), **opts) if key_tiles > 1 else None


# csrc/attention_bf16_tma.cuh DQ_SMEM_MAX_N: up to here its backward sums a
# head's dq in shared memory
BF16_DQ_SMEM_MAX_N = 256


def packed_attention_bf16_floats(B: int, N: int, H: int, D: int, G: int = 1,
                                 dbias: bool = False) -> int:
    """The f32 workspace of the packed-row attention's bf16 backward
    (csrc/attention_bf16.cu packed_attention_bwd_bf16_floats): the L and Δ
    rows [B·H, ceil(N / 64), 2, 64], then, where N > 256 (a head's dq past
    what shared memory holds), the key tiles' dq partials [ceil(N / 128),
    B·N, H·D], summed in order, and with the bias's gradient (``dbias``, G
    groups) the chunks' dS sums [:func:`window_chunks`, G, H, N, N]."""
    rows = 2 * B * H * -(-N // 64) * 64
    dq = -(-N // 128) * B * N * H * D if N > BF16_DQ_SMEM_MAX_N else 0
    return rows + dq + (window_chunks(B, G, H) * G * H * N * N if dbias else 0)


def packed_attention_bf16_route(N: int, bias: bool = False) -> dict:
    """The tiles the packed-row attention's bf16 kernels take for N tokens
    (csrc/attention_bf16.cu): the forward's key tile, 208 keys where 192 <
    N ≤ 208 without a bias, else 128; the backward's dq summed over the key
    tiles in shared memory up to BF16_DQ_SMEM_MAX_N tokens, else as f32
    key-tile partials summed in order."""
    return {"key_tile": 208 if 192 < N <= 208 and not bias else 128,
            "dq": "shared memory" if N <= BF16_DQ_SMEM_MAX_N else "key-tile partials"}


def bf16_attention_workspace(B: int, N: int, H: int, D: int, row_scaled: bool,
                             opts, G: int = 1, dbias: bool = False,
                             first: int = 0) -> torch.Tensor:
    """B1's and B2's bf16 backward's f32 ``dq_part`` workspace: the
    attention's (:func:`packed_attention_bf16_floats`, with the dbias sums
    of G groups where ``dbias``), or with a row scale the out projection's
    f32 dacc₀ [B·N, H·D] first, or ``first`` floats (B2: the FF half's da₀),
    whichever is largest."""
    floats = packed_attention_bf16_floats(B, N, H, D, G, dbias)
    return torch.empty((max(floats, B * N * H * D if row_scaled else 0, first),), **opts)


def attention_workspace(B: int, groups: int, H: int, N: int, D: int, has_bias: bool,
                        want_dextra: bool, opts):
    """(dq_part, dbpart) of B1's and B2's f32 attention backward on the
    route of :func:`window_on_bias`: on the window attention no dq partials,
    and with a bias gradient its per-block partials (:func:`bias_partials`);
    on the packed-row core the dq partials, and with a bias gradient the dS
    buffer [B, H, N, N] — DINO's mask needs no gradient, so none.  (B1's
    bf16 backward: :func:`bf16_attention_workspace`.)"""
    if window_on_bias(has_bias, N, D):
        return None, bias_partials(B, groups, H, N, opts) if want_dextra else None
    return (dq_partials(N, B * N, H * D, opts),
            torch.empty((B, H, N, N), **opts) if want_dextra else None)


def rpart_floats(rows: int, F: int, B: int, rows_per_scale: int) -> int:
    """The FF backward's partials workspace (csrc/common.cuh
    ff_rpart_floats): the dh GEMM's row partials [rows, ceil(F / 64)], the
    dr pass's chunk sums [ceil(rows_per_scale / 64), B], then the dh GEMM's
    column partials [ceil(rows / 16), F]."""
    return rows * -(-F // 64) + B * -(-rows_per_scale // 64) + -(-rows // 16) * F


def _cuda_bwd(saved: AttnSaved, dz: torch.Tensor, need_drs: bool, need_dextra: bool):
    """The backward kernel sequence: (dx, dg, db, dwqkv, dbqkv, dwout, dbout,
    drs, dextra_g)."""
    global BWD_LAUNCHES, BIAS_BWD_LAUNCHES, BF16_BWD_LAUNCHES, PACKED_BF16_BWD_LAUNCHES, \
        BF16_BIAS_BWD_LAUNCHES, PACKED_BF16_BIAS_BWD_LAUNCHES, PACKED_BF16_DBIAS_BWD_LAUNCHES
    x, g, b, wqkv, bqkv, wout, bout, rs = saved[:8]
    extra_g = saved.extra_g
    dz = dz.contiguous()
    if dz.shape != x.shape:
        raise ValueError(f"dz must be {tuple(x.shape)}, got {tuple(dz.shape)}")
    B, N, C = x.shape
    H = saved.n_head
    HD = wqkv.shape[1] // 3
    D = HD // H
    M = B * N
    bf16 = check_bf16_form(x, D, dict(ln_scale=g, ln_bias=b, row_scale=rs,
                                      extra=extra_g, mu=saved.mu, rstd=saved.rstd,
                                      lse=saved.lse),
                           wqkv=wqkv, bqkv=bqkv, wout=wout, bout=bout, dz=dz,
                           qkv=saved.qkv, acc=saved.acc)
    want_dextra = extra_g is not None and need_dextra
    if bf16 and want_dextra:
        check_bf16_dbias(N)
    from ._build import build

    lib = build()
    opts = dict(device=x.device, dtype=torch.float32)
    act = dict(device=x.device, dtype=x.dtype)  # the activations' workspace
    s_out, s_qkv = _splits(HD, C, M), _splits(C, 3 * HD, M)
    chunks = -(-M // 128)  # csrc COLSUM_ROWS
    groups = 1 if extra_g is None else extra_g.shape[0]
    if bf16:
        dq_part = bf16_attention_workspace(B, N, H, D, rs is not None, opts, groups,
                                           want_dextra)
        dbpart = None
    else:
        dq_part, dbpart = attention_workspace(B, groups, H, N, D, extra_g is not None,
                                              want_dextra, opts)
    ws = dict(
        dacc=torch.empty((M, HD), **act), dq_part=dq_part,
        dqkv=torch.empty((M, 3 * HD), **act), dln=torch.empty((M, C), **opts),
        dbpart=dbpart,
        wpart=torch.empty((max(s_out * HD * C, s_qkv * C * 3 * HD),), **opts),
        cpart=torch.empty((chunks * max(C, 3 * HD),), **opts))
    dx = torch.empty_like(x)
    dg, db = torch.empty((C,), **opts), torch.empty((C,), **opts)
    dwqkv, dwout = like_layout(wqkv), like_layout(wout)
    dbqkv = torch.empty((3 * HD,), **opts) if bqkv is not None else None
    dbout = torch.empty((C,), **opts) if bout is not None else None
    drs = torch.empty((B,), **opts) if rs is not None and need_drs else None
    dextra = torch.empty_like(extra_g) if want_dextra else None
    # the data gradients read each weight in place along its other axis (the
    # bf16 GEMM's TMA loads take it N-major)
    entry = lib.vtx_fused_attention_layer_bwd_bf16 if bf16 else lib.vtx_fused_attention_layer_bwd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        BWD_LAUNCHES += 1
        BIAS_BWD_LAUNCHES += extra_g is not None
        BF16_BWD_LAUNCHES += bf16
        PACKED_BF16_BWD_LAUNCHES += bf16
        BF16_BIAS_BWD_LAUNCHES += bf16 and extra_g is not None
        PACKED_BF16_BIAS_BWD_LAUNCHES += bf16 and extra_g is not None
        PACKED_BF16_DBIAS_BWD_LAUNCHES += bf16 and want_dextra
        err = entry(
            ptr(x), ptr(g), ptr(b),
            ptr(wqkv), wqkv.stride(0), wqkv.stride(1), ptr(bqkv),
            ptr(wout), wout.stride(0), wout.stride(1), ptr(bout),
            ptr(extra_g), groups,
            ptr(rs), ptr(saved.qkv), ptr(saved.acc), ptr(saved.mu),
            ptr(saved.rstd), ptr(saved.lse), ptr(dz),
            *(ptr(ws[k]) for k in ("dacc", "dq_part", "dqkv", "dln", "dbpart")),
            ptr(ws["wpart"]), s_out, s_qkv, ptr(ws["cpart"]),
            ptr(dx), ptr(dg), ptr(db),
            ptr(dwqkv), dwqkv.stride(0), dwqkv.stride(1), ptr(dbqkv),
            ptr(dwout), dwout.stride(0), dwout.stride(1), ptr(dbout), ptr(drs),
            ptr(dextra), B, N, C, H, D, ctypes.c_float(saved.scale), stream)
    _raise_on(err, "fused_attention_layer backward")
    # the weights' and biases' gradients, summed in f32, in their dtype
    return (dx, dg, db, cast_like(dwqkv, wqkv), cast_like(dbqkv, bqkv),
            cast_like(dwout, wout), cast_like(dbout, bout), drs, dextra)


def fused_attention_layer_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                              n_head: int, row_scale=None,
                              scale: Optional[float] = None, eps: float = 1e-6,
                              extra=None):
    """Training forward with saves: (out, :class:`AttnSaved`) — the kernel
    for a CUDA tensor, the plain version for a CPU one; ``extra`` in any of
    the three forms of :func:`extra_groups`."""
    scale = _default_scale(wqkv, n_head, scale)
    B, N, _ = x.shape
    extra_g, groups = extra_groups(extra, B, n_head, N)
    if x.is_cuda:
        out, res = _cuda_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head,
                             extra_g, groups, row_scale, scale, float(eps), save=True)
        return out, AttnSaved(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                              row_scale, *res, extra_g, n_head, scale, float(eps))
    if x.device.type == "cpu":
        return fused_attention_layer_fwd_reference(
            x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head, row_scale,
            scale, eps, extra_g)
    raise NotImplementedError(f"no fused_attention_layer for device {x.device}")


def fused_attention_layer_bwd(saved: AttnSaved, dz: torch.Tensor,
                              need_drs: bool = True, need_dextra: bool = True):
    """Backward on the saves of :func:`fused_attention_layer_fwd` — the
    kernel for a CUDA tensor, the plain version for a CPU one; dextra comes
    back in the grouped [G, H, N, N] form."""
    if dz.is_cuda:
        return _cuda_bwd(saved, dz, need_drs, need_dextra)
    if dz.device.type == "cpu":
        return fused_attention_layer_bwd_reference(saved, dz, need_drs, need_dextra)
    raise NotImplementedError(f"no fused_attention_layer backward for {dz.device}")


def packed_attention_reference(qkv, n_head: int, scale: Optional[float] = None,
                               extra=None):
    """(out [B, N, H·D], lse [B, H, N]) of the attention on packed qkv [B,
    N, 3·H·D] in plain torch, f32 scores plus the f32 bias ``extra`` (any
    form of :func:`extra_groups`, or None) and softmax, the normalised p
    rounded to qkv's dtype before P·V and out rounded once (the JAX
    kernel's points, fused_layer.py:139-148)."""
    B, N, HD3 = qkv.shape
    HD = HD3 // 3
    scale = 1.0 / math.sqrt(HD // n_head) if scale is None else float(scale)
    q, k, v = (_heads(qkv[..., i * HD:(i + 1) * HD], n_head) for i in range(3))
    s = _scores_bias(torch.einsum("bhnd,bhmd->bhnm", q, k) * scale,
                     extra_groups(extra, B, n_head, N)[0])
    p = _rb(torch.softmax(s, dim=-1), qkv.dtype)
    out = torch.einsum("bhnm,bhmd->bnhd", p, v).to(qkv.dtype).reshape(B, N, HD)
    return out, torch.logsumexp(s, dim=-1)


def _packed_checks(qkv, n_head, extra):
    """(B, N, D, the bias as contiguous f32 [G, H, N, N] or None, G) of a
    thin door's call."""
    if qkv.ndim != 3 or not qkv.is_contiguous() or qkv.shape[2] % (3 * n_head):
        raise ValueError(f"qkv must be a contiguous [B, N, 3·H·D], got {tuple(qkv.shape)}")
    B, N, HD3 = qkv.shape
    D = HD3 // 3 // n_head
    check_dtype(qkv.device, torch.bfloat16, qkv=qkv)
    if D > MAX_DIM_HEAD or D % 8:
        raise NotImplementedError(f"the bf16 attention takes heads a multiple of 8 up to "
                                  f"{MAX_DIM_HEAD} wide; got {D}")
    extra_g, groups = extra_groups(extra, B, n_head, N)
    check_extra(extra_g, n_head, N, D)
    check_dtype(qkv.device, torch.float32, extra=extra_g)
    return B, N, D, extra_g, groups


def packed_attention_bf16(qkv, n_head: int, scale: Optional[float] = None,
                          save: bool = True, extra=None):
    """The packed-row attention's bf16 form alone (B1's and B2's attention,
    csrc/attention_bf16_tma.cuh; the thin door chip_smoke.py times beside
    scaled_dot_product_attention): (out, lse or None) from bf16 qkv on the
    card, with the additive f32 bias ``extra`` in any form of
    :func:`extra_groups` (a CPU tensor: :func:`packed_attention_reference`).
    No model calls it."""
    global PACKED_BF16_LAUNCHES, PACKED_BF16_BIAS_LAUNCHES
    if qkv.device.type == "cpu":
        out, lse = packed_attention_reference(qkv, n_head, scale, extra)
        return out, lse if save else None
    B, N, D, extra_g, groups = _packed_checks(qkv, n_head, extra)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    from ._build import build

    lib = build()
    out = torch.empty((B, N, n_head * D), device=qkv.device, dtype=qkv.dtype)
    lse = torch.empty((B, n_head, N), device=qkv.device) if save else None
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        PACKED_BF16_LAUNCHES += 1
        PACKED_BF16_BIAS_LAUNCHES += extra_g is not None
        err = lib.vtx_packed_attention_fwd_bf16(ptr(qkv), ptr(extra_g), groups, ptr(out),
                                                ptr(lse), B, N, n_head, D,
                                                ctypes.c_float(scale), stream)
    _raise_on(err, "packed attention (bf16)")
    return out, lse


def packed_attention_bf16_bwd(qkv, out, lse, dout, n_head: int,
                              scale: Optional[float] = None, extra=None,
                              dbias: bool = False):
    """Its backward: dqkv (bf16) from the forward's out and lse and dout, P
    recomputed with the forward's ``extra``; with ``dbias`` (``extra``
    given, N ≤ ``MAX_BIAS_TOKENS``) also the bias's gradient in the grouped
    form [G, H, N, N] f32, (dqkv, dbias_g) (a CPU tensor:
    :func:`attention_bwd_reference`, rounding where the kernel rounds, its
    dS summed over each group's images)."""
    global PACKED_BF16_BWD_LAUNCHES, PACKED_BF16_BIAS_BWD_LAUNCHES, \
        PACKED_BF16_DBIAS_BWD_LAUNCHES
    if qkv.device.type == "cpu":
        B, N, HD3 = qkv.shape
        D = HD3 // 3 // n_head
        scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
        extra_g = extra_groups(extra, B, n_head, N)[0]
        dqkv, ds = attention_bwd_reference(qkv, out, lse, dout, n_head, scale, extra_g,
                                           dtype=qkv.dtype)
        if not dbias:
            return dqkv.to(qkv.dtype)
        G = extra_g.shape[0]
        return dqkv.to(qkv.dtype), ds.reshape(G, B // G, *ds.shape[1:]).sum(1)
    B, N, D, extra_g, groups = _packed_checks(qkv, n_head, extra)
    if dbias:
        if extra_g is None:
            raise ValueError("dbias needs the bias")
        check_bf16_dbias(N)
    check_dtype(qkv.device, torch.bfloat16, out=out, dout=dout)
    check_dtype(qkv.device, torch.float32, lse=lse)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    from ._build import build

    lib = build()
    dout = dout.contiguous()
    dqkv = torch.empty_like(qkv)
    opts = dict(device=qkv.device, dtype=torch.float32)
    ws = bf16_attention_workspace(B, N, n_head, D, False, opts, groups, dbias)
    dextra = torch.empty_like(extra_g) if dbias else None
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        PACKED_BF16_BWD_LAUNCHES += 1
        PACKED_BF16_BIAS_BWD_LAUNCHES += extra_g is not None
        PACKED_BF16_DBIAS_BWD_LAUNCHES += dbias
        err = lib.vtx_packed_attention_bwd_bf16(ptr(qkv), ptr(extra_g), groups, ptr(out),
                                                ptr(lse), ptr(dout), ptr(ws), ptr(dqkv),
                                                ptr(dextra), B, N, n_head, D,
                                                ctypes.c_float(scale), stream)
    _raise_on(err, "packed attention backward (bf16)")
    return (dqkv, dextra) if dbias else dqkv


class _FusedAttentionLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, extra, row_scale,
                n_head, scale, eps):
        out, saved = fused_attention_layer_fwd(x, ln_scale, ln_bias, wqkv, bqkv,
                                               wout, bout, n_head, row_scale,
                                               scale, eps, extra)
        ctx.save_for_backward(*saved[:N_SAVED_TENSORS])
        ctx.attrs = saved[N_SAVED_TENSORS:]
        ctx.extra = extra  # its form; the grouped copy is among the saves
        return out

    @staticmethod
    def backward(ctx, dz):
        saved = AttnSaved(*ctx.saved_tensors, *ctx.attrs)
        need = ctx.needs_input_grad
        *grads, dextra = fused_attention_layer_bwd(saved, dz, need[8], need[7])
        # each gradient in its input's dtype
        grads = [cast_like(d, t) for d, t in zip(grads, saved[:8])]
        return (*grads[:7], extra_grad(dextra, ctx.extra), grads[7], None, None, None)


def fused_attention_layer(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                          n_head: int, extra=None, row_scale=None,
                          scale: Optional[float] = None, eps: float = 1e-6):
    """Pre-LN attention residual branch, fused:
    ``x + row_scale ⊙ OutProj(MHSA(QkvProj(LN(x)) + extra))``,
    differentiable (in ``extra`` too, where it requires a gradient)."""
    scale = _default_scale(wqkv, n_head, scale)
    tensors = (x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, extra, row_scale)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return _FusedAttentionLayer.apply(*tensors, n_head, scale, float(eps))
    if x.is_cuda:
        B, N, _ = x.shape
        extra_g, groups = extra_groups(extra, B, n_head, N)
        return _cuda_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head, extra_g,
                         groups, row_scale, scale, float(eps), save=False)[0]
    if x.device.type == "cpu":
        return fused_attention_layer_reference(
            x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, n_head, extra,
            row_scale, scale, eps)
    raise NotImplementedError(f"no fused_attention_layer for device {x.device}")


# ---------------------------------------------------------------------------
# the FF residual branch: fused_ff_layer (B7)
# ---------------------------------------------------------------------------

# kernel launches through fused_ff_layer's wrappers, forward and backward
FF_LAUNCHES = 0
FF_BWD_LAUNCHES = 0

ACTIVATIONS = {"silu": 0, "gelu": 1}  # csrc ACT_SILU, ACT_GELU


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return h * torch.sigmoid(h)
    if kind == "gelu":  # tanh approximation (jax.nn.gelu default)
        return torch.nn.functional.gelu(h, approximate="tanh")
    raise ValueError(kind)


def _act_grad(h: torch.Tensor, kind: str) -> torch.Tensor:
    """d act / d h at h, f32 (the JAX package's ``_act_bwd``,
    ops/fused_layer.py:98-108)."""
    if kind == "silu":
        s = torch.sigmoid(h)
        return s + h * s * (1.0 - s)
    if kind == "gelu":
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (h + 0.044715 * h ** 3))
        dt = (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * h * h)
        return 0.5 * (1.0 + t) + 0.5 * h * dt
    raise ValueError(kind)


def ff_half_fwd_reference(z, ln2_scale, ln2_bias, w1, b1, w2, b2, rs_ff,
                          activation: str, eps: float):
    """The FF residual branch's plain training forward on z [B, ..., C]:
    (out, hid — the pre-activation —, mu2, rstd2 [B, ...])."""
    zf = z.float()
    mu2, rstd2 = _ln_stats(zf, eps)
    u2 = ((zf - mu2) * rstd2 * ln2_scale.float() + ln2_bias.float()).to(z.dtype)
    hid = _dot(u2, w1, z.dtype)
    if b1 is not None:
        hid = hid + b1
    af = _act(hid.float(), activation).to(z.dtype)
    out = _dot(af, w2, z.dtype)
    if b2 is not None:
        out = out + b2
    return _residual(z, out, rs_ff), hid, mu2[..., 0], rstd2[..., 0]


def ff_half_bwd_reference(z, ln2_scale, ln2_bias, w1, b1, w2, b2, rs_ff, hid, mu2,
                          rstd2, activation: str, do: torch.Tensor,
                          need_drs: bool = True):
    """The FF half's plain backward in the kernel's steps 1-5
    (csrc/fused_layer1_bwd.cu), on the branch input z [B, ..., C] (any token
    layout; rs_ff [B] per sample) and the saves of
    :func:`ff_half_fwd_reference`: → (dz [M, C] f32, dln2_scale, dln2_bias,
    dw1, db1, dw2, db2, drs_ff).  With z bf16 each step rounds where the
    JAX kernel and the bf16 kernels round (fused_layer1.py:221-276): af,
    r₂ ⊙ do (r₂ rounded first), da, dh, u₂ and dz's LN part and sum."""
    B, C = z.shape[0], z.shape[-1]
    M = z.numel() // C
    N = M // B
    f, dt = torch.float32, z.dtype
    do2 = do.reshape(M, C).to(f)
    hid = hid.reshape(M, -1).to(f)
    # 1. dff = r₂ ⊙ do; af = act(hid); dW₂ = afᵀ·dff; db₂ = Σ_rows dff
    rsr = None if rs_ff is None else rs_ff.to(f).repeat_interleave(N)[:, None]
    dff = do2 if rs_ff is None else _rb(do2 * _rb(rsr, dt), dt)
    af = _rb(_act(hid, activation), dt)
    dw2 = af.t() @ dff
    db2f = dff.sum(0) if b2 is not None else None
    # 2. da₀ = do·W₂ᵀ; dr₂ (reassociated); da = r₂ ⊙ da₀
    da = do2 @ w2.to(f).t()
    drs_ff = None
    if rs_ff is not None:
        if need_drs:
            per_row = (da * af).sum(1)
            if b2 is not None:
                per_row = per_row + do2 @ b2.to(f)
            drs_ff = per_row.reshape(B, N).sum(1).to(rs_ff.dtype)
        da = da * rsr
    # 3. dh = da ⊙ act'(hid)
    dh = _rb(_rb(da, dt) * _act_grad(hid, activation), dt)
    # 4. u₂ from the saved statistics; dW₁ = u₂ᵀ·dh; db₁ = Σ_rows dh
    xhat2 = (z.reshape(M, C).to(f) - mu2.reshape(M, 1)) * rstd2.reshape(M, 1)
    u2 = _rb(xhat2 * ln2_scale.to(f) + ln2_bias.to(f), dt)
    dw1 = u2.t() @ dh
    db1f = dh.sum(0) if b1 is not None else None
    # 5. dln₂ = dh·W₁ᵀ; dz = do + LN₂ᵀ(dln₂)
    dln2 = dh @ w1.to(f).t()
    dz, dg2, db2n = ln_bwd_reference(dln2, xhat2, rstd2.reshape(M, 1), ln2_scale, do2, dt)
    return (dz, cast_like(dg2, ln2_scale), cast_like(db2n, ln2_bias), cast_like(dw1, w1),
            cast_like(db1f, b1), cast_like(dw2, w2), cast_like(db2f, b2), drs_ff)


class FFSaved(NamedTuple):
    """What the FF backward reads: the forward's inputs and the saves hid
    [B, N, F] (the pre-activation) and mu / rstd [B, N]."""

    x: torch.Tensor
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    w1: torch.Tensor
    b1: Optional[torch.Tensor]
    w2: torch.Tensor
    b2: Optional[torch.Tensor]
    row_scale: Optional[torch.Tensor]
    hid: torch.Tensor
    mu: torch.Tensor
    rstd: torch.Tensor
    activation: str
    eps: float


N_FF_SAVED_TENSORS = 11  # FFSaved's tensor fields; the rest are attributes

FF_GRAD_NAMES = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2", "drs")


def fused_ff_layer_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                             activation: str = "silu", row_scale=None,
                             eps: float = 1e-6):
    """Plain torch version of :func:`fused_ff_layer` (forward)."""
    return ff_half_fwd_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, row_scale,
                                 activation, eps)[0]


def fused_ff_layer_fwd_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                 activation: str = "silu", row_scale=None,
                                 eps: float = 1e-6):
    """Plain training forward: (out, :class:`FFSaved`)."""
    out, hid, mu, rstd = ff_half_fwd_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                               row_scale, activation, eps)
    return out, FFSaved(x, ln_scale, ln_bias, w1, b1, w2, b2, row_scale, hid, mu,
                        rstd, activation, float(eps))


def fused_ff_layer_bwd_reference(saved: FFSaved, do: torch.Tensor,
                                 need_drs: bool = True):
    """Plain backward on the saves, in the kernel's steps: the 8 gradients
    of ``FF_GRAD_NAMES`` (a bias's or the row scale's None where it is, drs
    None unless ``need_drs``)."""
    s = saved
    dx, *grads = ff_half_bwd_reference(s.x, s.ln_scale, s.ln_bias, s.w1, s.b1, s.w2,
                                       s.b2, s.row_scale, s.hid, s.mu, s.rstd,
                                       s.activation, do, need_drs)
    return (dx.reshape(s.x.shape).to(s.x.dtype), *grads)


def _check_ff(x, ln_scale, ln_bias, w1, b1, w2, b2, row_scale, activation):
    """Shapes and types the CUDA FF op takes; returns (B, N, C, F)."""
    if activation not in ACTIVATIONS:
        raise NotImplementedError(
            f"the CUDA FF kernel takes activation 'silu' or 'gelu', got {activation!r}")
    check_f32(x.device, x=x, ln_scale=ln_scale, ln_bias=ln_bias, w1=w1, b1=b1, w2=w2,
              b2=b2, row_scale=row_scale)
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, N, C] tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, N, C = x.shape
    if w1.ndim != 2:
        raise ValueError(f"w1 must be [C, F], got {tuple(w1.shape)}")
    F = w1.shape[1]
    check_vector("ln_scale", ln_scale, C)
    check_vector("ln_bias", ln_bias, C)
    check_matrix("w1", w1, C, F)
    check_vector("b1", b1, F)
    check_matrix("w2", w2, F, C)
    check_vector("b2", b2, C)
    check_vector("row_scale", row_scale, B)
    return B, N, C, F


def _cuda_ff_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, activation, row_scale, eps,
                 save: bool):
    """The FF forward kernel: out, plus (hid, mu, rstd) when ``save``."""
    global FF_LAUNCHES
    B, N, C, F = _check_ff(x, ln_scale, ln_bias, w1, b1, w2, b2, row_scale, activation)
    from ._build import build

    lib = build()
    M = B * N
    opts = dict(device=x.device, dtype=torch.float32)
    u = torch.empty((M, C), **opts)
    hid = torch.empty((B, N, F), **opts)
    af = torch.empty((M, F), **opts) if save else None
    mu, rstd = (torch.empty((B, N), **opts), torch.empty((B, N), **opts)) if save \
        else (None, None)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        FF_LAUNCHES += 1
        err = lib.vtx_fused_ff_layer_fwd(
            ptr(x), ptr(ln_scale), ptr(ln_bias),
            ptr(w1), w1.stride(0), w1.stride(1), ptr(b1),
            ptr(w2), w2.stride(0), w2.stride(1), ptr(b2), ptr(row_scale),
            ptr(u), ptr(hid), ptr(af), ptr(mu), ptr(rstd), ptr(out),
            B, N, C, F, ACTIVATIONS[activation], ctypes.c_float(eps), stream)
    _raise_on(err, "fused_ff_layer")
    return out, (hid, mu, rstd)


def _cuda_ff_bwd(saved: FFSaved, do: torch.Tensor, need_drs: bool):
    """The FF backward kernel sequence: the 8 gradients of ``FF_GRAD_NAMES``."""
    global FF_BWD_LAUNCHES
    s = saved
    x = s.x
    do = do.contiguous()
    check_f32(x.device, do=do, hid=s.hid, mu=s.mu, rstd=s.rstd)
    if do.shape != x.shape:
        raise ValueError(f"do must be {tuple(x.shape)}, got {tuple(do.shape)}")
    B, N, C, F = _check_ff(x, s.ln_scale, s.ln_bias, s.w1, s.b1, s.w2, s.b2,
                           s.row_scale, s.activation)
    M = B * N
    from ._build import build

    lib = build()
    opts = dict(device=x.device, dtype=torch.float32)
    s_w1, s_w2 = _splits(C, F, M), _splits(F, C, M)
    chunks = -(-M // 128)  # csrc COLSUM_ROWS
    ws = dict(da=torch.empty((M, C), **opts) if s.row_scale is not None else None,
              af=torch.empty((M, F), **opts), dh=torch.empty((M, F), **opts),
              u=torch.empty((M, C), **opts), dln=torch.empty((M, C), **opts),
              wpart=torch.empty((max(s_w1, s_w2) * C * F,), **opts),
              cpart=torch.empty((chunks * max(C, F),), **opts))
    dx = torch.empty_like(x)
    dg, db = torch.empty((C,), **opts), torch.empty((C,), **opts)
    dw1, dw2 = like_layout(s.w1), like_layout(s.w2)
    db1 = torch.empty((F,), **opts) if s.b1 is not None else None
    db2 = torch.empty((C,), **opts) if s.b2 is not None else None
    drs = torch.empty((B,), **opts) if s.row_scale is not None and need_drs else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        FF_BWD_LAUNCHES += 1
        err = lib.vtx_fused_ff_layer_bwd(
            ptr(x), ptr(s.ln_scale), ptr(s.ln_bias),
            ptr(s.w1), s.w1.stride(0), s.w1.stride(1), ptr(s.b1),
            ptr(s.w2), s.w2.stride(0), s.w2.stride(1), ptr(s.b2),
            ptr(s.row_scale), ptr(s.hid), ptr(s.mu), ptr(s.rstd), ptr(do),
            *(ptr(ws[k]) for k in ("da", "af", "dh", "u", "dln", "wpart")),
            s_w1, s_w2, ptr(ws["cpart"]),
            ptr(dx), ptr(dg), ptr(db),
            ptr(dw1), dw1.stride(0), dw1.stride(1), ptr(db1),
            ptr(dw2), dw2.stride(0), dw2.stride(1), ptr(db2), ptr(drs),
            B, N, C, F, ACTIVATIONS[s.activation], stream)
    _raise_on(err, "fused_ff_layer backward")
    return dx, dg, db, dw1, db1, dw2, db2, drs


def fused_ff_layer_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, activation: str = "silu",
                       row_scale=None, eps: float = 1e-6):
    """Training forward with saves: (out, :class:`FFSaved`) — the kernel for
    a CUDA tensor, the plain version for a CPU one."""
    if x.is_cuda:
        out, (hid, mu, rstd) = _cuda_ff_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                            activation, row_scale, float(eps), save=True)
        return out, FFSaved(x, ln_scale, ln_bias, w1, b1, w2, b2, row_scale, hid, mu,
                            rstd, activation, float(eps))
    if x.device.type == "cpu":
        return fused_ff_layer_fwd_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                            activation, row_scale, eps)
    raise NotImplementedError(f"no fused_ff_layer for device {x.device}")


def fused_ff_layer_bwd(saved: FFSaved, do: torch.Tensor, need_drs: bool = True):
    """Backward on the saves of :func:`fused_ff_layer_fwd` — the kernel for
    a CUDA tensor, the plain version for a CPU one."""
    if do.is_cuda:
        return _cuda_ff_bwd(saved, do, need_drs)
    if do.device.type == "cpu":
        return fused_ff_layer_bwd_reference(saved, do, need_drs)
    raise NotImplementedError(f"no fused_ff_layer backward for {do.device}")


class _FusedFFLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, row_scale, activation, eps):
        out, saved = fused_ff_layer_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                        activation, row_scale, eps)
        ctx.save_for_backward(*saved[:N_FF_SAVED_TENSORS])
        ctx.attrs = saved[N_FF_SAVED_TENSORS:]
        return out

    @staticmethod
    def backward(ctx, do):
        saved = FFSaved(*ctx.saved_tensors, *ctx.attrs)
        grads = fused_ff_layer_bwd(saved, do, ctx.needs_input_grad[7])
        return (*grads, None, None)


def fused_ff_layer(x, ln_scale, ln_bias, w1, b1, w2, b2, activation: str = "silu",
                   row_scale=None, eps: float = 1e-6):
    """Pre-LN feed-forward residual branch, fused:
    ``x + row_scale ⊙ (act(LN(x)·W₁ + b₁)·W₂ + b₂)``, differentiable; x
    [B, N, C], w1 [C, F], w2 [F, C], b1 / b2 / row_scale [B] optional,
    activation "silu" | "gelu" (tanh approximation)."""
    tensors = (x, ln_scale, ln_bias, w1, b1, w2, b2, row_scale)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return _FusedFFLayer.apply(*tensors, activation, float(eps))
    if x.is_cuda:
        return _cuda_ff_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, activation,
                            row_scale, float(eps), save=False)[0]
    if x.device.type == "cpu":
        return fused_ff_layer_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                        activation, row_scale, eps)
    raise NotImplementedError(f"no fused_ff_layer for device {x.device}")
