"""The attention block, forward and backward:

    out = softmax((x·Wqkv + bqkv) split heads → q·kᵀ·scale + extra)·v
          → concat heads · Wout + bout

Counterpart of ``vision_transformers_tpu/ops/fused_block.py::
fused_attention_block``, same signature and layouts: x [B, N, C], wqkv
[C, 3·H·D] laid out q-heads | k-heads | v-heads, wout [H·D, Cout], bqkv and
bout optional, ``extra`` an optional additive bias in the forms of the JAX
``_extra_form`` (fused_block.py:233-245): [N, N], [1, N, N] or [H, N, N]
shared by every row, or [G, H, N, N] grouped over G contiguous row groups
(Swin's window-major rows).  No LayerNorm, no residual: ViT's and Swin's
attention under ``ops.set_attention_impl("block")``, with LN, the residuals,
DropPath and dropout outside.

A call that needs gradients goes through a ``torch.autograd.Function``
whose forward keeps the packed projection qkv, the attention output acc and
the softmax log-sum-exp lse [B, H, N] (the Pallas backward recomputes them);
its backward returns dx, dWqkv, dbqkv, dWout, dbout and the bias's gradient
un-broadcast to the caller's form (fused_block.py:340-352), None where the
input was None.

A CPU tensor runs the plain torch versions, :func:`block_fwd_reference` and
:func:`block_bwd_reference` (f32 products, the packed-qkv attention's plain
versions in between).  A CUDA tensor runs the hand-written kernels of
``csrc/fused_attention_qkv.cu`` — forward: the GEMM core (``csrc/gemm_tc.cu``,
3xTF32 on the tensor cores) with the qkv bias, the packed-qkv attention of
``csrc/attention_tc.cuh`` (B3's, 3xTF32) with lse, the GEMM core with the
out bias; backward: split-K weight gradients summed in order, the
attention's backward with its dq partials summed in key-tile order and dS
summed per group in row order, no float atomics — or raises; it never falls
back to the plain versions.  The kernels take float32 and heads up to
``MAX_DIM_HEAD`` (64) wide, with or without the bias; anything else on a
CUDA tensor raises NotImplementedError.  The weights may be any 2-D strided
view (the models pass ``linear.weight.t()``); their gradients come back in
the view's layout.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from .fused_attention import qkv_attention_bwd_reference, qkv_attention_fwd_reference
from .fused_layer import (MAX_DIM_HEAD, _raise_on, _splits, cast_like, check_f32,
                          check_matrix, check_vector, dq_partials, extra_grad, extra_groups,
                          like_layout, ptr)

__all__ = ["fused_attention_block", "fused_attention_block_reference",
           "fused_attention_block_fwd", "fused_attention_block_bwd", "block_fwd_reference",
           "block_bwd_reference", "BlockSaved", "GRAD_NAMES", "BLOCK_LAUNCHES",
           "BLOCK_BWD_LAUNCHES"]

# kernel launches through this module's wrappers, forward and backward
# (chip_smoke.py reads them to show the main path went through the kernels)
BLOCK_LAUNCHES = 0
BLOCK_BWD_LAUNCHES = 0

GRAD_NAMES = ("dx", "dwqkv", "dbqkv", "dwout", "dbout", "dextra")


def _default_scale(wqkv, n_head, scale):
    return 1.0 / math.sqrt(wqkv.shape[1] // 3 // n_head) if scale is None else float(scale)


def _linear(a, w, b):
    """a [..., K] · w [K, N] (+ b), f32."""
    out = a.float() @ w.float()
    return out if b is None else out + b.float()


def block_fwd_reference(x, wqkv, bqkv, wout, bout, n_head: int, extra_g, scale: float):
    """Plain forward with the saves, f32: → (out [B, N, Cout] in x's dtype,
    qkv [B, N, 3·H·D], acc [B, N, H·D], lse [B, H, N]); ``extra_g`` the
    grouped bias [G, H, N, N] or None."""
    qkv = _linear(x, wqkv, bqkv)
    acc, lse = qkv_attention_fwd_reference(qkv, n_head, extra_g, scale)
    return _linear(acc, wout, bout).to(x.dtype), qkv, acc, lse


def fused_attention_block_reference(x, wqkv, bqkv, wout, bout, n_head: int, extra=None,
                                    scale: Optional[float] = None):
    """Plain torch version of :func:`fused_attention_block` (forward)."""
    scale = _default_scale(wqkv, n_head, scale)
    extra_g, _ = extra_groups(extra, x.shape[0], n_head, x.shape[1])
    return block_fwd_reference(x, wqkv, bqkv, wout, bout, n_head, extra_g, scale)[0]


class BlockSaved(NamedTuple):
    """What the backward reads: the forward's inputs, the bias in its
    grouped [G, H, N, N] f32 form (or None), qkv, acc and lse."""

    x: torch.Tensor
    wqkv: torch.Tensor
    bqkv: Optional[torch.Tensor]
    wout: torch.Tensor
    bout: Optional[torch.Tensor]
    extra_g: Optional[torch.Tensor]
    qkv: torch.Tensor
    acc: torch.Tensor
    lse: torch.Tensor
    n_head: int
    scale: float


N_SAVED_TENSORS = 9  # BlockSaved's tensor fields; the rest are attributes


def block_bwd_reference(saved: BlockSaved, do: torch.Tensor, need_dextra: bool = True):
    """Plain backward in the kernels' steps, f32: dWout = accᵀ·do, dbout =
    Σ_rows do, dacc = do·Woutᵀ, the packed-qkv attention's plain backward
    (dqkv, dextra summed per group), dWqkv = xᵀ·dqkv, dbqkv = Σ_rows dqkv,
    dx = dqkv·Wqkvᵀ: → (dx, dwqkv, dbqkv, dwout, dbout, dextra_g), a bias's
    gradient None where the bias is, dextra_g None without the bias or
    ``need_dextra``."""
    x, wqkv, bqkv, wout, bout, extra_g = saved[:6]
    B, N, C = x.shape
    M = B * N
    do2 = do.reshape(M, -1).float()
    acc2 = saved.acc.reshape(M, -1).float()
    dwout = acc2.t() @ do2
    dbout = do2.sum(0) if bout is not None else None
    dacc = (do2 @ wout.float().t()).reshape(saved.acc.shape)
    dqkv, dextra_g = qkv_attention_bwd_reference(saved.qkv, saved.n_head, extra_g, dacc,
                                                 saved.scale, need_dextra)
    dqkv2 = dqkv.reshape(M, -1).float()
    dwqkv = x.reshape(M, C).float().t() @ dqkv2
    dbqkv = dqkv2.sum(0) if bqkv is not None else None
    dx = (dqkv2 @ wqkv.float().t()).reshape(x.shape).to(x.dtype)
    return (dx, cast_like(dwqkv, wqkv), cast_like(dbqkv, bqkv), cast_like(dwout, wout),
            cast_like(dbout, bout), dextra_g)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def _check(x, wqkv, bqkv, wout, bout, n_head, extra_g):
    """Shapes, layouts and limits the kernels take; returns (B, N, C, H, D,
    Cout)."""
    check_f32(x.device, x=x, wqkv=wqkv, bqkv=bqkv, wout=wout, bout=bout, extra=extra_g)
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, N, C] tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, N, C = x.shape
    if wqkv.ndim != 2 or wqkv.shape[1] % (3 * n_head) or wout.ndim != 2:
        raise ValueError(f"wqkv must be [C, 3·H·D] with H={n_head} and wout [H·D, Cout]; "
                         f"got {tuple(wqkv.shape)}, {tuple(wout.shape)}")
    HD = wqkv.shape[1] // 3
    D, Cout = HD // n_head, wout.shape[1]
    check_matrix("wqkv", wqkv, C, 3 * HD)
    check_vector("bqkv", bqkv, 3 * HD)
    check_matrix("wout", wout, HD, Cout)
    check_vector("bout", bout, Cout)
    if D > MAX_DIM_HEAD:
        raise NotImplementedError(
            f"the CUDA fused_attention_block holds heads up to {MAX_DIM_HEAD} wide; got "
            f"{D} (ROADMAP B)")
    if extra_g is not None:
        if extra_g.ndim != 4 or tuple(extra_g.shape[1:]) != (n_head, N, N) \
                or B % extra_g.shape[0] or not extra_g.is_contiguous():
            raise ValueError(f"extra must be a contiguous [G, {n_head}, {N}, {N}] with "
                             f"G dividing {B}, got {tuple(extra_g.shape)}")
    return B, N, C, n_head, D, Cout


def _groups(extra_g) -> int:
    return 1 if extra_g is None else extra_g.shape[0]


def _cuda_fwd(x, wqkv, bqkv, wout, bout, n_head, extra_g, scale, save: bool):
    """The forward kernels: out, and (qkv, acc, lse) — the workspace the
    launch writes, lse None unless ``save``."""
    global BLOCK_LAUNCHES
    B, N, C, H, D, Cout = _check(x, wqkv, bqkv, wout, bout, n_head, extra_g)
    from ._build import build

    lib = build()
    opts = dict(device=x.device, dtype=torch.float32)
    qkv = torch.empty((B, N, 3 * H * D), **opts)
    acc = torch.empty((B, N, H * D), **opts)
    lse = torch.empty((B, H, N), **opts) if save else None
    out = torch.empty((B, N, Cout), **opts)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        BLOCK_LAUNCHES += 1
        err = lib.vtx_fused_attention_block_fwd(
            ptr(x), ptr(wqkv), wqkv.stride(0), wqkv.stride(1), ptr(bqkv),
            ptr(wout), wout.stride(0), wout.stride(1), ptr(bout),
            ptr(extra_g), _groups(extra_g), ptr(qkv), ptr(acc), ptr(lse), ptr(out),
            B, N, C, H, D, Cout, ctypes.c_float(scale), stream)
    _raise_on(err, "fused_attention_block")
    return out, (qkv, acc, lse)


def _cuda_bwd(saved: BlockSaved, do: torch.Tensor, need_dextra: bool):
    """The backward kernel sequence: (dx, dwqkv, dbqkv, dwout, dbout,
    dextra_g or None)."""
    global BLOCK_BWD_LAUNCHES
    x, wqkv, bqkv, wout, bout, extra_g = saved[:6]
    do = do.contiguous()
    B, N, C, H, D, Cout = _check(x, wqkv, bqkv, wout, bout, saved.n_head, extra_g)
    check_f32(x.device, do=do, qkv=saved.qkv, acc=saved.acc, lse=saved.lse)
    if tuple(do.shape) != (B, N, Cout):
        raise ValueError(f"do must be [{B}, {N}, {Cout}], got {tuple(do.shape)}")
    M, HD = B * N, H * D
    want_dextra = extra_g is not None and need_dextra
    s_out, s_qkv = _splits(HD, Cout, M), _splits(C, 3 * HD, M)
    chunks = -(-M // 128)  # csrc COLSUM_ROWS
    from ._build import build

    lib = build()
    opts = dict(device=x.device, dtype=torch.float32)
    dacc = torch.empty((M, HD), **opts)
    dq_part = dq_partials(N, M, HD, opts)
    dqkv = torch.empty((M, 3 * HD), **opts)
    dsbuf = torch.empty((B, H, N, N), **opts) if want_dextra else None
    wpart = torch.empty((max(s_out * HD * Cout, s_qkv * C * 3 * HD),), **opts)
    cpart = torch.empty((chunks * max(Cout, 3 * HD),), **opts)
    dx = torch.empty_like(x)
    dwqkv, dwout = like_layout(wqkv), like_layout(wout)
    dbqkv = torch.empty((3 * HD,), **opts) if bqkv is not None else None
    dbout = torch.empty((Cout,), **opts) if bout is not None else None
    dextra = torch.empty_like(extra_g) if want_dextra else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        BLOCK_BWD_LAUNCHES += 1
        err = lib.vtx_fused_attention_block_bwd(
            ptr(x), ptr(wqkv), wqkv.stride(0), wqkv.stride(1),
            ptr(wout), wout.stride(0), wout.stride(1), ptr(extra_g), _groups(extra_g),
            ptr(saved.qkv), ptr(saved.acc), ptr(saved.lse), ptr(do),
            ptr(dacc), ptr(dq_part), ptr(dqkv), ptr(dsbuf), ptr(wpart), s_out, s_qkv,
            ptr(cpart), ptr(dx), ptr(dwqkv), dwqkv.stride(0), dwqkv.stride(1), ptr(dbqkv),
            ptr(dwout), dwout.stride(0), dwout.stride(1), ptr(dbout), ptr(dextra),
            B, N, C, H, D, Cout, ctypes.c_float(saved.scale), stream)
    _raise_on(err, "fused_attention_block backward")
    return dx, dwqkv, dbqkv, dwout, dbout, dextra


def fused_attention_block_fwd(x, wqkv, bqkv, wout, bout, n_head: int, extra=None,
                              scale: Optional[float] = None):
    """Training forward with saves: (out, :class:`BlockSaved`) — the kernels
    for a CUDA tensor, the plain version for a CPU one; ``extra`` in any of
    the forms of :func:`fused_attention_block`."""
    scale = _default_scale(wqkv, n_head, scale)
    extra_g, _ = extra_groups(extra, x.shape[0], n_head, x.shape[1])
    if x.is_cuda:
        out, res = _cuda_fwd(x, wqkv, bqkv, wout, bout, n_head, extra_g, scale, save=True)
    elif x.device.type == "cpu":
        out, *res = block_fwd_reference(x, wqkv, bqkv, wout, bout, n_head, extra_g, scale)
    else:
        raise NotImplementedError(f"no fused_attention_block for device {x.device}")
    return out, BlockSaved(x, wqkv, bqkv, wout, bout, extra_g, *res, n_head, scale)


def fused_attention_block_bwd(saved: BlockSaved, do: torch.Tensor, need_dextra: bool = True):
    """Backward on the saves of :func:`fused_attention_block_fwd` — the
    kernels for a CUDA tensor, the plain version for a CPU one; dextra in
    the grouped [G, H, N, N] form."""
    if do.is_cuda:
        return _cuda_bwd(saved, do, need_dextra)
    if do.device.type == "cpu":
        return block_bwd_reference(saved, do, need_dextra)
    raise NotImplementedError(f"no fused_attention_block backward for {do.device}")


class _FusedAttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wout, bout, extra, n_head, scale):
        out, saved = fused_attention_block_fwd(x, wqkv, bqkv, wout, bout, n_head, extra,
                                               scale)
        ctx.save_for_backward(*saved[:N_SAVED_TENSORS])
        ctx.attrs = saved[N_SAVED_TENSORS:]
        ctx.extra = extra  # its form; the grouped copy is among the saves
        return out

    @staticmethod
    def backward(ctx, do):
        saved = BlockSaved(*ctx.saved_tensors, *ctx.attrs)
        *grads, dextra = fused_attention_block_bwd(saved, do, ctx.needs_input_grad[5])
        return (*grads, extra_grad(dextra, ctx.extra), None, None)


def fused_attention_block(x, wqkv, bqkv, wout, bout, n_head: int, extra=None,
                          scale: Optional[float] = None):
    """qkv projection + multi-head attention (+ the additive bias ``extra``)
    + out projection, the JAX ``fused_attention_block`` (fused_block.py:358):
    x [B, N, C] → [B, N, Cout]; differentiable in every tensor input."""
    scale = _default_scale(wqkv, n_head, scale)
    tensors = (x, wqkv, bqkv, wout, bout, extra)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return _FusedAttentionBlock.apply(*tensors, n_head, scale)
    if x.is_cuda:
        extra_g, _ = extra_groups(extra, x.shape[0], n_head, x.shape[1])
        return _cuda_fwd(x, wqkv, bqkv, wout, bout, n_head, extra_g, scale, save=False)[0]
    if x.device.type == "cpu":
        return fused_attention_block_reference(x, wqkv, bqkv, wout, bout, n_head, extra,
                                               scale)
    raise NotImplementedError(f"no fused_attention_block for device {x.device}")
