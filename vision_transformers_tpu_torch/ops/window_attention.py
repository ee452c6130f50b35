"""The tensor-core window attention of the port's hand-written kernels
(``csrc/window_attention_tc.cuh``), called alone.

The attention inside the attention layer B1 (with a bias: Twins-SVT), the
whole layer B2 and the map-resident Swin layer B9 runs on this one kernel,
reached from their C entries.  The models never call these functions: they
are the thin door through which chip_smoke.py's phase 3a and the
``cuda``-marked tests hold the kernel against its plain version and time it.

    out[p, i] = softmax_j(q_i·k_jᵀ·scale + bias[g(p), h, i, j])·v_j

over the N ≤ 128 tokens of window p, q / k / v the packed rows p·N … of
``qkv`` [P·N, 3·H·D] (q-heads | k-heads | v-heads), heads up to 32 wide, the
bias [G, H, N, N]; g(p) = p // (P/G), or p mod G when ``cyclic`` (B9's
sample-major pairs).  The forward returns out [P·N, H·D] and lse [P, H, N];
the backward dqkv and the bias's gradient, dS summed per block over a chunk
of each group's windows and the partials in chunk order: bit-identical from
run to run.  A CPU tensor runs the plain versions; a CUDA tensor runs the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .fused_layer import (MAX_BIAS_DIM_HEAD, MAX_BIAS_TOKENS, _raise_on, bias_partials,
                          check_f32, ptr)

__all__ = ["window_attention_fwd", "window_attention_bwd",
           "window_attention_fwd_reference", "window_attention_bwd_reference",
           "WINDOW_LAUNCHES", "WINDOW_BWD_LAUNCHES"]

# kernel launches through this door (only chip_smoke.py's phase 3a and the
# card's tests call it; the ops' own launches of the kernel are theirs)
WINDOW_LAUNCHES = 0
WINDOW_BWD_LAUNCHES = 0


def _groups_of(P: int, G: int, cyclic: bool, device) -> torch.Tensor:
    p = torch.arange(P, device=device)
    return p % G if cyclic else p // (P // G)


def _split(qkv: torch.Tensor, P: int, N: int, H: int):
    """q, k, v [P, H, N, D] of the packed rows."""
    return qkv.view(P, N, 3, H, -1).permute(2, 0, 3, 1, 4).unbind(0)


def window_attention_fwd_reference(qkv, bias, n_head: int, scale: float,
                                   cyclic: bool = False):
    """Plain f32 version of :func:`window_attention_fwd`: (out, lse)."""
    G, H, N, _ = bias.shape
    P = qkv.shape[0] // N
    q, k, v = _split(qkv.float(), P, N, n_head)
    s = torch.einsum("phnd,phmd->phnm", q, k) * scale
    s = s + bias.float()[_groups_of(P, G, cyclic, qkv.device)]
    out = torch.einsum("phnm,phmd->pnhd", s.softmax(-1), v)
    return out.reshape(P * N, -1), s.logsumexp(-1)


def window_attention_bwd_reference(qkv, bias, dout, n_head: int, scale: float,
                                   cyclic: bool = False, need_dbias: bool = True):
    """Plain f32 backward of the forward above: (dqkv, dbias or None)."""
    G, H, N, _ = bias.shape
    P = qkv.shape[0] // N
    with torch.enable_grad():
        x = qkv.detach().float().requires_grad_()
        b = bias.detach().float().requires_grad_(need_dbias)
        out, _ = window_attention_fwd_reference(x, b, n_head, scale, cyclic)
        grads = torch.autograd.grad(out, (x, b) if need_dbias else (x,), dout.float())
    return grads[0], (grads[1] if need_dbias else None)


def _check(qkv, bias, n_head: int):
    if bias.ndim != 4 or bias.shape[2] != bias.shape[3] or bias.shape[1] != n_head:
        raise ValueError(f"bias must be [G, {n_head}, N, N], got {tuple(bias.shape)}")
    G, H, N, _ = bias.shape
    if qkv.ndim != 2 or qkv.shape[0] % N or qkv.shape[1] % (3 * H):
        raise ValueError(f"qkv must be [P·{N}, 3·{H}·D], got {tuple(qkv.shape)}")
    P, D = qkv.shape[0] // N, qkv.shape[1] // (3 * H)
    if P % G:
        raise ValueError(f"{P} windows do not split into {G} groups")
    if D > MAX_BIAS_DIM_HEAD or N > MAX_BIAS_TOKENS:
        raise NotImplementedError(
            f"the CUDA kernel takes heads up to {MAX_BIAS_DIM_HEAD} wide and windows of "
            f"up to {MAX_BIAS_TOKENS} tokens; got {D} and {N}")
    if not (qkv.is_contiguous() and bias.is_contiguous()):
        raise ValueError("qkv and bias must be contiguous")
    return P, G, N, H, D


def _cuda_fwd(qkv, bias, n_head: int, scale: float, cyclic: bool, save_lse: bool):
    global WINDOW_LAUNCHES
    check_f32(qkv.device, qkv=qkv, bias=bias)
    P, G, N, H, D = _check(qkv, bias, n_head)
    from ._build import build

    lib = build()
    opts = dict(device=qkv.device, dtype=torch.float32)
    out = torch.empty((P * N, H * D), **opts)
    lse = torch.empty((P, H, N), **opts) if save_lse else None
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        WINDOW_LAUNCHES += 1
        err = lib.vtx_window_attention_fwd(ptr(qkv), ptr(bias), G, int(cyclic), ptr(out),
                                           ptr(lse), P, N, H, D, ctypes.c_float(scale),
                                           stream)
    _raise_on(err, "window_attention")
    return out, lse


def _cuda_bwd(qkv, bias, out, lse, dout, n_head: int, scale: float, cyclic: bool,
              need_dbias: bool):
    global WINDOW_BWD_LAUNCHES
    check_f32(qkv.device, qkv=qkv, bias=bias, out=out, lse=lse, dout=dout)
    P, G, N, H, D = _check(qkv, bias, n_head)
    if out.shape != (P * N, H * D) or dout.shape != out.shape or lse.shape != (P, H, N):
        raise ValueError("out / dout must be [P·N, H·D] and lse [P, H, N]")
    from ._build import build

    lib = build()
    dout = dout.contiguous()
    opts = dict(device=qkv.device, dtype=torch.float32)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias) if need_dbias else None
    part = bias_partials(P, G, H, N, opts) if need_dbias else None
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        WINDOW_BWD_LAUNCHES += 1
        err = lib.vtx_window_attention_bwd(
            ptr(qkv), ptr(out), ptr(dout), ptr(lse), ptr(bias), G, int(cyclic),
            ptr(dqkv), ptr(part), ptr(dbias), P, N, H, D, ctypes.c_float(scale), stream)
    _raise_on(err, "window_attention backward")
    return dqkv, dbias


def window_attention_fwd(qkv: torch.Tensor, bias: torch.Tensor, n_head: int, scale: float,
                         cyclic: bool = False, save_lse: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out [P·N, H·D], lse [P, H, N] or None)."""
    if qkv.device.type == "cpu":
        out, lse = window_attention_fwd_reference(qkv, bias, n_head, scale, cyclic)
        return out, (lse if save_lse else None)
    return _cuda_fwd(qkv, bias, n_head, scale, cyclic, save_lse)


def window_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor, out: torch.Tensor,
                         lse: torch.Tensor, dout: torch.Tensor, n_head: int, scale: float,
                         cyclic: bool = False, need_dbias: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dqkv [P·N, 3·H·D], dbias [G, H, N, N] or None)."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, bias, dout, n_head, scale, cyclic,
                                              need_dbias)
    return _cuda_bwd(qkv, bias, out, lse, dout, n_head, scale, cyclic, need_dbias)
