"""The tensor-core window attention (csrc/window_attention_tc.cuh: the
attention of the attention layer B1 with a bias, the whole layer B2 and the
map-resident Swin layer B9), checked on the CPU.

The kernel takes every product on the tensor cores in 3xTF32 with the halo
kernels' split: hi = ``cvt.rna.tf32.f32`` (10 mantissa bits, to nearest,
ties away from zero), lo = x − hi passed unrounded and truncated to TF32 by
the tensor core; a product is lo·hi + hi·lo + hi·hi.  Here torch emulates
those operands and runs the kernel's steps in its order: the forward's
one-pass softmax (all of a window's keys resident: the max, exp, sum, P·V
normalised after the product, lse = m + log l); the backward from lse (Δ =
rowsum(do ⊙ out), S and dP recomputed, dS = P ⊙ (dP − Δ), dq / dk / dv
complete inside the window) with the bias's gradient summed per chunk of a
group's windows in window order and the chunks' partials summed in chunk
order.  At Swin-S stage 1's heads over a few window pairs (98 tokens, the
pair mask and the shift mask, 2 groups), stage 4's single windows (49
tokens, one group) and chip_smoke's SWIN_ODD (18 tokens, heads 24 wide), in
both group layouts (B2's group-major windows, B9's sample-major pairs), with
q, k, v of std 1 and of std 3, the emulation holds chip_smoke.py's limits
against the port's f32 plain version (forward atol = rtol = 1e-4, backward
1e-3·max(1, max|plain|) per tensor).  The wrappers of B1, B2 and B9 and the
kernel's own thin door are driven through ctypes callbacks of the declared
signatures: the bias calls pass the dbias partials [chunks, G, H, N, N] and
no [P, H, N, N] dS buffer.
"""

import contextlib
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch.models.swin import WindowAttention
from vision_transformers_tpu_torch.ops import _build
from vision_transformers_tpu_torch.ops import fused_layer, fused_layer1, fused_swin
from vision_transformers_tpu_torch.ops import window_attention as wa
from torch_port_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-4  # chip_smoke.KERNEL_TOL
HEADER = (Path(__file__).resolve().parent.parent / "vision_transformers_tpu_torch" / "csrc"
          / "window_attention_tc.cuh")

# name → (WindowAttention's C, H, D, map size, window, shift, windows P)
CASES = {
    "swin_s_stage1": (96, 3, 32, (14, 14), 7, True, 6),   # 98 tokens, 2 groups
    "swin_s_stage4": (64, 2, 32, (7, 7), 7, False, 3),    # 49 tokens, 1 group
    "swin_odd": (48, 2, 24, (6, 6), 3, True, 6),          # 18 tokens, 2 groups
}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded as cvt.rna.tf32.f32 rounds it."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a TF32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b in 3xTF32 with the kernel's split (lo truncated), small terms
    first."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = truncated(a - a_hi), truncated(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def case_inputs(name, std=1.0, seed=0):
    """qkv [P·N, 3·H·D] of std ``std``, dout [P·N, H·D] of std 1 and the
    port's WindowAttention grouped bias (a std-0.2 table, the pair mask,
    the shift mask on a shifted layer) [G, H, N, N]; H, D."""
    C, H, D, size, window, shift, P = CASES[name]
    attn = WindowAttention(C, H, D, size, window, shift=shift)
    with torch.no_grad():
        attn.rel_pos.weight.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(seed))
        bias = attn.grouped_bias().float().contiguous()
    N = bias.shape[-1]
    rng = np.random.default_rng([seed, N, D])

    def n(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))

    return n(P * N, 3 * H * D, s=std), n(P * N, H * D), bias, H, D


def groups_of(P, G, cyclic):
    p = torch.arange(P)
    return p % G if cyclic else p // (P // G)


def heads(qkv, P, N, H):
    """q, k, v [P, H, N, D]."""
    return qkv.view(P, N, 3, H, -1).permute(2, 0, 3, 1, 4).unbind(0)


def kernel_fwd(qkv, bias, H, scale, cyclic):
    """The kernel's forward, emulated: (out [P·N, H·D], lse [P, H, N])."""
    G, _, N, _ = bias.shape
    P = qkv.shape[0] // N
    q, k, v = heads(qkv, P, N, H)
    s = mm3(q, k.transpose(-1, -2)) * scale + bias[groups_of(P, G, cyclic)]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    out = mm3(p, v) / l
    return out.permute(0, 2, 1, 3).reshape(P * N, -1), (m + torch.log(l))[..., 0]


def kernel_bwd(qkv, bias, out, lse, dout, H, scale, cyclic, chunks=None):
    """The kernel's backward, emulated: (dqkv, dbias), dbias summed over
    each chunk of a group's windows in window order, then over the chunks
    in chunk order (``chunks`` defaults to the kernel's rule)."""
    G, _, N, _ = bias.shape
    P = qkv.shape[0] // N
    q, k, v = heads(qkv, P, N, H)
    do = dout.view(P, N, H, -1).permute(0, 2, 1, 3)
    o = out.view(P, N, H, -1).permute(0, 2, 1, 3)
    s = mm3(q, k.transpose(-1, -2)) * scale + bias[groups_of(P, G, cyclic)]
    p = torch.exp(s - lse[..., None])
    dp = mm3(do, v.transpose(-1, -2))
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    dss = ds * scale
    dq, dk, dv = mm3(dss, k), mm3(dss.transpose(-1, -2), q), mm3(p.transpose(-1, -2), do)
    dqkv = torch.stack([dq, dk, dv], 2).permute(0, 3, 2, 1, 4).reshape(P * N, -1)
    R = P // G
    chunks = chunks or fused_layer.window_chunks(P, G, H)
    per = -(-R // chunks)
    dbias = torch.zeros_like(bias)
    for g in range(G):
        windows = [(i * G + g) if cyclic else (g * R + i) for i in range(R)]
        total = torch.zeros_like(bias[g])
        for c in range(chunks):
            part = torch.zeros_like(bias[g])
            for p_ in windows[c * per:(c + 1) * per]:
                part = part + ds[p_]
            total = total + part
        dbias[g] = total
    return dqkv, dbias


def within_bwd(name, got, ref):
    tol = 1e-3 * max(1.0, ref.abs().max().item())
    err = (got - ref).abs().max().item()
    assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("std", [1.0, 3.0])
@pytest.mark.parametrize("cyclic", [False, True], ids=["group_major", "sample_major"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_holds_the_limits(name, cyclic, std):
    qkv, dout, bias, H, D = case_inputs(name, std)
    scale = D ** -0.5
    out, lse = kernel_fwd(qkv, bias, H, scale, cyclic)
    out_p, lse_p = wa.window_attention_fwd_reference(qkv, bias, H, scale, cyclic)
    assert torch.allclose(out, out_p, atol=FWD_TOL, rtol=FWD_TOL)
    assert torch.allclose(lse, lse_p, atol=FWD_TOL, rtol=FWD_TOL)
    dqkv, dbias = kernel_bwd(qkv, bias, out, lse, dout, H, scale, cyclic)
    dqkv_p, dbias_p = wa.window_attention_bwd_reference(qkv, bias, dout, H, scale, cyclic)
    HD = H * D
    for i, part in enumerate(("dq", "dk", "dv")):
        within_bwd(part, dqkv[:, i * HD:(i + 1) * HD], dqkv_p[:, i * HD:(i + 1) * HD])
    within_bwd("dbias", dbias, dbias_p)


@pytest.mark.parametrize("chunks", [None, 1, 2])
def test_chunked_bias_gradient_matches_the_group_sum_and_repeats(chunks):
    """The chunked, ordered dbias sum (the kernel's chunk count, one chunk,
    two uneven chunks of 5 windows a group) equals the plain group sum
    within the backward limit and is the same bit for bit on a second call."""
    C, H, D, size, window, shift, _ = CASES["swin_s_stage1"]
    CASES["swin_s_stage1_10"] = (C, H, D, size, window, shift, 10)
    try:
        qkv, dout, bias, H, D = case_inputs("swin_s_stage1_10", seed=3)
    finally:
        del CASES["swin_s_stage1_10"]
    scale = D ** -0.5
    for cyclic in (False, True):
        out, lse = kernel_fwd(qkv, bias, H, scale, cyclic)
        _, dbias = kernel_bwd(qkv, bias, out, lse, dout, H, scale, cyclic, chunks)
        _, again = kernel_bwd(qkv, bias, out, lse, dout, H, scale, cyclic, chunks)
        _, plain = wa.window_attention_bwd_reference(qkv, bias, dout, H, scale, cyclic)
        assert torch.equal(dbias, again)
        within_bwd("dbias", dbias, plain)


def test_chunk_rule_mirrors_the_kernel():
    """ops' window_chunks is the header's bwd_chunks: the fewest chunks c
    whose rounds of blocks (one an SM, 132 SMs) times the windows a block
    takes come within 5% of the least, at most one chunk a window."""
    src = HEADER.read_text()
    assert "constexpr int SMS = 132;" in src and fused_layer._SMS == 132
    assert "return rounds * (((R + c - 1) / c + walkers - 1) / walkers);" in src
    assert "while (20 * cost(c) > 21 * best) ++c;" in src
    assert "return chunk_count(P / G, G * H, SMS, 1);" in src
    # Swin-S stages 1 (shifted / not), 2, 3 at 64 images; Twins stage 3
    assert fused_layer.window_chunks(2048, 32, 3) == 4
    assert fused_layer.window_chunks(2048, 1, 3) == 42
    assert fused_layer.window_chunks(512, 8, 6) == 8
    assert fused_layer.window_chunks(128, 2, 12) == 11
    assert fused_layer.window_chunks(256, 1, 8) == 16
    assert fused_layer.window_chunks(4, 2, 1) == 2  # never more than a group's


# ---------------------------------------------------------------------------
# the wrappers through ctypes callbacks of the declared signatures
# ---------------------------------------------------------------------------


class FakeLib:
    """Each declared entry point as a ctypes callback of its argtypes: a
    call converts every argument as the real library's would (a wrong
    count or type raises) and is recorded."""

    def __init__(self):
        self.calls = {}
        self._keep = []
        for name, argtypes in _build._SIGNATURES.items():
            proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)

            def record(*args, name=name):
                self.calls[name] = args
                return 0

            fn = proto(record)
            self._keep.append(fn)
            setattr(self, name, fn)


@contextlib.contextmanager
def fake_cuda(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(_build, "build", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    yield lib


def recorded_partials(monkeypatch, *modules):
    """Record every dbias partials workspace the wrappers allocate."""
    made, make = [], fused_layer.bias_partials

    def alloc(P, G, H, N, opts):
        made.append(make(P, G, H, N, opts))
        return made[-1]

    for mod in modules:
        monkeypatch.setattr(mod, "bias_partials", alloc)
    return made


def layer_inputs(B, N, C, H, D, F, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, mean=0.0):
        return torch.from_numpy((mean + s * rng.standard_normal(shape)).astype(np.float32))

    HD = H * D
    return [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1), n(3 * HD, C, s=0.05).t(),
            n(3 * HD, s=0.1), n(HD, C, s=0.05).t(), n(C, s=0.1), n(C, s=0.1, mean=1.0),
            n(C, s=0.1), n(F, C, s=0.05).t(), n(F, s=0.1), n(C, F, s=0.05).t(), n(C, s=0.1)]


def test_b1_bias_backward_passes_the_partials(monkeypatch):
    B, N, C, H, D, G = 4, 18, 32, 2, 16, 2
    args = layer_inputs(B, N, C, H, D, 4 * C)[:7]
    extra = torch.randn(G, H, N, N)
    made = recorded_partials(monkeypatch, fused_layer)
    with fake_cuda(monkeypatch) as lib:
        out, res = fused_layer._cuda_fwd(*args, H, extra, G, None, 0.25, 1e-6, save=True)
        saved = fused_layer.AttnSaved(*args, None, *res, extra, H, 0.25, 1e-6)
        grads = fused_layer._cuda_bwd(saved, torch.zeros_like(out), False, True)
        bwd = lib.calls["vtx_fused_attention_layer_bwd"]
    assert len(made) == 1 and bwd[24] == made[0].data_ptr()
    assert made[0].shape == (fused_layer.window_chunks(B, G, H), G, H, N, N)
    assert bwd[21] is None  # no dq partials: the window kernel writes dq itself
    assert bwd[41] == grads[8].data_ptr() and grads[8].shape == extra.shape


def test_b2_backward_passes_the_partials(monkeypatch):
    B, N, C, H, D, F, G = 6, 18, 32, 2, 16, 64, 3
    args = layer_inputs(B, N, C, H, D, F)
    extra = torch.randn(G, H, N, N)
    made = recorded_partials(monkeypatch, fused_layer1)
    with fake_cuda(monkeypatch) as lib:
        _, res = fused_layer1._cuda_fwd(*args, H, extra, G, None, None, "silu", 0.25, 1e-6,
                                        save=True)
        saved = fused_layer1.L1Saved(*args, extra, None, None, *res, H, "silu", 0.25, 1e-6)
        grads = fused_layer1._cuda_bwd(saved, torch.zeros_like(args[0]), (False, False), True)
        call = lib.calls["vtx_fused_transformer_layer_bwd"]
        fused_layer1._cuda_bwd(saved, torch.zeros_like(args[0]), (False, False), False)
        no_grad = lib.calls["vtx_fused_transformer_layer_bwd"]
    assert len(made) == 1 and call[42] == made[0].data_ptr()
    assert made[0].shape == (fused_layer.window_chunks(B, G, H), G, H, N, N)
    assert call[39] is None  # no dq partials
    assert call[70] == grads[13].data_ptr()
    assert no_grad[42] is None and no_grad[70] is None


def test_b9_backward_passes_the_partials(monkeypatch):
    images, H, D, F, C = 2, 2, 8, 32, 16
    w = layer_inputs(1, 1, C, H, D, F)[1:]
    x = torch.randn(images, 4, 8, C)
    extra = torch.randn(4, H, 8, 8)  # a shifted layer: 4 groups of 2-window pairs
    geo = fused_swin._geometry(x, extra, 2, 2, True)
    made = recorded_partials(monkeypatch, fused_swin)
    with fake_cuda(monkeypatch) as lib:
        _, res = fused_swin._cuda_fwd(x, *w, H, extra, None, None, "silu", 0.25, 1e-6, geo,
                                      save=True)
        saved = fused_swin.SwinSaved(fused_swin.L1Saved(x, *w, extra, None, None, *res, H,
                                                        "silu", 0.25, 1e-6), geo)
        grads = fused_swin._cuda_bwd(saved, torch.zeros_like(x), (False, False), True)
        call = lib.calls["vtx_fused_swin_layer_bwd"]
    P = images * geo.G
    assert len(made) == 1 and call[45] == made[0].data_ptr()
    assert made[0].shape == (fused_layer.window_chunks(P, geo.G, H), geo.G, H, geo.m, geo.m)
    assert call[73] == grads[13].data_ptr()


def test_thin_door_calls_the_kernel(monkeypatch):
    qkv, dout, bias, H, D = case_inputs("swin_odd")
    N, G = bias.shape[-1], bias.shape[0]
    P = qkv.shape[0] // N
    made = recorded_partials(monkeypatch, wa)
    with fake_cuda(monkeypatch) as lib:
        fwd_before, bwd_before = wa.WINDOW_LAUNCHES, wa.WINDOW_BWD_LAUNCHES
        out, lse = wa._cuda_fwd(qkv, bias, H, 0.3, True, True)
        fwd = lib.calls["vtx_window_attention_fwd"]
        dqkv, dbias = wa._cuda_bwd(qkv, bias, out, lse, dout, H, 0.3, True, True)
        bwd = lib.calls["vtx_window_attention_bwd"]
    assert (wa.WINDOW_LAUNCHES, wa.WINDOW_BWD_LAUNCHES) == (fwd_before + 1, bwd_before + 1)
    assert fwd[:6] == (qkv.data_ptr(), bias.data_ptr(), G, 1, out.data_ptr(), lse.data_ptr())
    assert fwd[6:10] == (P, N, H, D) and abs(fwd[10] - 0.3) < 1e-7
    assert bwd[:7] == (qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                       bias.data_ptr(), G, 1)
    assert bwd[7:10] == (dqkv.data_ptr(), made[0].data_ptr(), dbias.data_ptr())
    assert made[0].shape == (fused_layer.window_chunks(P, G, H), G, H, N, N)
    assert bwd[10:14] == (P, N, H, D)


def test_bias_calls_refuse_more_than_128_tokens(monkeypatch):
    B, N, C, H, D = 2, 130, 32, 2, 16
    args = layer_inputs(B, N, C, H, D, 4 * C)
    extra = torch.zeros(1, H, N, N)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="128 tokens"):
        fused_layer._cuda_fwd(*args[:7], H, extra, 1, None, 0.25, 1e-6, save=False)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="128 tokens"):
        fused_layer1._cuda_fwd(*args, H, extra, 1, None, None, "silu", 0.25, 1e-6,
                               save=False)


@pytest.mark.cuda
@pytest.mark.parametrize("cyclic", [False, True], ids=["group_major", "sample_major"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name, cyclic):
    """On the card: forward within 1e-4, backward per tensor within
    1e-3·max(1, max|plain|) and bit-identical across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, dout, bias, H, D = (t.cuda() if torch.is_tensor(t) else t
                             for t in case_inputs(name, std=3.0))
    scale = D ** -0.5
    out, lse = wa.window_attention_fwd(qkv, bias, H, scale, cyclic)
    out_p, lse_p = wa.window_attention_fwd_reference(qkv, bias, H, scale, cyclic)
    assert torch.allclose(out, out_p, atol=FWD_TOL, rtol=FWD_TOL)
    assert torch.allclose(lse, lse_p, atol=FWD_TOL, rtol=FWD_TOL)
    grads = wa.window_attention_bwd(qkv, bias, out, lse, dout, H, scale, cyclic)
    again = wa.window_attention_bwd(qkv, bias, out, lse, dout, H, scale, cyclic)
    plain = wa.window_attention_bwd_reference(qkv, bias, dout, H, scale, cyclic)
    for name_, k, k2, p in zip(("dqkv", "dbias"), grads, again, plain):
        assert torch.equal(k, k2), name_
        within_bwd(name_, k, p)
