"""The bf16 forms' wrappers and C entries, checked on the CPU, and on the
card against their plain versions.

B1 (``fused_attention_layer``, forward and backward) and B2's serving
forward (``fused_transformer_layer``) take the ``_bf16`` C entries when x is
bfloat16, driven here through ctypes callbacks of the declared signatures
(tests/test_torch_port_vit_attention_tc.py's fake library): the
activations' workspaces are bfloat16, the statistics, lse and every
reduction workspace f32, and the backward's dq partials are passed even
with one key tile (they first hold the out projection's f32 dacc₀).  Every
entry without a bf16 form raises NotImplementedError for a bfloat16 tensor,
naming the ROADMAP queue, and casts nothing.

The ``cuda`` tests hold the bf16 kernels against their plain versions on
the card at chip_smoke.py's limits (one bf16 ulp is 2⁻⁸): forward within
1.6e-2·max(1, max|plain|), every gradient within 3e-2·max(1, max|plain|)
and bit-identical across two runs; among them the packed-row attention's
bf16 form alone (csrc/attention_bf16_tma.cuh) over N from 1 to 577 (one
128-key tile, two, the 208-key tile, past the 256 keys whose dq is summed
in shared memory) and heads 16 to 64 wide.  No JAX here, so they run where
JAX is absent.
"""

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch.ops import fused_attention_mod as fused_attention
from vision_transformers_tpu_torch.ops import (fused_block, fused_halo, fused_halo_layer,
                                               fused_layer, fused_layer1, fused_swin, gemm)
from test_torch_port_vit_attention_tc import fake_cuda, layer_inputs
from torch_port_threads import one_torch_thread  # noqa: F401

bf = torch.bfloat16
FWD_TOL, BWD_TOL = 1.6e-2, 3e-2  # chip_smoke.BF16_FWD_TOL, BF16_BWD_TOL
SHAPES = {"odd": (4, 17, 64, 2, 32, 128), "vit": (2, 197, 128, 2, 64, 256)}


def bf16_inputs(B, N, C, H, D, F, seed=0):
    """The layer's inputs as the bf16 model passes them: activations,
    weights and biases bfloat16, the LayerNorm parameters f32."""
    a = layer_inputs(B, N, C, H, D, F, seed)
    return [t if i in (1, 2, 7, 8) else t.to(bf) for i, t in enumerate(a)]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_b1_bf16_takes_the_bf16_entries(monkeypatch, shape):
    B, N, C, H, D, F = SHAPES[shape]
    args = bf16_inputs(B, N, C, H, D, F)[:7]
    r = torch.full((B,), 1 / 0.9)
    with fake_cuda(monkeypatch) as lib:
        before = (fused_layer.BF16_LAUNCHES, fused_layer.BF16_BWD_LAUNCHES,
                  fused_layer.LAUNCHES, fused_layer.BWD_LAUNCHES)
        out, res = fused_layer._cuda_fwd(*args, H, None, 1, r, D ** -0.5, 1e-6, save=True)
        saved = fused_layer.AttnSaved(*args, r, *res, None, H, D ** -0.5, 1e-6)
        grads = fused_layer._cuda_bwd(saved, torch.zeros_like(out), True, False)
        fwd = lib.calls["vtx_fused_attention_layer_fwd_bf16"]
        bwd = lib.calls["vtx_fused_attention_layer_bwd_bf16"]
        assert not {"vtx_fused_attention_layer_fwd", "vtx_fused_attention_layer_bwd"} \
            & set(lib.calls)
    after = (fused_layer.BF16_LAUNCHES, fused_layer.BF16_BWD_LAUNCHES,
             fused_layer.LAUNCHES, fused_layer.BWD_LAUNCHES)
    assert after == tuple(b + 1 for b in before)
    qkv, acc, mu, rstd, lse = res
    assert out.dtype == qkv.dtype == acc.dtype == bf
    assert mu.dtype == rstd.dtype == lse.dtype == torch.float32
    assert fwd["rs"] == r.data_ptr() and fwd["extra"] is None and fwd["lse"] == lse.data_ptr()
    assert bwd["dq_part"] is not None and bwd["dbpart"] is None and bwd["dextra"] is None
    dx, dg, db, dwqkv, dbqkv, dwout, dbout, drs, dextra = grads
    assert dx.dtype == bf and dg.dtype == db.dtype == drs.dtype == torch.float32
    # the weights' and biases' f32 sums, rounded once to their bf16 dtype
    assert dwqkv.dtype == dbqkv.dtype == dwout.dtype == dbout.dtype == bf
    assert dwqkv.shape == args[3].shape and dextra is None


def b1_bf16_workspaces(monkeypatch, shape, rows_scaled):
    """The ``dq_part`` workspaces B1's bf16 backward allocates, and its call."""
    B, N, C, H, D, F = shape
    args = bf16_inputs(B, N, C, H, D, F)[:7]
    r = torch.full((B,), 1 / 0.9) if rows_scaled else None
    made = []
    make = fused_layer.bf16_attention_workspace

    def record(*a, **kw):
        made.append(make(*a, **kw))
        return made[-1]

    monkeypatch.setattr(fused_layer, "bf16_attention_workspace", record)
    with fake_cuda(monkeypatch) as lib:
        out, res = fused_layer._cuda_fwd(*args, H, None, 1, r, D ** -0.5, 1e-6, save=True)
        saved = fused_layer.AttnSaved(*args, r, *res, None, H, D ** -0.5, 1e-6)
        fused_layer._cuda_bwd(saved, torch.zeros_like(out), rows_scaled, False)
        return made, lib.calls["vtx_fused_attention_layer_bwd_bf16"]


def test_b1_bf16_dq_partials_even_with_one_key_tile(monkeypatch):
    # one key tile and no row scale: the workspace is still passed, and holds
    # only the attention's L and Δ rows [B·H, ceil(N / 64), 2, 64] (dq is
    # summed in the kernel's shared memory: no f32 partials)
    B, N, C, H, D, F = SHAPES["odd"]
    made, bwd = b1_bf16_workspaces(monkeypatch, SHAPES["odd"], False)
    assert len(made) == 1 and made[0].shape == (2 * B * H * 64,)
    assert made[0].dtype == torch.float32 and bwd["dq_part"] == made[0].data_ptr()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_b1_bf16_workspace_holds_dacc0_with_a_row_scale(monkeypatch, shape):
    B, N, C, H, D, F = SHAPES[shape]
    made, bwd = b1_bf16_workspaces(monkeypatch, SHAPES[shape], True)
    assert len(made) == 1 and made[0].shape == (B * N * H * D,)
    assert bwd["dq_part"] == made[0].data_ptr() and bwd["rs"] is not None


@pytest.mark.parametrize("N, floats", [
    (1, 2 * 12 * 64), (64, 2 * 12 * 64), (65, 2 * 12 * 128), (197, 2 * 12 * 256),
    (256, 2 * 12 * 256),
    # past 256 keys the key tiles' dq partials [ceil(N / 128), B·N, H·D] follow
    (257, 2 * 12 * 320 + 3 * 4 * 257 * 3 * 40), (577, 2 * 12 * 640 + 5 * 4 * 577 * 3 * 40)])
def test_bf16_attention_workspace_rule(N, floats):
    # B = 4 images, H = 3 heads 40 wide: the rows of csrc/attention_bf16.cu
    assert fused_layer.packed_attention_bf16_floats(4, N, 3, 40) == floats


def test_b2_bf16_serves_on_its_bf16_entry(monkeypatch):
    B, N, C, H, D, F = SHAPES["vit"]
    args = bf16_inputs(B, N, C, H, D, F)
    with fake_cuda(monkeypatch) as lib:
        before = fused_layer1.BF16_LAUNCHES
        out, res = fused_layer1._cuda_fwd(*args, H, None, 1, None, None, "silu", D ** -0.5,
                                          1e-6, save=False)
        call = lib.calls["vtx_fused_transformer_layer_fwd_bf16"]
        assert "vtx_fused_transformer_layer_fwd" not in lib.calls
    assert fused_layer1.BF16_LAUNCHES == before + 1 and out.dtype == bf
    assert call["af"] is None and call["mu1"] is None and call["lse"] is None
    assert all(t.dtype == bf for t in res[:4])  # qkv, acc, z, hid


def test_b2_bf16_training_forward_raises(monkeypatch):
    B, N, C, H, D, F = SHAPES["odd"]
    args = bf16_inputs(B, N, C, H, D, F)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_layer1._cuda_fwd(*args, H, None, 1, None, None, "silu", D ** -0.5, 1e-6,
                               save=True)


def _b(*shape):
    return torch.zeros(shape, dtype=bf)


def _f(*shape):
    return torch.zeros(shape)


# every entry without a bf16 form, called with a bfloat16 tensor
NO_BF16_FORM = {
    "B1 with a bias": lambda: fused_layer._cuda_fwd(
        *bf16_inputs(4, 18, 32, 2, 16, 64)[:7], 2, _f(1, 2, 18, 18), 1, None, 0.25, 1e-6,
        save=False),
    "B2 with a bias": lambda: fused_layer1._cuda_fwd(
        *bf16_inputs(4, 18, 32, 2, 16, 64), 2, _f(1, 2, 18, 18), 1, None, None, "silu",
        0.25, 1e-6, save=False),
    "B2 backward": lambda: fused_layer1._cuda_bwd(
        fused_layer1.L1Saved(*bf16_inputs(2, 9, 32, 2, 16, 64), None, None, None,
                             *[_b(1)] * 9, 2, "silu", 0.25, 1e-6), _b(2, 9, 32),
        (False, False), False),
    "B3 fused_attention_qkv": lambda: fused_attention._check_qkv(_b(2, 9, 96), 2, None),
    "B4 fused_halo_layer": lambda: fused_halo_layer._check(
        _b(1, 8, 8, 32), _f(32), _f(32), _b(32, 96), _b(32, 32), _b(32), _f(32), _f(32),
        _b(32, 64), _b(64), _b(64, 32), _b(32), None, 2, None, None, "silu", 4, 2),
    "B5a halo_attention_direct": lambda: fused_halo._cuda_fwd(
        _b(1, 8, 8, 32), _b(1, 8, 8, 64), None, 4, 2, 2, 0.25, False),
    "B5b halo_attention": lambda: fused_halo._check_gathered(
        _b(2, 16, 32), _b(2, 64, 64), None, 2),
    "B6 fused_attention": lambda: fused_attention._check(
        _b(1, 2, 9, 16), _b(1, 2, 4, 16), _b(1, 2, 4, 16)),
    "B7 fused_ff_layer": lambda: fused_layer._check_ff(
        _b(2, 9, 32), _f(32), _f(32), _b(32, 64), _b(64), _b(64, 32), _b(32), None, "silu"),
    "B8 fused_attention_block": lambda: fused_block._check(
        _b(2, 9, 32), _b(32, 96), _b(96), _b(32, 32), _b(32), 2, None),
    "B9 fused_swin_layer": lambda: fused_swin._check(
        _b(1, 8, 8, 32), _f(32), _f(32), _b(32, 96), _b(96), _b(32, 32), _b(32), _f(32),
        _f(32), _b(32, 64), _b(64), _b(64, 32), _b(32), 2, None, None, None, "silu", None),
    "GEMM core (f32 form)": lambda: gemm._cuda_gemm(_b(8, 8), _b(8, 8), None, False, None,
                                                    1, None, None, "rows", 1),
}


@pytest.mark.parametrize("entry", sorted(NO_BF16_FORM))
def test_entries_without_a_bf16_form_raise(monkeypatch, entry):
    with fake_cuda(monkeypatch) as lib, pytest.raises(NotImplementedError,
                                                      match="ROADMAP|bf16"):
        NO_BF16_FORM[entry]()
    assert not lib.calls  # nothing was cast and sent on


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def within(name, k, p, tol):
    k, p = k.float(), p.float()
    assert torch.isfinite(k).all() and k.shape == p.shape, name
    lim = tol * max(1.0, p.abs().max().item())
    err = (k - p).abs().max().item()
    assert err <= lim, f"{name}: max|kernel-plain| {err:.3e} > {lim:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("rows_scaled", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_b1_bf16_matches_plain(shape, rows_scaled):
    needs_card()
    B, N, C, H, D, F = SHAPES[shape]
    a = [t.cuda() for t in bf16_inputs(B, N, C, H, D, F, seed=3)[:7]]
    r = torch.tensor([0.0] + [1 / 0.9] * (B - 1)).cuda() if rows_scaled else None
    dz = torch.from_numpy(np.random.default_rng(4).standard_normal((B, N, C))
                          .astype(np.float32)).cuda().to(bf)
    out, saved = fused_layer.fused_attention_layer_fwd(*a, H, row_scale=r)
    grads = fused_layer.fused_attention_layer_bwd(saved, dz)
    again = fused_layer.fused_attention_layer_bwd(saved, dz)
    out_p, saved_p = fused_layer.fused_attention_layer_fwd_reference(*a, H, row_scale=r)
    plain = fused_layer.fused_attention_layer_bwd_reference(saved_p, dz)
    within("out", out, out_p, FWD_TOL)
    within("serving", fused_layer.fused_attention_layer(*a, H, row_scale=r), out_p, FWD_TOL)
    for name, k, k2, p in zip(("dx", "dg", "db", "dwqkv", "dbqkv", "dwout", "dbout", "drs"),
                              grads, again, plain):
        if p is None:
            assert k is None, name
            continue
        assert torch.equal(k, k2), f"{name} differs between two runs"
        within(name, k, p, BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_b2_bf16_matches_plain(shape):
    needs_card()
    B, N, C, H, D, F = SHAPES[shape]
    a = [t.cuda() for t in bf16_inputs(B, N, C, H, D, F, seed=5)]
    r = torch.tensor([1 / 0.9] * B).cuda()
    within("out", fused_layer1.fused_transformer_layer(*a, H, rs_attn=r, rs_ff=r),
           fused_layer1.fused_transformer_layer_reference(*a, H, rs_attn=r, rs_ff=r), FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 40, 64])
@pytest.mark.parametrize("N", [1, 17, 64, 65, 128, 129, 197, 257, 577])
def test_cuda_packed_attention_bf16_matches_plain(N, D):
    needs_card()
    B, H = 2, 3
    g = torch.Generator().manual_seed(100 * N + D)
    qkv = torch.randn(B, N, 3 * H * D, generator=g).to(bf).cuda()
    dout = torch.randn(B, N, H * D, generator=g).to(bf).cuda()
    out, lse = fused_layer.packed_attention_bf16(qkv, H)
    serving, no_lse = fused_layer.packed_attention_bf16(qkv, H, save=False)
    ref, ref_lse = fused_layer.packed_attention_reference(qkv, H)
    assert no_lse is None and torch.equal(serving, out)
    within("out", out, ref, FWD_TOL)
    within("lse", lse, ref_lse, 1e-5)
    dqkv = fused_layer.packed_attention_bf16_bwd(qkv, out, lse, dout, H)
    again = fused_layer.packed_attention_bf16_bwd(qkv, out, lse, dout, H)
    plain = fused_layer.attention_bwd_reference(qkv, out, lse, dout, H, D ** -0.5, dtype=bf)[0]
    assert torch.equal(dqkv, again), "dqkv differs between two runs"
    HD = H * D
    for i, name in enumerate(("dq", "dk", "dv")):
        within(name, dqkv[..., i * HD:(i + 1) * HD], plain[..., i * HD:(i + 1) * HD], BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mnk", [(37, 29, 45), (300, 200, 104), (1000, 1152, 384)])
def test_cuda_gemm_bf16_matches_plain(mnk):
    needs_card()
    M, N, K = mnk
    g = torch.Generator().manual_seed(M)
    a = torch.randn(M, K, generator=g).to(bf).cuda()
    b = (0.05 * torch.randn(N, K, generator=g)).to(bf).cuda().t()
    bias, res = torch.randn(N, generator=g).to(bf).cuda(), torch.randn(M, N, generator=g)
    rs = torch.rand(-(-M // 7), generator=g).cuda() + 0.5
    kw = dict(bias=bias, rs=rs, rs_rows=7, res=res.to(bf).cuda())
    within("rows", gemm.gemm_bf16(a, b, **kw), gemm.gemm_bf16_reference(a, b, **kw), FWD_TOL)
    within("f32 sums", gemm.gemm_bf16(a, b, out_f32=True),
           gemm.gemm_bf16_reference(a, b, out_f32=True), 1e-3)
    # the split-K form: a [M, K] is the storage of aᵀ, summed over M (a
    # weight gradient's shape)
    bt = torch.randn(M, N, generator=g).to(bf).cuda()
    within("split-K", gemm.gemm_bf16(a, bt, form="splitk", splits=3),
           gemm.gemm_bf16_reference(a, bt, form="splitk"), 1e-3)


# the GEMM core's bf16 form alone: name → (form, M, N, K, options, route).
# The register path off 8-element rows; the TMA path with ragged M, N and
# K, the weight K-major (the forward's w.t() view) or N-major (a data
# gradient's w read in place), bf16 or f32 out; ViT-S/16's seven products
# at the trainer's 25,216 rows as the paths call them
GEMM_BF16_CALLS = {
    "odd_registers": ("rows", 37, 29, 45, ("bias", "rs", "res"), "registers"),
    "odd_registers_splitk": ("splitk", 45, 29, 1000, (), "registers"),
    "odd_tma_silu": ("rows", 300, 200, 104, ("bias", "silu"), "tma"),
    "odd_tma_nmajor": ("rows", 200, 136, 72, ("bias", "rs", "res", "nmajor"), "tma"),
    "odd_tma_f32_nmajor": ("rows", 300, 200, 104, ("f32", "nmajor"), "tma"),
    "odd_tma_splitk": ("splitk", 40, 200, 333, (), "tma"),
    "odd_tma_splitk_kmajor": ("splitk", 96, 64, 704, ("kmajor",), "tma"),
    "vit_qkv": ("rows", 25216, 1152, 384, ("bias",), "tma"),
    "vit_out_projection": ("rows", 25216, 384, 384, ("bias", "rs", "res"), "tma"),
    "vit_ff1": ("rows", 25216, 1536, 384, ("bias", "silu"), "tma"),
    "vit_ff2": ("rows", 25216, 384, 1536, ("bias", "res"), "tma"),
    "vit_dln": ("rows", 25216, 384, 1152, ("f32", "nmajor"), "tma"),
    "vit_dwqkv": ("splitk", 384, 1152, 25216, (), "tma"),
    "vit_dwout": ("splitk", 384, 384, 25216, (), "tma"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GEMM_BF16_CALLS))
def test_cuda_gemm_bf16_routes_and_matches_plain(name):
    needs_card()
    form, M, N, K, opts, route = GEMM_BF16_CALLS[name]
    g = torch.Generator().manual_seed(M + N + K)

    def r(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g)).to(bf).cuda()

    splitk = form == "splitk"
    a = r(K, M) if splitk else r(M, K)
    if splitk:
        b = r(N, K).t() if "kmajor" in opts else r(K, N)
    else:
        b = r(K, N, s=0.05) if "nmajor" in opts else r(N, K, s=0.05).t()
    kw = dict(bias=r(N, s=0.1) if "bias" in opts else None, silu="silu" in opts,
              res=r(M, N) if "res" in opts else None, out_f32="f32" in opts)
    if "rs" in opts:
        kw.update(rs=torch.rand(-(-M // 197), generator=g).cuda() + 0.5, rs_rows=197)
    plain = gemm.gemm_bf16_reference(a, b, form=form, **kw)
    if splitk:
        kw = dict(splits=fused_layer._splits(M, N, K))
    out, plan = gemm.gemm_bf16(a, b, form=form, plan=True, **kw)
    assert plan["route"] == route, plan
    within(name, out, plain, 1e-3 if splitk or "f32" in opts else FWD_TOL)
    if splitk:  # the slabs summed in order: bit-identical from run to run
        assert torch.equal(out, gemm.gemm_bf16(a, b, form=form, **kw))
