"""The whole Halo layer B4 with its passes inside the GEMM core, checked on
the CPU.

B4's launch sequence (csrc/fused_halo.cu, the FF half and the out
projection's backward of csrc/fused_layer1_bwd.cu and fused_layer_bwd.cu)
no longer writes LN₁(x), LN₂(z), silu(hid), r ⊙ dy or da₀ ⊙ silu(hid):
the GEMM core's producer applies the LayerNorm from saved statistics, the
activation and a row scale as it stages an operand, and the dh GEMM's
epilogue takes silu', r₂, the dr₂ row partials and db₁'s column partials
(``GemmExtra``, csrc/common.cuh).  Here, with ``ops/gemm.py``'s plain
versions of those options:

- the staged operands (LayerNorm apply on A in the row and split-K forms,
  silu / gelu on A, a row scale on B) through the core's 3xTF32 products,
  emulated as in tests/test_torch_port_gemm_tf32x3.py, against the plain
  sequence (the pass, then the GEMM) within chip_smoke.py's limits:
  atol = rtol = 1e-4 for the row forms, 1e-3·max(1, max|plain|) split-K;
- the epilogue's row and column partials, summed in the kernel's order,
  against the plain row-scale gradient and column sums: within 1e-5 of
  max(1, max|plain|) (f32 sums in another order);
- B4 forward and backward at two small Halo stages through the new
  sequence of plain steps against the JAX package's ``fused_halo_layer``
  (the Pallas kernels in interpret mode) and its ``jax.grad``: forward
  atol 1e-5, gradients rtol 1e-3 / atol 1e-4 per tensor, as
  tests/test_torch_port_halo_ops.py holds the layer;
- the changed C entries' parameter lists against their declarations, and
  the wrappers through ctypes callbacks of those declarations.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_port_gemm_tf32x3 import BWD_TOL, TOL, gemm_rows, gemm_splitk
from test_torch_port_halo_entry import c_entry_kinds, fake_cuda, halo_inputs
from test_torch_port_halo_ops import assert_grads_close, jax_layer, layer_inputs
from vision_transformers_tpu_torch.ops import _build
from vision_transformers_tpu_torch.ops import fused_halo
from vision_transformers_tpu_torch.ops import fused_halo_layer as fhl
from vision_transformers_tpu_torch.ops import fused_layer as fl
from vision_transformers_tpu_torch.ops import gemm as gm
from torch_port_threads import one_torch_thread  # noqa: F401

ROWS, COLS = 40, 36  # a few dozen outputs of full K, as the tf32x3 tests


def rng_tensor(rng, *shape, s=1.0, mean=0.0):
    return torch.from_numpy((mean + s * rng.standard_normal(shape)).astype(np.float32))


def ln_params(rng, tokens, feats):
    """Statistics and parameters of a LayerNorm: mu, rstd over ``tokens``,
    g, b over ``feats``."""
    return (rng_tensor(rng, tokens, s=0.3),
            torch.from_numpy((0.5 + rng.random(tokens)).astype(np.float32)),
            rng_tensor(rng, feats, s=0.1, mean=1.0), rng_tensor(rng, feats, s=0.1))


# ---------------------------------------------------------------------------
# the producer's transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [96, 384])
def test_staged_layernorm_products_hold_the_row_limit(K):
    # the qkv and FF1 GEMMs of Halo-S (K = C: 96 at stage 1, 384 at stage 3)
    rng = np.random.default_rng(K)
    x = rng_tensor(rng, ROWS, K, s=2.0, mean=0.5)
    ln = ln_params(rng, ROWS, K)
    w = rng_tensor(rng, COLS, K, s=K ** -0.5).t()
    staged = gm.stage_a(x, ln)
    mu, rstd, g, b = ln
    plain = (((x - mu[:, None]) * rstd[:, None]) * g + b) @ w
    # the staged value is the LN pass's own expression
    assert torch.equal(staged, ((x - mu[:, None]) * rstd[:, None]) * g + b)
    out = gemm_rows(staged, w, 3)
    assert torch.allclose(out, plain, atol=TOL, rtol=TOL), (out - plain).abs().max()
    assert torch.equal(gm.gemm(x, w, ln=ln), plain)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_staged_activation_products_hold_the_row_limit(act):
    # FF2 of Halo-S stage 1: K = F = 384, hid of std 2
    rng = np.random.default_rng(7)
    hid = rng_tensor(rng, ROWS, 384, s=2.0)
    w = rng_tensor(rng, COLS, 384, s=384 ** -0.5).t()
    staged = gm.stage_a(hid, act=act)
    assert torch.equal(staged, fl._act(hid, act))
    plain = fl._act(hid, act) @ w
    out = gemm_rows(staged, w, 3)
    assert torch.allclose(out, plain, atol=TOL, rtol=TOL), (out - plain).abs().max()


@pytest.mark.parametrize("what", ["ln", "act", "rs_b"])
def test_staged_splitk_operands_hold_the_backward_limit(what):
    # the weight gradients over 4096 rows (one Halo-S stage-1 image) in three
    # slabs: dW₁ = LN₂(z)ᵀ·dh (the token is the k index), dW₂ = silu(hid)ᵀ·dy,
    # and r ⊙ dy staged on B (dW₂, dWout)
    rng = np.random.default_rng(["ln", "act", "rs_b"].index(what))
    rows, M, N, per = 4096, 24, 20, 512
    at = rng_tensor(rng, rows, M, s=2.0)
    dy = rng_tensor(rng, rows, N)
    kw = {}
    if what == "ln":
        kw["ln"] = ln_params(rng, rows, M)
        lhs = gm.stage_a(at.t(), kw["ln"], token_is_k=True).t()  # at: Aᵀ's storage
        mu, rstd, g, b = kw["ln"]
        plain_lhs = ((at - mu[:, None]) * rstd[:, None]) * g + b
    elif what == "act":
        kw["act_a"] = "silu"
        lhs = plain_lhs = fl._act(at, "silu")
    else:
        kw.update(rs_b=torch.from_numpy((0.5 + rng.random(rows // per)).astype(np.float32)),
                  rs_b_rows=per)
        lhs = plain_lhs = at
    rhs = dy if what != "rs_b" else dy * kw["rs_b"].repeat_interleave(per)[:, None]
    plain = plain_lhs.t() @ rhs
    assert torch.equal(lhs, plain_lhs)
    out = gemm_splitk(lhs, rhs, 3, 3)
    assert (out - plain).abs().max() <= BWD_TOL * max(1.0, plain.abs().max().item())
    assert torch.equal(gm.gemm(at, dy, form="splitk", splits=3, **kw), plain)


# ---------------------------------------------------------------------------
# the epilogue's partials
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,N", [(3 * 4096 // 64, 384), (300, 200), (37, 29)],
                         ids=["halo-stage1-rows", "odd", "one-tile"])
def test_epilogue_partials_sum_to_the_row_scale_gradient_and_the_bias_gradient(M, N):
    rng = np.random.default_rng(M + N)
    B = 3 if M % 3 == 0 else 1
    per = M // B
    da0, hid = rng_tensor(rng, M, N), rng_tensor(rng, M, N, s=2.0)
    dy, b2 = rng_tensor(rng, M, 16), rng_tensor(rng, 16, s=0.1)
    r = torch.from_numpy(np.where(np.arange(B) % 2, 1.25, 0.0).astype(np.float32))
    out, rpart, cpart = gm.gemm_reference(
        da0, torch.eye(N), rs=r, rs_rows=per, hid=hid, row_partials=True, col_partials=True)
    # dh = r₂ · da₀ ⊙ silu'(hid), what dact_mul_kernel wrote
    torch.testing.assert_close(out, r.repeat_interleave(per)[:, None] * da0
                               * fl._act_grad(hid, "silu"), atol=1e-6, rtol=1e-6)
    assert rpart.shape == (M, -(-N // 64)) and cpart.shape == (-(-M // 16), N)
    # dr₂ as row_scale_grad_kernel summed it: Σ_rows (da₀ ⊙ silu(hid) + dy·b₂)
    drs = gm.drs_sums(rpart, dy, b2, per)
    plain = ((da0 * fl._act(hid, "silu")).sum(1) + dy @ b2).reshape(B, per).sum(1)
    assert (drs - plain).abs().max() <= 1e-5 * max(1.0, plain.abs().max().item())
    # db₁ as colsum_kernel summed it: the 16-row slices' partials in order
    db1 = torch.zeros(N)
    for t in cpart:
        db1 = db1 + t
    assert (db1 - out.sum(0)).abs().max() <= 1e-5 * max(1.0, out.sum(0).abs().max().item())


def test_partials_follow_the_kernels_order():
    # the row partials: a lane's 16 columns, then ((l0 + l1) + (l2 + l3)); the
    # column partials: a lane's two rows, then the 8 lane rows as a tree —
    # checked against the same sums written out in float64 where the order
    # cannot matter, and against a reordering where it must
    rng = np.random.default_rng(11)
    prod = rng_tensor(rng, 130, 70)
    rpart, cpart = gm.epilogue_partials(prod, prod)
    exact_r = torch.nn.functional.pad(prod, (0, 58)).double().reshape(130, 2, 64).sum(-1)
    assert (rpart.double() - exact_r).abs().max() < 1e-5
    exact_c = torch.nn.functional.pad(prod, (0, 0, 0, 14)).double().reshape(9, 16,
                                                                             70).sum(1)
    assert (cpart.double() - exact_c).abs().max() < 1e-5
    big = torch.tensor([[1e8] + [1.0] * 15 + [-1e8] + [0.0] * 47])
    # lane 0 holds columns 0, 1, 8, 9 before 16: 1e8 + 1 rounds the 1 away
    # (the f32 spacing at 1e8 is 8), three times, then −1e8 leaves 0; lanes
    # 1-3 hold 4 each: (0 + 4) + (4 + 4) = 12, where the exact sum is 15
    r, _ = gm.epilogue_partials(big, big)
    assert r[0, 0].item() == 12.0


# ---------------------------------------------------------------------------
# B4 through the new sequence of plain steps against the JAX kernel
# ---------------------------------------------------------------------------


def passes_forward(x, g1, b1, wqkv, wout, bout, g2, b2n, w1, b1f, w2, b2f, bias, nh, r1, r2,
                   window, halo, eps=1e-6):
    """B4's forward as its launches: the statistics, qkv (LN₁ staged), the
    halo attention, the out projection (+bout, ×r₁, +x), the statistics,
    FF1 (LN₂ staged, +b₁), FF2 (silu staged, +b₂, ×r₂, +z)."""
    B, H, W, C = x.shape
    M, N, HD = B * H * W, H * W, wqkv.shape[1] // 3
    x2 = x.reshape(M, C)
    mu1, rstd1 = (t[:, 0] for t in fl._ln_stats(x2, eps))
    qkv = gm.gemm_reference(x2, wqkv, ln=(mu1, rstd1, g1, b1))
    q4 = qkv.reshape(B, H, W, 3 * HD)
    acc, lse = fused_halo.attention_fwd_reference(
        q4[..., :HD], q4[..., HD:2 * HD], q4[..., 2 * HD:], bias, nh, window, halo,
        (HD // nh) ** -0.5)
    acc = acc.reshape(M, HD)
    z = gm.gemm_reference(acc, wout, bias=bout, rs=r1, rs_rows=N, res=x2)
    mu2, rstd2 = (t[:, 0] for t in fl._ln_stats(z, eps))
    hid = gm.gemm_reference(z, w1, bias=b1f, ln=(mu2, rstd2, g2, b2n))
    out = gm.gemm_reference(hid, w2, bias=b2f, rs=r2, rs_rows=N, res=z, act_a="silu")
    return out.reshape(x.shape), dict(x2=x2, qkv=qkv, acc=acc, lse=lse, z=z, hid=hid,
                                      mu1=mu1, rstd1=rstd1, mu2=mu2, rstd2=rstd2)


def passes_backward(s, do, x, g1, b1, wqkv, wout, bout, g2, b2n, w1, b1f, w2, b2f, bias, nh,
                    r1, r2, window, halo):
    """B4's backward as its launches (csrc/fused_halo.cu): the FF half with
    silu and r₂ staged in dW₂, the dh GEMM's epilogue (silu', r₂, the dr₂
    and db₁ partials), LN₂ staged in dW₁; the out projection with r₁
    staged in dWout; the halo attention's backward; LN₁ staged in dWqkv."""
    B, H, W, C = x.shape
    M, N, HD = B * H * W, H * W, wqkv.shape[1] // 3
    dy = do.reshape(M, C)
    rows_of = lambda r: r.repeat_interleave(N)[:, None]  # noqa: E731
    # FF half
    dw2 = gm.gemm_reference(s["hid"], dy, form="splitk", act_a="silu", rs_b=r2, rs_b_rows=N)
    db2f = (dy * rows_of(r2)).sum(0)
    dh, rpart, cpart = gm.gemm_reference(dy, w2.t(), rs=r2, rs_rows=N, hid=s["hid"],
                                         row_partials=True, col_partials=True)
    drs_ff = gm.drs_sums(rpart, dy, b2f, N)
    db1f = cpart.sum(0)
    ln2 = (s["mu2"], s["rstd2"], g2, b2n)
    dw1 = gm.gemm_reference(s["z"], dh, form="splitk", ln=ln2)
    xhat2 = (s["z"] - s["mu2"][:, None]) * s["rstd2"][:, None]
    dz, dg2, db2n = fl.ln_bwd_reference(dh @ w1.t(), xhat2, s["rstd2"][:, None], g2, dy)
    # the out projection (its dr pass as row_scale_grad_kernel)
    dwout = gm.gemm_reference(s["acc"], dz, form="splitk", rs_b=r1, rs_b_rows=N)
    dbout = (dz * rows_of(r1)).sum(0)
    dacc0 = dz @ wout.t()
    drs_attn = ((dacc0 * s["acc"]).sum(1) + dz @ bout).reshape(B, N).sum(1)
    dacc = dacc0 * rows_of(r1)
    # the halo attention
    q4 = s["qkv"].reshape(B, H, W, 3 * HD)
    dq, dk, dv, dbias = fused_halo.attention_bwd_reference(
        q4[..., :HD], q4[..., HD:2 * HD], q4[..., 2 * HD:], bias,
        s["acc"].reshape(B, H, W, HD), s["lse"], dacc.reshape(B, H, W, HD), nh, window,
        halo, (HD // nh) ** -0.5)
    dqkv = torch.cat([dq, dk, dv], -1).reshape(M, 3 * HD)
    # the qkv projection and LN₁
    dwqkv = gm.gemm_reference(s["x2"], dqkv, form="splitk",
                              ln=(s["mu1"], s["rstd1"], g1, b1))
    xhat1 = (s["x2"] - s["mu1"][:, None]) * s["rstd1"][:, None]
    dx, dg1, db1 = fl.ln_bwd_reference(dqkv @ wqkv.t(), xhat1, s["rstd1"][:, None], g1, dz)
    return [dx.reshape(x.shape), dg1, db1, dwqkv, dwout, dbout, dg2, db2n, dw1, db1f, dw2,
            db2f, dbias, drs_attn, drs_ff]


# two Halo stages at narrow widths: an 8x8 map of 16 channels and its next
# stage, a 4x4 map (one window) of 32 channels; both row scales
STAGES = [(2, 8, 8, 16, 2, 8, 4, 1), (2, 4, 4, 32, 4, 8, 4, 2)]


@pytest.mark.parametrize("B,H,W,C,nh,D,window,halo", STAGES, ids=["stage1", "stage2"])
def test_b4_through_the_new_sequence_matches_jax(B, H, W, C, nh, D, window, halo):
    args, r1, r2, w = layer_inputs(B, H, W, C, nh, D, window, halo, rs=True)
    out_j, g_j = jax_layer(args, r1, r2, w, nh, window, halo)
    t = [torch.from_numpy(a) for a in args]
    rs = torch.from_numpy(r1), torch.from_numpy(r2)
    out, saves = passes_forward(*t, nh, *rs, window, halo)
    grads = passes_backward(saves, torch.from_numpy(w), *t, nh, *rs, window, halo)
    np.testing.assert_allclose(out.numpy(), out_j, atol=1e-5, rtol=0)
    assert_grads_close(fhl.GRAD_NAMES, [g.numpy() for g in grads], g_j)


# ---------------------------------------------------------------------------
# the changed C entries
# ---------------------------------------------------------------------------

CHANGED = ("vtx_gemm_tc", "vtx_fused_halo_layer_fwd", "vtx_fused_halo_layer_bwd")


@pytest.mark.parametrize("name", CHANGED)
def test_changed_entries_match_their_declarations(name):
    kind = {ctypes.c_void_p: "P", ctypes.c_longlong: "L", ctypes.c_int: "I",
            ctypes.c_float: "F"}
    assert [kind[t] for t in _build._SIGNATURES[name]] == c_entry_kinds(name)


def test_gemm_wrapper_passes_the_passes_options(monkeypatch):
    rng = np.random.default_rng(0)
    a, b, hid = rng_tensor(rng, 21, 13), rng_tensor(rng, 13, 10), rng_tensor(rng, 21, 10)
    ln = ln_params(rng, 21, 13)
    rs = torch.ones(3)
    with fake_cuda(monkeypatch) as lib:
        gm._cuda_gemm(a, b, None, False, None, 1, None, None, "rows", 1, ln=ln, act_a=None)
        staged = lib.calls["vtx_gemm_tc"]
        out, rpart, cpart = gm._cuda_gemm(a, b, None, False, rs, 7, None, None, "rows", 1,
                                          hid=hid, hid_act="gelu", row_partials=True,
                                          col_partials=True)
        epi = lib.calls["vtx_gemm_tc"]
        at = rng_tensor(rng, 13, 21)
        gm._cuda_gemm(at, b, None, False, None, 1, None, None, "splitk", 2, act_a="silu",
                      rs_b=rs, rs_b_rows=5)
        splitk = lib.calls["vtx_gemm_tc"]
    assert staged[21:26] == (*(t.data_ptr() for t in ln), -1)
    assert staged[26:32] == (None, 1, None, 0, None, None)
    assert epi[21:26] == (None,) * 4 + (-1,)
    assert epi[28:32] == (hid.data_ptr(), 1, rpart.data_ptr(), cpart.data_ptr())
    assert rpart.shape == (21, 1) and cpart.shape == (2, 10)
    assert splitk[25:28] == (0, rs.data_ptr(), 5) and splitk[28:32] == (None, 0, None, None)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="no epilogue"):
        gm._cuda_gemm(at, b, None, False, None, 1, None, None, "splitk", 2, hid=hid)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="need hid"):
        gm._cuda_gemm(a, b, None, False, None, 1, None, None, "rows", 1, row_partials=True)


def test_halo_layer_wrappers_pass_no_layernorm_output_and_no_activation(monkeypatch):
    args, r1, r2 = halo_inputs()
    with fake_cuda(monkeypatch) as lib:
        _, res = fhl._cuda_fwd(*args, 2, r1, r2, "silu", 4, 1, 0.25, 1e-6, save=True)
        fwd = lib.calls["vtx_fused_halo_layer_fwd"]
        saved = fhl.HaloSaved(*args, r1, r2, *res, 2, "silu", 4, 1, 0.25, 1e-6)
        fhl._cuda_bwd(saved, torch.zeros_like(args[0]), (True, True))
        bwd = lib.calls["vtx_fused_halo_layer_bwd"]
        no_b1 = fhl.HaloSaved(*args[:9], None, *args[10:], r1, r2, *res, 2, "silu", 4, 1,
                              0.25, 1e-6)
        fhl._cuda_bwd(no_b1, torch.zeros_like(args[0]), (True, False))
        no_drs = lib.calls["vtx_fused_halo_layer_bwd"]
    # the forward's workspace: qkv, acc, z, hid and the statistics, no u or af
    assert len(fwd) == len(_build._SIGNATURES["vtx_fused_halo_layer_fwd"])
    assert fwd[23:27] == tuple(t.data_ptr() for t in res[:4])
    # the backward's: the dh GEMM's partials where dr₂ or db₁ is asked for
    assert bwd[39] is not None and no_drs[39] is None
    assert len(bwd) == len(_build._SIGNATURES["vtx_fused_halo_layer_bwd"])
    assert fl.rpart_floats(128, 384, 2, 64) == 128 * 6 + 2 + 8 * 384
