"""The bf16 forms of the Halo kernels' wrappers and C entries, checked on the
CPU, and on the card against their plain versions.

The whole Halo layer B4 (``fused_halo_layer``: training and serving
forward, backward) and the halo attention B5a (``halo_attention_direct``)
and B5b (``halo_attention``) take the ``_bf16`` C entries when their
activations are bfloat16, driven here through ctypes callbacks of the
declared signatures (tests/test_torch_port_vit_attention_tc.py's fake
library): B4's activations' workspaces bfloat16, af = round(silu(hid)) its
training forward's and backward's workspace, the backward's f32 rows
workspace (da₀, then dacc₀) passed only with a row scale; no dq partials
(the bf16 form takes a window's keys in one tile); the counters of the
bf16 launches move with the launches'.

The ``cuda`` tests hold the bf16 kernels against their plain versions on
the card at chip_smoke.py's limits (forward within 1.6e-2·max(1,
max|plain|), every gradient within 3e-2·max(1, max|plain|) and
bit-identical across two runs) at odd shapes: a non-square map, heads 16
and 24 wide, windows of 9, 16 and 64 queries, 36 to 144 keys, and the
gathered problem at window 4 / halo 3.  No JAX here, so they run where JAX
is absent.
"""

import pytest
import torch

from vision_transformers_tpu_torch.ops import fused_halo, fused_halo_layer
from test_torch_port_vit_attention_tc import fake_cuda
from torch_port_threads import one_torch_thread  # noqa: F401

bf = torch.bfloat16
FWD_TOL, BWD_TOL = 1.6e-2, 3e-2  # chip_smoke.BF16_FWD_TOL, BF16_BWD_TOL
# the layer's inputs that stay f32: the LayerNorms' parameters and the bias
F32_ARGS = (1, 2, 6, 7, 12)


def halo_inputs(B, H, W, C, nh, D, window, halo, device="cpu", seed=0):
    """Seeded inputs of the whole Halo layer as the bf16 model passes them
    (weights as transposed views of [out, in] matrices in bf16, the
    LayerNorms' parameters and the bias f32) and two row scales (keep
    0.9)."""
    g = torch.Generator().manual_seed(seed)
    HD, F, k = nh * D, 2 * C, window + 2 * halo

    def n(*shape, s=1.0, mean=0.0):
        return mean + s * torch.randn(shape, generator=g)

    a = [n(B, H, W, C), n(C, s=0.1, mean=1.0), n(C, s=0.1), n(3 * HD, C, s=0.1).t(),
         n(C, HD, s=0.1).t(), n(C, s=0.1), n(C, s=0.1, mean=1.0), n(C, s=0.1),
         n(F, C, s=0.1).t(), n(F, s=0.1), n(C, F, s=0.1).t(), n(C, s=0.1),
         n(nh, window * window, k * k, s=0.5)]
    a = [(t if i in F32_ARGS else t.to(bf)).to(device) for i, t in enumerate(a)]
    keep = torch.arange(B) % 3 != 1
    rs = [(keep.float() / 0.9).to(device), (keep.flip(0).float() / 0.9).to(device)]
    return a, rs


def b4_calls(monkeypatch, a, nh, rs, window, halo):
    """B4's serving forward, training forward and backward through the
    wrappers' CUDA path on the fake library: (out, saved, grads, the three
    calls' arguments)."""
    fl = fused_halo_layer
    D = a[3].shape[1] // 3 // nh
    kw = (window, halo, D ** -0.5, 1e-6)
    with fake_cuda(monkeypatch) as lib:
        fl._cuda_fwd(*a, nh, *rs, "silu", *kw, save=False)
        serve = lib.calls.pop("vtx_fused_halo_layer_fwd_bf16")
        out, res = fl._cuda_fwd(*a, nh, *rs, "silu", *kw, save=True)
        fwd = lib.calls["vtx_fused_halo_layer_fwd_bf16"]
        saved = fl.HaloSaved(*a, *rs, *res, nh, "silu", *kw)
        grads = fl._cuda_bwd(saved, torch.zeros_like(out), (True, True))
        bwd = lib.calls["vtx_fused_halo_layer_bwd_bf16"]
        assert not {"vtx_fused_halo_layer_fwd", "vtx_fused_halo_layer_bwd"} & set(lib.calls)
    return out, saved, grads, (serve, fwd, bwd)


def test_b4_bf16_takes_the_bf16_entries(monkeypatch):
    B, H, W, C, nh, D, window, halo = 2, 8, 8, 32, 2, 16, 4, 1
    a, (r1, r2) = halo_inputs(B, H, W, C, nh, D, window, halo)
    fl = fused_halo_layer
    before = (fl.LAUNCHES, fl.BF16_LAUNCHES, fl.BWD_LAUNCHES, fl.BF16_BWD_LAUNCHES)
    out, saved, grads, (serve, fwd, bwd) = b4_calls(monkeypatch, a, nh, (r1, r2), window,
                                                    halo)
    after = (fl.LAUNCHES, fl.BF16_LAUNCHES, fl.BWD_LAUNCHES, fl.BF16_BWD_LAUNCHES)
    assert after == (before[0] + 2, before[1] + 2, before[2] + 1, before[3] + 1)
    # serving: no af, no lse; training: af and every statistic
    assert serve["af"] is None and serve["lse"] is None and serve["save"] == 0
    assert fwd["af"] is not None and fwd["lse"] == saved.lse.data_ptr() and fwd["save"] == 1
    assert out.dtype == saved.qkv.dtype == saved.acc.dtype == saved.z.dtype == bf
    assert saved.hid.dtype == bf and saved.lse.dtype == saved.mu1.dtype == torch.float32
    assert fwd["rs_attn"] == r1.data_ptr() and fwd["bias"] == a[12].data_ptr()
    # the backward: af in rpart's slot, the f32 rows for da₀ / dacc₀, the
    # per-window dkv buffer and the dbias chunks
    assert bwd["af"] is not None and bwd["rows"] is not None
    assert bwd["dkvw"] is not None and bwd["part"] is not None and bwd["chunks"] >= 1
    dx, dg1, db1, dwqkv, dwout, dbout, dg2, db2, dw1, db1f, dw2, db2f, dbias, drs1, drs2 = \
        grads
    assert dx.dtype == bf and dx.shape == a[0].shape
    assert dg1.dtype == dbias.dtype == drs1.dtype == drs2.dtype == torch.float32
    # the weights' and biases' f32 sums, rounded once to their bf16 dtype
    assert dwqkv.dtype == dwout.dtype == dw1.dtype == dw2.dtype == db1f.dtype == bf
    assert dwqkv.shape == a[3].shape and dw1.shape == (C, 2 * C) and dwout.shape == (nh * D, C)


def test_b4_bf16_backward_without_row_scales_takes_no_rows(monkeypatch):
    a, _ = halo_inputs(1, 8, 8, 16, 2, 8, 4, 2)
    *_, (_, fwd, bwd) = b4_calls(monkeypatch, a, 2, (None, None), 4, 2)
    assert fwd["rs_attn"] is None and fwd["rs_ff"] is None
    assert bwd["rows"] is None and bwd["drs_attn"] is None and bwd["af"] is not None


@pytest.mark.parametrize("gathered", [False, True], ids=["B5a", "B5b"])
def test_halo_attention_bf16_takes_the_bf16_entries(monkeypatch, gathered):
    nh, D, window, halo = 2, 16, 4, 3 if gathered else 1
    k = window + 2 * halo
    g = torch.Generator().manual_seed(1)
    shapes = ((6, 16, nh * D), (6, k * k, 2 * nh * D)) if gathered else \
        ((2, 8, 8, nh * D), (2, 8, 8, 2 * nh * D))
    q, kv = (torch.randn(s, generator=g).to(bf) for s in shapes)
    bias = torch.randn(nh, window * window, k * k, generator=g)
    scale = D ** -0.5
    fh = fused_halo
    with fake_cuda(monkeypatch) as lib:
        if gathered:
            name, counters = "vtx_halo_attention", ("HALO_GATHER_BF16_LAUNCHES",
                                                    "HALO_GATHER_BF16_BWD_LAUNCHES")
            before = [getattr(fh, c) for c in counters]
            out, lse = fh._cuda_gathered_fwd(q, kv, bias, nh, scale, save=True)
            grads = fh._cuda_gathered_bwd(fh.GatherSaved(q, kv, bias, out, lse, nh, scale),
                                          torch.zeros_like(out))
        else:
            name, counters = "vtx_halo_attention_direct", ("BF16_LAUNCHES",
                                                           "BF16_BWD_LAUNCHES")
            before = [getattr(fh, c) for c in counters]
            out, lse = fh._cuda_fwd(q, kv, bias, window, halo, nh, scale, save=True)
            grads = fh._cuda_bwd(fh.DirectSaved(q, kv, bias, out, lse, window, halo, nh,
                                                scale), torch.zeros_like(out))
        assert {name + "_fwd_bf16", name + "_bwd_bf16"} <= set(lib.calls)
        assert not {name + "_fwd", name + "_bwd"} & set(lib.calls)
        bwd = lib.calls[name + "_bwd_bf16"]
    assert [getattr(fh, c) for c in counters] == [b + 1 for b in before]
    dq, dkv, dbias = grads
    assert out.dtype == dq.dtype == dkv.dtype == bf and dbias.dtype == torch.float32
    assert lse.dtype == torch.float32 and bwd["dq_part"] is None


def test_bf16_forms_refuse_more_keys_than_one_tile(monkeypatch):
    """Past 144 keys a window (window 8, halo 3: 196) the bf16 forms raise,
    naming the queue; nothing is cast and sent on."""
    a, _ = halo_inputs(1, 16, 16, 32, 2, 16, 8, 4)
    q, kv = torch.zeros(1, 16, 16, 32, dtype=bf), torch.zeros(1, 16, 16, 64, dtype=bf)
    with fake_cuda(monkeypatch) as lib:
        with pytest.raises(NotImplementedError, match="144 keys"):
            fused_halo_layer._cuda_fwd(*a, 2, None, None, "silu", 8, 4, 0.25, 1e-6,
                                       save=False)
        with pytest.raises(NotImplementedError, match="144 keys"):
            fused_halo._cuda_fwd(q, kv, a[12], 8, 3, 2, 0.25, save=False)
        assert not lib.calls


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
    assert err <= lim, f"{name}: {err:.3e} > {lim:.3e}"


# (B, H, W, C, heads, D, window, halo): a non-square map with 2·halo =
# window and heads 16 wide, 3x3 windows (25 keys) with heads 24 wide, and
# Halo-S's windows (64 queries, 144 keys) at heads 32 wide
CARD_SHAPES = [(3, 12, 8, 32, 2, 16, 4, 2), (2, 6, 9, 48, 2, 24, 3, 1),
               (2, 16, 16, 64, 2, 32, 8, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_cuda_b4_bf16_matches_plain(shape):
    needs_card()
    B, H, W, C, nh, D, window, halo = shape
    kw = dict(window=window, halo=halo)
    a, (r1, r2) = halo_inputs(*shape, device="cuda")
    do = torch.randn(a[0].shape, device="cuda").to(bf)
    fl = fused_halo_layer
    out, saved = fl.fused_halo_layer_fwd(*a, nh, r1, r2, **kw)
    grads = fl.fused_halo_layer_bwd(saved, do)
    again = fl.fused_halo_layer_bwd(saved, do)
    with torch.no_grad():
        serve = fl.fused_halo_layer(*a, nh, r1, r2, **kw)
    out_p, saved_p = fl.fused_halo_layer_fwd_reference(*a, nh, r1, r2, **kw)
    plain = fl.fused_halo_layer_bwd_reference(saved_p, do)
    within("out", out, out_p, FWD_TOL)
    within("out (serving)", serve, out_p, FWD_TOL)
    for name, k, k2, p in zip(fl.GRAD_NAMES, grads, again, plain):
        assert torch.equal(k, k2), name
        within(name, k, p, BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_cuda_halo_attention_direct_bf16_matches_plain(shape):
    needs_card()
    B, H, W, _, nh, D, window, halo = shape
    g = torch.Generator("cuda").manual_seed(2)
    q, kv, do = (torch.randn(B, H, W, c, device="cuda", generator=g).to(bf)
                 for c in (nh * D, 2 * nh * D, nh * D))
    k = window + 2 * halo
    bias = torch.randn(nh, window * window, k * k, device="cuda", generator=g)
    out, saved = fused_halo.halo_attention_direct_fwd(q, kv, bias, window, halo, nh)
    grads = fused_halo.halo_attention_direct_bwd(saved, do)
    again = fused_halo.halo_attention_direct_bwd(saved, do)
    C = nh * D
    out_p, lse_p = fused_halo.attention_fwd_reference(q, kv[..., :C], kv[..., C:], bias, nh,
                                                      window, halo, saved.scale)
    plain = fused_halo.halo_attention_direct_bwd_reference(
        fused_halo.DirectSaved(q, kv, bias, out_p, lse_p, window, halo, nh, saved.scale), do)
    within("out", out, out_p, FWD_TOL)
    within("lse", saved.lse, lse_p, FWD_TOL)
    for name, k_, k2, p in zip(("dq", "dkv", "dbias"), grads, again, plain):
        assert torch.equal(k_, k2), name
        within(name, k_, p, BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("window,halo", [(4, 3), (8, 2), (3, 1)])
def test_cuda_halo_attention_bf16_matches_plain(window, halo):
    needs_card()
    nh, D = 2, 16
    k = window + 2 * halo
    g = torch.Generator("cuda").manual_seed(3)
    q = torch.randn(37, window * window, nh * D, device="cuda", generator=g).to(bf)
    kv = torch.randn(37, k * k, 2 * nh * D, device="cuda", generator=g).to(bf)
    do = torch.randn(q.shape, device="cuda", generator=g).to(bf)
    bias = torch.randn(nh, window * window, k * k, device="cuda", generator=g)
    out, saved = fused_halo.halo_attention_fwd(q, kv, bias, nh)
    grads = fused_halo.halo_attention_bwd(saved, do)
    again = fused_halo.halo_attention_bwd(saved, do)
    out_p, lse_p = fused_halo.gathered_fwd_reference(q, kv, bias, nh, saved.scale)
    plain = fused_halo.gathered_bwd_reference(q, kv, bias, lse_p, do, nh, saved.scale)
    within("out", out, out_p, FWD_TOL)
    for name, k_, k2, p in zip(("dq", "dkv", "dbias"), grads, again, plain):
        assert torch.equal(k_, k2), name
        within(name, k_, p, BWD_TOL)
