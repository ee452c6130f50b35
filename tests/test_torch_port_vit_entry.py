"""ViT's dropout and FF-kernel paths through the port's entry point, and the
CUDA dispatch of the packed-qkv attention B3 (ops/fused_attention.py::
fused_attention_qkv) and the FF residual branch B7 (ops/fused_layer.py::
fused_ff_layer).  Imports no JAX, so the ``cuda``-marked tests run on a
card (README: the card-only tests).

- ``python -m vision_transformers_tpu_torch.train`` on configs/vit-s-16.conf
  with ``arch.dropout=0.1 arch.drop_ff=0.1``, shrunk to a tiny ViT on the
  CPU, one synthetic epoch, writes an ``epoch-001.pt`` that ``predict``
  serves.
- The CUDA wrappers, with the kernel library replaced by ctypes callbacks
  of the declared signatures (this machine has no card): each call passes
  every argument the C entries declare — the bias and its groups, the
  saves, the weight views' strides, the activation code, the split-K
  slabs — and counts one launch; what the kernels do not take raises.
- On a card (marker ``cuda``): the kernels against the plain versions,
  forward within 1e-4, each backward tensor within 1e-3·max(1, max|plain|)
  and bit-identical across two runs.
"""

import json
import os

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch import predict, train
from vision_transformers_tpu_torch.ops import fused_attention_mod as fa
from vision_transformers_tpu_torch.ops import fused_layer as fl
from vision_transformers_tpu_torch.utils.weights import seeded_images
from test_torch_port_halo_entry import fake_cuda

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, H = 4, 2  # the B3 calls
FB, FN, FC, FF = 3, 5, 16, 40  # the B7 calls
FORMS = [None, "nn", "hnn", "1nn", "grouped"]


def qkv_inputs(N, D, form, seed=0):
    """qkv [B, N, 3·H·D], the bias in ``form`` (or None) and an output grad."""
    rng = np.random.default_rng([seed, N, D])
    qkv = rng.normal(size=(B, N, 3 * H * D)).astype(np.float32)
    shape = {None: None, "nn": (N, N), "hnn": (H, N, N), "1nn": (1, N, N),
             "grouped": (2, H, N, N)}[form]
    extra = None if shape is None else (0.5 * rng.normal(size=shape)).astype(np.float32)
    do = rng.normal(size=(B, N, H * D)).astype(np.float32)
    return qkv, extra, do


def ff_inputs(biases=True, rs=True, seed=0):
    """x, ln_scale, ln_bias, w1 [C, F], b1, w2 [F, C], b2, row_scale (None
    where absent) and the output grad, scaled as chip_smoke.layer_args."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, mean=0.0):
        return (mean + s * rng.normal(size=shape)).astype(np.float32)

    a = [n(FB, FN, FC), n(FC, s=0.1, mean=1.0), n(FC, s=0.1), n(FC, FF, s=0.2),
         n(FF, s=0.1) if biases else None, n(FF, FC, s=0.2),
         n(FC, s=0.1) if biases else None,
         np.array([0.0, 1.25, 1.25], np.float32) if rs else None]
    return a, n(FB, FN, FC)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_trainer_with_dropout_writes_a_checkpoint_predict_serves(tmp_path, capsys):
    from PIL import Image

    conf = os.path.join(ROOT, "configs", "vit-s-16.conf")
    tiny = ["precision=f32", "training.epoch=1", "training.dataloader.batch_size=8",
            "data_backend=synthetic", "arch.depth=2", "arch.dim=64", "arch.n_head=2",
            "arch.dim_ff=128", "arch.image_size=32", "arch.window_size=8",
            "arch.dropout=0.1", "arch.drop_ff=0.1", "training.train_size=32",
            "training.valid_size=32", "log_freq=4"]
    metrics = train.main(["--conf", conf, "--device", "cpu", *tiny,
                          f"checker.storage=[{{type: local, path: {tmp_path}}}]"])
    assert all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss"))
    ckpt = tmp_path / "epoch-001.pt"
    files = []
    for i, img in enumerate(seeded_images(3, 2, 40)):
        files.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray(img).save(files[-1])
    capsys.readouterr()
    predict.main(["--conf", conf, "--checkpoint", f"{ckpt}:model", "--device", "cpu",
                  "--topk", "3", *files, *tiny[4:11]])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [e["file"] for e in lines] == files and all(len(e["topk"]) == 3 for e in lines)


# ---------------------------------------------------------------------------
# B3's CUDA dispatch, through ctypes callbacks of the declared signatures
# ---------------------------------------------------------------------------


def test_qkv_cuda_forward_and_backward_pass_every_argument(monkeypatch):
    qkv, extra, do = (torch.from_numpy(a) for a in qkv_inputs(37, 32, "grouped"))
    with fake_cuda(monkeypatch) as lib:
        before = fa.QKV_LAUNCHES, fa.QKV_BWD_LAUNCHES
        extra_g, G = fa.extra_groups(extra, B, H, 37)
        out, lse = fa._cuda_qkv_fwd(qkv, H, extra_g, 0.25, save=True)
        fwd = lib.calls["vtx_fused_attention_qkv_fwd"]
        serving, _ = fa._cuda_qkv_fwd(qkv, H, None, 0.25, save=False)
        plain = lib.calls["vtx_fused_attention_qkv_fwd"]
        saved = fa.QkvSaved(qkv, extra_g, out, lse, H, 0.25)
        dqkv, dextra = fa._cuda_qkv_bwd(saved, do, need_dextra=True)
        bwd = lib.calls["vtx_fused_attention_qkv_bwd"]
        _, no_dextra = fa._cuda_qkv_bwd(saved, do, need_dextra=False)
        bwd_nd = lib.calls["vtx_fused_attention_qkv_bwd"]
    assert (fa.QKV_LAUNCHES, fa.QKV_BWD_LAUNCHES) == (before[0] + 2, before[1] + 2)
    assert fwd[:5] == (qkv.data_ptr(), extra_g.data_ptr(), 2, out.data_ptr(),
                       lse.data_ptr())
    assert fwd[5:9] == (B, 37, H, 32) and abs(fwd[9] - 0.25) < 1e-7
    assert plain[1] is None and plain[2] == 1 and plain[4] is None
    assert out.shape == (B, 37, H * 32) and lse.shape == (B, H, 37)
    assert bwd[:6] == (qkv.data_ptr(), extra_g.data_ptr(), 2, out.data_ptr(),
                       lse.data_ptr(), do.data_ptr())
    assert bwd[8:10] == (dqkv.data_ptr(), dextra.data_ptr()) and bwd[10:14] == (B, 37, H, 32)
    assert bwd[7] is not None and dqkv.shape == qkv.shape and dextra.shape == (2, H, 37, 37)
    assert no_dextra is None and bwd_nd[7] is None and bwd_nd[9] is None


def test_qkv_cuda_refuses_what_the_kernels_do_not_take(monkeypatch):
    qkv, extra, _ = (torch.from_numpy(a) for a in qkv_inputs(37, 64, "grouped"))
    extra_g, _ = fa.extra_groups(extra, B, H, 37)
    with fake_cuda(monkeypatch) as lib:  # a bias with heads 64 wide passes its pointer
        fa._cuda_qkv_fwd(qkv, H, extra_g, 0.125, save=False)
    assert lib.calls["vtx_fused_attention_qkv_fwd"][1:3] == (extra_g.data_ptr(), 2)
    wide = torch.zeros(B, 37, 3 * H * 80)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="64 wide"):
        fa._cuda_qkv_fwd(wide, H, None, 0.1, save=False)
    wide_g, _ = fa.extra_groups(torch.zeros(2, H, 37, 37), B, H, 37)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="64 wide"):
        fa._cuda_qkv_fwd(wide, H, wide_g, 0.1, save=False)  # heads over 64 with a bias
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="contiguous"):
        fa._cuda_qkv_fwd(qkv.transpose(0, 1), H, None, 0.1, save=False)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="float32"):
        fa._cuda_qkv_fwd(qkv.double(), H, None, 0.1, save=False)
    small, e3, _ = (torch.from_numpy(a) if a is not None else None
                    for a in qkv_inputs(37, 32, "grouped"))
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="extra must be"):
        fa._cuda_qkv_fwd(small, H, torch.zeros(3, H, 37, 37), 0.1, save=False)


@pytest.mark.parametrize("N", [37, 197])
def test_qkv_cuda_passes_the_wide_bias_and_its_gradient(monkeypatch, N):
    """The grouped bias with heads 64 wide, forward and backward: its
    pointer and groups, the dS buffer and dextra; past 64 tokens the dq
    key-tile partials."""
    qkv, extra, do = (torch.from_numpy(a) for a in qkv_inputs(N, 64, "grouped"))
    extra_g, _ = fa.extra_groups(extra, B, H, N)
    with fake_cuda(monkeypatch) as lib:
        out, lse = fa._cuda_qkv_fwd(qkv, H, extra_g, 0.125, save=True)
        fwd = lib.calls["vtx_fused_attention_qkv_fwd"]
        saved = fa.QkvSaved(qkv, extra_g, out, lse, H, 0.125)
        dqkv, dextra = fa._cuda_qkv_bwd(saved, do, need_dextra=True)
        bwd = lib.calls["vtx_fused_attention_qkv_bwd"]
    assert fwd[1:5] == (extra_g.data_ptr(), 2, out.data_ptr(), lse.data_ptr())
    assert fwd[5:9] == (B, N, H, 64)
    assert bwd[1:3] == (extra_g.data_ptr(), 2) and bwd[7] is not None
    assert (bwd[6] is not None) == (N > 64)  # dq partials past one key tile
    assert bwd[8:10] == (dqkv.data_ptr(), dextra.data_ptr()) and bwd[10:14] == (B, N, H, 64)
    assert dextra.shape == (2, H, N, N)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f or "no-bias")
def test_qkv_cuda_kernels_match_plain(form):
    """Forward within 1e-4, backward per tensor within 1e-3·max(1,
    max|plain|) and bit-identical across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    qkv, extra, do = qkv_inputs(37, 64 if form is None else 32, form)
    q, do = torch.from_numpy(qkv).cuda(), torch.from_numpy(do).cuda()
    e = None if extra is None else torch.from_numpy(extra).cuda()
    out, saved = fa.fused_attention_qkv_fwd(q, H, e)
    grads = fa.fused_attention_qkv_bwd(saved, do)
    again = fa.fused_attention_qkv_bwd(saved, do)
    out_p, saved_p = fa.fused_attention_qkv_fwd(q.cpu(), H, None if e is None else e.cpu())
    plain = fa.fused_attention_qkv_bwd(saved_p, do.cpu())
    torch.testing.assert_close(out.cpu(), out_p, atol=1e-4, rtol=1e-4)
    for k, k2, p in zip(grads, again, plain):
        if p is None:
            assert k is None
            continue
        assert torch.equal(k, k2)
        assert (k.cpu() - p).abs().max().item() <= 1e-3 * max(1.0, p.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("N", [37, 150])
@pytest.mark.parametrize("form", ["hnn", "grouped"])
def test_qkv_cuda_kernels_match_plain_with_a_wide_bias(form, N):
    """The bias with heads 64 wide on the card (one and three key tiles):
    forward within 1e-4, dqkv and dextra within 1e-3·max(1, max|plain|),
    bit-identical across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    qkv, extra, do = qkv_inputs(N, 64, form)
    q, do, e = (torch.from_numpy(a).cuda() for a in (qkv, do, extra))
    out, saved = fa.fused_attention_qkv_fwd(q, H, e)
    grads = fa.fused_attention_qkv_bwd(saved, do)
    again = fa.fused_attention_qkv_bwd(saved, do)
    out_p, saved_p = fa.fused_attention_qkv_fwd(q.cpu(), H, e.cpu())
    plain = fa.fused_attention_qkv_bwd(saved_p, do.cpu())
    torch.testing.assert_close(out.cpu(), out_p, atol=1e-4, rtol=1e-4)
    for k, k2, p in zip(grads, again, plain):
        assert torch.equal(k, k2)
        assert (k.cpu() - p).abs().max().item() <= 1e-3 * max(1.0, p.abs().max().item())


# ---------------------------------------------------------------------------
# B7's CUDA dispatch
# ---------------------------------------------------------------------------


def cuda_args(biases=True, rs=True):
    a, do = ff_inputs(biases, rs)
    t = [None if v is None else torch.from_numpy(v) for v in a]
    # the model's [in, out] views of torch [out, in] weights
    t[3], t[5] = t[3].t().contiguous().t(), t[5].t().contiguous().t()
    return t, torch.from_numpy(do)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ff_cuda_forward_and_backward_pass_every_argument(monkeypatch, act):
    t, do = cuda_args()
    with fake_cuda(monkeypatch) as lib:
        before = fl.FF_LAUNCHES, fl.FF_BWD_LAUNCHES
        fl._cuda_ff_fwd(*t[:7], act, t[7], 1e-6, save=False)
        serving = lib.calls["vtx_fused_ff_layer_fwd"]
        out, (hid, mu, rstd) = fl._cuda_ff_fwd(*t[:7], act, t[7], 1e-6, save=True)
        training = lib.calls["vtx_fused_ff_layer_fwd"]
        saved = fl.FFSaved(*t, hid, mu, rstd, act, 1e-6)
        grads = fl._cuda_ff_bwd(saved, do, need_drs=True)
        bwd = lib.calls["vtx_fused_ff_layer_bwd"]
    assert (fl.FF_LAUNCHES, fl.FF_BWD_LAUNCHES) == (before[0] + 2, before[1] + 1)
    code = fl.ACTIVATIONS[act]
    for call in (serving, training):
        assert call[3:6] == (t[3].data_ptr(), *t[3].stride())  # the view's strides
        assert call[7:10] == (t[5].data_ptr(), *t[5].stride())
        assert call[11] == t[7].data_ptr()
        assert call[18:23] == (FB, FN, FC, FF, code)
    assert serving[14:17] == (None, None, None)  # af, mu, rstd: no saves
    assert all(p is not None for p in training[14:17])
    assert hid.shape == (FB, FN, FF) and mu.shape == rstd.shape == (FB, FN)
    assert bwd[12:16] == (hid.data_ptr(), mu.data_ptr(), rstd.data_ptr(), do.data_ptr())
    assert bwd[16] is not None  # da: the row scale's workspace
    assert bwd[22:24] == (fl._splits(FC, FF, FB * FN), fl._splits(FF, FC, FB * FN))
    dx, dg, db, dw1, db1, dw2, db2, drs = grads
    assert bwd[25:28] == (dx.data_ptr(), dg.data_ptr(), db.data_ptr())
    assert bwd[31] == db1.data_ptr() and bwd[35:37] == (db2.data_ptr(), drs.data_ptr())
    assert bwd[37:42] == (FB, FN, FC, FF, code)
    # the weight gradients come back in the weight views' layout
    assert dw1.shape == t[3].shape and dw1.stride() == t[3].stride()
    assert dw2.shape == t[5].shape and dw2.stride() == t[5].stride()


def test_ff_cuda_optional_inputs_pass_null(monkeypatch):
    t, do = cuda_args(biases=False, rs=False)
    with fake_cuda(monkeypatch) as lib:
        out, saves = fl._cuda_ff_fwd(*t[:7], "silu", None, 1e-6, save=True)
        fwd = lib.calls["vtx_fused_ff_layer_fwd"]
        grads = fl._cuda_ff_bwd(fl.FFSaved(*t, *saves, "silu", 1e-6), do, True)
        bwd = lib.calls["vtx_fused_ff_layer_bwd"]
    assert fwd[6] is None and fwd[10] is None and fwd[11] is None  # b1, b2, rs
    assert bwd[16] is None and bwd[31] is None and bwd[35] is None and bwd[36] is None
    assert grads[4] is None and grads[6] is None and grads[7] is None


def test_ff_cuda_refuses_what_the_kernels_do_not_take(monkeypatch):
    t, _ = cuda_args()
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="silu"):
        fl._cuda_ff_fwd(*t[:7], "relu", t[7], 1e-6, save=False)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="float32"):
        fl._cuda_ff_fwd(t[0].double(), *t[1:7], "silu", t[7], 1e-6, save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="contiguous"):
        fl._cuda_ff_fwd(t[0].transpose(0, 1), *t[1:7], "silu", None, 1e-6, save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="w2 must be"):
        fl._cuda_ff_fwd(*t[:5], t[5][:-1], t[6], "silu", t[7], 1e-6, save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="row_scale"):
        fl._cuda_ff_fwd(*t[:7], "silu", t[7][:2], 1e-6, save=False)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("rs", [True, False], ids=["rs", "no-rs"])
def test_ff_cuda_kernels_match_plain(act, rs):
    """Forward within 1e-4, backward per tensor within 1e-3·max(1,
    max|plain|) and bit-identical across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    t, do = cuda_args(rs=rs)
    dev = [None if v is None else v.cuda() for v in t]
    out, saved = fl.fused_ff_layer_fwd(*dev[:7], act, dev[7])
    grads = fl.fused_ff_layer_bwd(saved, do.cuda())
    again = fl.fused_ff_layer_bwd(saved, do.cuda())
    out_p, saved_p = fl.fused_ff_layer_fwd(*t[:7], act, t[7])
    plain = fl.fused_ff_layer_bwd(saved_p, do)
    torch.testing.assert_close(out.cpu(), out_p, atol=1e-4, rtol=1e-4)
    for k, k2, p in zip(grads, again, plain):
        if p is None:
            assert k is None
            continue
        assert torch.equal(k, k2)
        assert (k.cpu() - p).abs().max().item() <= 1e-3 * max(1.0, p.abs().max().item())
