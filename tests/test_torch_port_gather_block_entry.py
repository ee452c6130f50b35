"""Halo's gather path and ViT's block path through the port's entry points,
and the CUDA dispatch of the gathered halo attention B5b (ops/fused_halo.py::
halo_attention) and the attention block B8 (ops/fused_block.py::
fused_attention_block).  Imports no JAX, so the ``cuda``-marked tests run on
a card (README: the card-only tests).

- ``python -m vision_transformers_tpu_torch.train`` on
  tests/data/halo_s_port.conf shrunk to a tiny Halo with window 4 and halo 3
  on the CPU, with no force (the default dispatch takes the gathered op),
  and on configs/vit-s-16.conf shrunk to a tiny ViT under
  ``ops.set_attention_impl("block")`` with dropout: each writes an
  ``epoch-001.pt`` that ``predict`` serves.
- The CUDA wrappers, with the kernel library replaced by ctypes callbacks
  of the declared signatures (this machine has no card): each call passes
  every argument the C entries declare — the gathered geometry and the dbias
  chunks, the weight views' strides, the bias and its groups (at heads up
  to 64 wide on B8), the saves, the split-K slabs, B8's dq partials past
  one key tile — and counts one launch; what the kernels do not take
  raises.
- On a card (marker ``cuda``): both kernels against their plain versions,
  forward within 1e-4, each backward tensor within 1e-3·max(1, max|plain|)
  and bit-identical across two runs.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_port_halo_entry import CONF as HALO_CONF
from test_torch_port_halo_entry import TINY as HALO_TINY
from test_torch_port_halo_entry import fake_cuda
from vision_transformers_tpu_torch import ops, predict, train
from vision_transformers_tpu_torch.ops import fused_block as fb
from vision_transformers_tpu_torch.ops import fused_halo
from vision_transformers_tpu_torch.utils.weights import seeded_images

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
VIT_CONF = os.path.join(ROOT, "configs", "vit-s-16.conf")


def serve(tmp_path, capsys, conf, ckpt, size, overrides):
    from PIL import Image

    files = []
    for i, img in enumerate(seeded_images(3, 2, size)):
        files.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray(img).save(files[-1])
    capsys.readouterr()
    predict.main(["--conf", conf, "--checkpoint", f"{ckpt}:model", "--device", "cpu",
                  "--topk", "3", *files, *overrides])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [e["file"] for e in lines] == files and all(len(e["topk"]) == 3 for e in lines)


def test_halo_trainer_with_a_wide_halo_takes_the_gathered_op(tmp_path, capsys, monkeypatch):
    calls = []
    fn = fused_halo.halo_attention_fwd
    monkeypatch.setattr(fused_halo, "halo_attention_fwd",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    wide = [o for o in HALO_TINY if not o.startswith((
        "arch.window_size", "arch.halo_size", "arch.image_size", "training.train_size",
        "training.valid_size"))]
    wide += ["arch.image_size=128", "arch.window_size=4", "arch.halo_size=3",
             "training.train_size=128", "training.valid_size=128"]
    metrics = train.main(["--conf", HALO_CONF, "--device", "cpu", *wide,
                          f"checker.storage=[{{type: local, path: {tmp_path}}}]"])
    assert all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss"))
    assert len(calls) == 8 * 4  # 8 steps (64 images in batches of 8) x 4 layers
    serve(tmp_path, capsys, HALO_CONF, tmp_path / "epoch-001.pt", 160,
          [o for o in wide[4:] if o.startswith("arch.")])


def test_vit_trainer_under_the_block_force(tmp_path, capsys, monkeypatch):
    calls = []
    fn = fb.fused_attention_block_fwd
    monkeypatch.setattr(fb, "fused_attention_block_fwd",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    tiny = ["precision=f32", "training.epoch=1", "training.dataloader.batch_size=8",
            "data_backend=synthetic", "arch.depth=2", "arch.dim=64", "arch.n_head=2",
            "arch.dim_ff=128", "arch.image_size=32", "arch.window_size=8",
            "arch.dropout=0.1", "arch.drop_ff=0.1", "training.train_size=32",
            "training.valid_size=32", "log_freq=4"]
    ops.set_attention_impl("block")
    try:
        metrics = train.main(["--conf", VIT_CONF, "--device", "cpu", *tiny,
                              f"checker.storage=[{{type: local, path: {tmp_path}}}]"])
        assert all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss"))
        assert len(calls) == 8 * 2  # 8 steps (64 images in batches of 8) x 2 layers
        serve(tmp_path, capsys, VIT_CONF, tmp_path / "epoch-001.pt", 40, tiny[4:11])
    finally:
        ops.set_attention_impl(None)


# ---------------------------------------------------------------------------
# B5b's CUDA dispatch, through ctypes callbacks of the declared signatures
# ---------------------------------------------------------------------------


def gather_inputs(B=5, M=16, N=100, nh=2, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((B, M, nh * D), (B, N, 2 * nh * D), (nh, M, N), (B, M, nh * D))]


def test_gather_cuda_forward_and_backward_pass_every_argument(monkeypatch):
    q, kv, bias, do = gather_inputs()
    with fake_cuda(monkeypatch) as lib:
        before = fused_halo.HALO_GATHER_LAUNCHES, fused_halo.HALO_GATHER_BWD_LAUNCHES
        out, lse = fused_halo._cuda_gathered_fwd(q, kv, bias, 2, 0.3, save=True)
        fwd = lib.calls["vtx_halo_attention_fwd"]
        fused_halo._cuda_gathered_fwd(q, kv, bias, 2, 0.3, save=False)
        serving = lib.calls["vtx_halo_attention_fwd"]
        saved = fused_halo.GatherSaved(q, kv, bias, out, lse, 2, 0.3)
        dq, dkv, dbias = fused_halo._cuda_gathered_bwd(saved, do)
        bwd = lib.calls["vtx_halo_attention_bwd"]
    assert (fused_halo.HALO_GATHER_LAUNCHES, fused_halo.HALO_GATHER_BWD_LAUNCHES) == \
        (before[0] + 2, before[1] + 1)
    assert fwd[:5] == (q.data_ptr(), kv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                       lse.data_ptr())
    assert fwd[5:10] == (5, 16, 100, 2, 8) and abs(fwd[10] - 0.3) < 1e-7
    assert serving[4] is None and lse.shape == (5, 2, 16) and out.shape == q.shape
    assert bwd[:6] == (q.data_ptr(), kv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                       lse.data_ptr(), do.data_ptr())
    assert bwd[7] == fused_halo._chunks(5, 2, 100, 8) == 5  # at most one chunk per window
    assert bwd[8] is None  # one key tile: no dq partials
    assert bwd[9:12] == (dq.data_ptr(), dkv.data_ptr(), dbias.data_ptr())
    assert bwd[12:17] == (5, 16, 100, 2, 8)
    assert dq.shape == q.shape and dkv.shape == kv.shape and dbias.shape == bias.shape


def test_gather_cuda_refuses_what_the_kernels_do_not_take(monkeypatch):
    q, kv, bias, _ = gather_inputs()
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="ROADMAP B"):
        fused_halo._cuda_gathered_fwd(*gather_inputs(M=81)[:3], 2, 0.3, save=False)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="ROADMAP B"):
        fused_halo._cuda_gathered_fwd(*gather_inputs(D=72)[:3], 2, 0.3, save=False)
    with fake_cuda(monkeypatch) as lib:  # heads 40 wide: the kernels' 64-wide tiles
        wide = gather_inputs(D=40)
        out, lse = fused_halo._cuda_gathered_fwd(*wide[:3], 2, 0.3, save=True)
        assert lib.calls["vtx_halo_attention_fwd"][5:10] == (5, 16, 100, 2, 40)
        dq, dkv, _ = fused_halo._cuda_gathered_bwd(
            fused_halo.GatherSaved(*wide[:3], out, lse, 2, 0.3), wide[3])
        bwd = lib.calls["vtx_halo_attention_bwd"]
        assert bwd[8] is not None and bwd[9:11] == (dq.data_ptr(), dkv.data_ptr())
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="bias must be"):
        fused_halo._cuda_gathered_fwd(q, kv, bias[:, :, :64], 2, 0.3, save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="kv must be"):
        fused_halo._cuda_gathered_fwd(q, kv[..., :16].contiguous(), bias, 2, 0.3,
                                      save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="contiguous"):
        fused_halo._cuda_gathered_fwd(q.transpose(0, 1), kv, bias, 2, 0.3, save=False)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="float32"):
        fused_halo._cuda_gathered_fwd(q.double(), kv, bias, 2, 0.3, save=False)


# ---------------------------------------------------------------------------
# B8's CUDA dispatch
# ---------------------------------------------------------------------------


def block_inputs(B=4, N=13, C=16, H=2, D=8, cout=24, form="grouped", biases=True,
                 seed=0):
    """x, wqkv and wout as the models' [in, out] views of torch [out, in]
    weights, bqkv, bout (None without ``biases``), the bias (grouped [2, H,
    N, N], [N, N] or None) and an output grad."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32))

    HD = H * D
    extra = {"grouped": lambda: n(2, H, N, N, s=0.5), "nn": lambda: n(N, N, s=0.5),
             None: lambda: None}[form]()
    return [n(B, N, C), n(3 * HD, C, s=0.2).t(), n(3 * HD, s=0.1) if biases else None,
            n(cout, HD, s=0.2).t(), n(cout, s=0.1) if biases else None, extra], \
        n(B, N, cout)


def test_block_cuda_forward_and_backward_pass_every_argument(monkeypatch):
    (x, wqkv, bqkv, wout, bout, extra), do = block_inputs()
    extra_g, G = fb.extra_groups(extra, 4, 2, 13)
    with fake_cuda(monkeypatch) as lib:
        before = fb.BLOCK_LAUNCHES, fb.BLOCK_BWD_LAUNCHES
        out, (qkv, acc, lse) = fb._cuda_fwd(x, wqkv, bqkv, wout, bout, 2, extra_g, 0.25,
                                            save=True)
        fwd = lib.calls["vtx_fused_attention_block_fwd"]
        fb._cuda_fwd(x, wqkv, None, wout, None, 2, None, 0.25, save=False)
        serving = lib.calls["vtx_fused_attention_block_fwd"]
        saved = fb.BlockSaved(x, wqkv, bqkv, wout, bout, extra_g, qkv, acc, lse, 2, 0.25)
        grads = fb._cuda_bwd(saved, do, need_dextra=True)
        bwd = lib.calls["vtx_fused_attention_block_bwd"]
        _, _, _, _, _, no_dextra = fb._cuda_bwd(saved, do, need_dextra=False)
        bwd_nd = lib.calls["vtx_fused_attention_block_bwd"]
    assert (fb.BLOCK_LAUNCHES, fb.BLOCK_BWD_LAUNCHES) == (before[0] + 2, before[1] + 2)
    assert fwd[:5] == (x.data_ptr(), wqkv.data_ptr(), *wqkv.stride(), bqkv.data_ptr())
    assert fwd[5:9] == (wout.data_ptr(), *wout.stride(), bout.data_ptr())
    assert fwd[9:15] == (extra_g.data_ptr(), 2, qkv.data_ptr(), acc.data_ptr(),
                         lse.data_ptr(), out.data_ptr())
    assert fwd[15:21] == (4, 13, 16, 2, 8, 24) and abs(fwd[21] - 0.25) < 1e-7
    assert (serving[4], serving[8], serving[9], serving[10], serving[13]) == \
        (None, None, None, 1, None)
    assert out.shape == (4, 13, 24) and qkv.shape == (4, 13, 48) and lse.shape == (4, 2, 13)
    dx, dwqkv, dbqkv, dwout, dbout, dextra = grads
    assert bwd[:7] == (x.data_ptr(), wqkv.data_ptr(), *wqkv.stride(), wout.data_ptr(),
                       *wout.stride())
    assert bwd[7:13] == (extra_g.data_ptr(), 2, qkv.data_ptr(), acc.data_ptr(),
                         lse.data_ptr(), do.data_ptr())
    assert bwd[18:20] == (fb._splits(16, 24, 52), fb._splits(16, 48, 52))
    assert bwd[21:22] == (dx.data_ptr(),) and bwd[25] == dbqkv.data_ptr()
    assert bwd[29:31] == (dbout.data_ptr(), dextra.data_ptr())
    assert bwd[31:37] == (4, 13, 16, 2, 8, 24)
    assert bwd[16] is not None and bwd_nd[16] is None and bwd_nd[30] is None
    assert bwd[13] is not None and bwd[15] is not None  # dacc, dqkv
    assert bwd[14] is None  # one key tile: no dq partials
    assert no_dextra is None and dextra.shape == (2, 2, 13, 13)
    # the weight gradients come back in the weight views' layout
    assert dwqkv.shape == wqkv.shape and dwqkv.stride() == wqkv.stride()
    assert dwout.shape == wout.shape and dwout.stride() == wout.stride()


@pytest.mark.parametrize("N", [13, 70], ids=["one-key-tile", "two-key-tiles"])
def test_block_cuda_takes_a_grouped_bias_on_heads_64_wide(monkeypatch, N):
    # the attention runs on attention_tc.cuh, which takes the bias at heads
    # up to 64 wide; past one 64-key tile the backward gets the dq partials'
    # workspace
    (x, wqkv, bqkv, wout, bout, extra), do = block_inputs(N=N, C=128, D=64)
    extra_g, G = fb.extra_groups(extra, 4, 2, N)
    with fake_cuda(monkeypatch) as lib:
        out, (qkv, acc, lse) = fb._cuda_fwd(x, wqkv, bqkv, wout, bout, 2, extra_g, 0.125,
                                            save=True)
        fwd = lib.calls["vtx_fused_attention_block_fwd"]
        saved = fb.BlockSaved(x, wqkv, bqkv, wout, bout, extra_g, qkv, acc, lse, 2, 0.125)
        *_, dextra = fb._cuda_bwd(saved, do, need_dextra=True)
        bwd = lib.calls["vtx_fused_attention_block_bwd"]
    assert G == 2 and fwd[9:11] == (extra_g.data_ptr(), 2)
    assert fwd[15:21] == (4, N, 128, 2, 64, 24)
    assert bwd[7:9] == (extra_g.data_ptr(), 2) and bwd[30] == dextra.data_ptr()
    assert (bwd[14] is not None) == (N > 64)  # dq partials past one key tile
    assert bwd[31:37] == (4, N, 128, 2, 64, 24)
    assert out.shape == (4, N, 24) and dextra.shape == (2, 2, N, N)


def test_block_cuda_refuses_what_the_kernels_do_not_take(monkeypatch):
    (x, wqkv, bqkv, wout, bout, _), _ = block_inputs()
    wide, _ = block_inputs(C=128, D=64, form="nn")
    wide_g, _ = fb.extra_groups(wide[5], 4, 2, 13)
    with fake_cuda(monkeypatch) as lib:  # a bias at D = 64: taken since the
        fb._cuda_fwd(*wide[:5], 2, wide_g, 0.125, save=False)  # tensor-core attention
    assert lib.calls["vtx_fused_attention_block_fwd"][19] == 64
    fatter, _ = block_inputs(C=160, D=80, form=None)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="64 wide"):
        fb._cuda_fwd(*fatter[:5], 2, None, 0.1, save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="contiguous"):
        fb._cuda_fwd(x.transpose(0, 1), wqkv, bqkv, wout, bout, 2, None, 0.1, save=False)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="float32"):
        fb._cuda_fwd(x.double(), wqkv, bqkv, wout, bout, 2, None, 0.1, save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="bout must be"):
        fb._cuda_fwd(x, wqkv, bqkv, wout, bout[:-1], 2, None, 0.1, save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="extra must be"):
        fb._cuda_fwd(x, wqkv, bqkv, wout, bout, 2, torch.zeros(3, 2, 13, 13), 0.1,
                     save=False)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _compare(out, out_p, grads, again, plain):
    torch.testing.assert_close(out.cpu(), out_p, atol=1e-4, rtol=1e-4)
    for k, k2, p in zip(grads, again, plain):
        if p is None:
            assert k is None
            continue
        assert torch.equal(k, k2)
        assert (k.cpu() - p).abs().max().item() <= 1e-3 * max(1.0, p.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,D", [(64, 144, 32), (16, 100, 24), (16, 100, 32), (64, 144, 64),
                                   (64, 324, 32)],
                         ids=["w8-h2", "w4-h3", "w4-h3-d32", "w8-h2-d64", "w8-h5-streamed"])
def test_gather_cuda_kernels_match_plain(M, N, D):
    """Forward within 1e-4, backward per tensor within 1e-3·max(1,
    max|plain|) and bit-identical across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    q, kv, bias, do = gather_inputs(B=37, M=M, N=N, nh=3, D=D)
    dev = [t.cuda() for t in (q, kv, bias, do)]
    out, saved = fused_halo.halo_attention_fwd(*dev[:3], 3)
    grads = fused_halo.halo_attention_bwd(saved, dev[3])
    again = fused_halo.halo_attention_bwd(saved, dev[3])
    out_p, saved_p = fused_halo.halo_attention_fwd(q, kv, bias, 3)
    _compare(out, out_p, grads, again, fused_halo.halo_attention_bwd(saved_p, do))


@pytest.mark.cuda
@pytest.mark.parametrize("form,biases,D", [(None, True, 64), ("grouped", True, 32),
                                           ("nn", False, 16), ("grouped", True, 64),
                                           ("nn", True, 64)])
def test_block_cuda_kernels_match_plain(form, biases, D):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, do = block_inputs(B=6, N=37, C=48, H=2, D=D, cout=40, form=form, biases=biases)
    dev = [None if t is None else t.cuda() for t in args]
    out, saved = fb.fused_attention_block_fwd(*dev[:5], 2, dev[5])
    grads = fb.fused_attention_block_bwd(saved, do.cuda())
    again = fb.fused_attention_block_bwd(saved, do.cuda())
    out_p, saved_p = fb.fused_attention_block_fwd(*args[:5], 2, args[5])
    _compare(out, out_p, grads, again, fb.fused_attention_block_bwd(saved_p, do))
