"""Swin through the port's entry points, and the whole-layer op's CUDA
dispatch with Swin's arguments.

- ``python -m vision_transformers_tpu_torch.train`` on
  configs/swin-transformer-s.conf, shrunk to a tiny Swin on the CPU (the
  conf's grad_accumulation 2 and drop_path 0.3 kept), writes an
  ``epoch-001.pt`` that ``predict`` serves.
- The CUDA wrappers of ``fused_transformer_layer`` take the grouped bias
  and both row scales, forward and backward: with the kernel library
  replaced by ctypes callbacks of the declared signatures (this machine has
  no card), each call passes every argument the C entry declares, the bias
  and its group count, and the row scales.
- On a card (marker ``cuda``): the forward with saves and the backward
  against the plain versions, with the grouped bias and both row scales,
  bit-identical across two runs.
"""

import contextlib
import ctypes
import json
import os

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch import predict, train
from vision_transformers_tpu_torch.ops import _build, fused_layer1
from vision_transformers_tpu_torch.utils.weights import seeded_images
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONF = os.path.join(ROOT, "configs", "swin-transformer-s.conf")
TINY = ["precision=f32", "training.epoch=1", "training.dataloader.batch_size=8",
        "data_backend=synthetic", "arch.image_size=[64, 64]", "arch.window_size=2",
        "arch.depths=[2, 2, 2, 2]", "arch.dims=[8, 16, 32, 64]", "arch.dim_head=4",
        "arch.n_heads=[2, 4, 8, 16]", "arch.dim_ffs=[32, 64, 128, 256]",
        "arch.n_class=10", "training.train_size=64", "training.valid_size=64",
        "log_freq=4"]


def test_trainer_writes_a_checkpoint_predict_serves(tmp_path, capsys):
    from PIL import Image

    metrics = train.main(["--conf", CONF, "--device", "cpu", *TINY,
                          f"checker.storage=[{{type: local, path: {tmp_path}}}]"])
    assert all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss"))
    ckpt = tmp_path / "epoch-001.pt"
    obj = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert sorted(obj) == ["epoch", "model", "optimizer"]
    assert any(k.endswith("attn.rel_pos.weight") for k in obj["model"])
    files = []
    for i, img in enumerate(seeded_images(3, 2, 80)):
        files.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray(img).save(files[-1])
    capsys.readouterr()
    predict.main(["--conf", CONF, "--checkpoint", f"{ckpt}:model", "--device", "cpu",
                  "--topk", "3", *files, *TINY[4:14]])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [e["file"] for e in lines] == files
    assert all(len(e["topk"]) == 3 for e in lines)


# ---------------------------------------------------------------------------
# the CUDA dispatch, through ctypes callbacks of the declared signatures
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


def swin_inputs(G=2, images=2, m=8, C=16, H=2, D=8, F=32, seed=0):
    """Inputs scaled as chip_smoke.py's ``layer_args`` (LayerNorm scales near
    1, weights std 0.05): with std-1 weights the outputs reach a few hundred
    and the scores saturate the softmax, where f32 summation order alone
    moves the output by more than the kernel tests' 1e-4."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, mean=0.0):
        return torch.from_numpy((mean + s * rng.normal(size=shape)).astype(np.float32))

    B, HD = G * images, H * D
    args = [n(B, m, C), n(C, s=0.1, mean=1.0), n(C, s=0.1), n(C, 3 * HD, s=0.05),
            n(3 * HD, s=0.1), n(HD, C, s=0.05), n(C, s=0.1), n(C, s=0.1, mean=1.0),
            n(C, s=0.1), n(C, F, s=0.05), n(F, s=0.1), n(F, C, s=0.05), n(C, s=0.1)]
    return args, n(G, H, m, m), n(images).repeat(G), n(images).repeat(G)


def test_cuda_forward_takes_bias_and_row_scales(monkeypatch):
    args, extra, r1, r2 = swin_inputs()
    B, N, C = args[0].shape
    with fake_cuda(monkeypatch) as lib:
        before = fused_layer1.LAUNCHES
        fused_layer1._cuda_fwd(*args, 2, extra, 2, r1, r2, "silu", 0.25, 1e-6, save=False)
        serving = lib.calls["vtx_fused_transformer_layer_fwd"]
        out, saves = fused_layer1._cuda_fwd(*args, 2, extra, 2, r1, r2, "silu", 0.25,
                                            1e-6, save=True)
        training = lib.calls["vtx_fused_transformer_layer_fwd"]
    assert fused_layer1.LAUNCHES == before + 2
    for call in (serving, training):
        assert call[21:25] == (extra.data_ptr(), 2, r1.data_ptr(), r2.data_ptr())
        assert call[37:43] == (B, N, C, 2, 8, 32)
    assert serving[30:36] == (None,) * 6  # af and the statistics: no saves
    assert all(p is not None for p in training[30:36])
    assert len(saves) == 9 and saves[3].shape == (B, N, 32)  # hid kept for the backward


def test_cuda_backward_takes_bias_and_row_scales(monkeypatch):
    args, extra, r1, r2 = swin_inputs()
    with fake_cuda(monkeypatch) as lib:
        _, res = fused_layer1._cuda_fwd(*args, 2, extra, 2, r1, r2, "silu", 0.25, 1e-6,
                                        save=True)
        saved = fused_layer1.L1Saved(*args, extra, r1, r2, *res, 2, "silu", 0.25, 1e-6)
        before = fused_layer1.BWD_LAUNCHES
        grads = fused_layer1._cuda_bwd(saved, torch.zeros_like(args[0]), (True, True), True)
        call = lib.calls["vtx_fused_transformer_layer_bwd"]
    assert fused_layer1.BWD_LAUNCHES == before + 1
    assert call[21:25] == (extra.data_ptr(), 2, r1.data_ptr(), r2.data_ptr())
    dextra, drs_attn, drs_ff = grads[13:]
    assert dextra.shape == extra.shape and drs_attn.shape == drs_ff.shape == (4,)
    assert call[72:75] == (dextra.data_ptr(), drs_attn.data_ptr(), drs_ff.data_ptr())
    assert call[44] is not None  # the dbias partials of the window attention
    # without a bias gradient or row-scale gradients asked for: null pointers
    grads = fused_layer1._cuda_bwd(saved, torch.zeros_like(args[0]), (False, False), False)
    assert grads[13:] == (None, None, None)
    assert lib.calls["vtx_fused_transformer_layer_bwd"][72:75] == (None, None, None)


def test_cuda_refuses_what_the_kernel_does_not_take(monkeypatch):
    args, extra, r1, r2 = swin_inputs()
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="silu"):
        fused_layer1._cuda_fwd(*args, 2, extra, 2, r1, r2, "gelu", 0.25, 1e-6, save=False)
    wide, wextra, _, _ = swin_inputs(D=40)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="32 wide"):
        fused_layer1._cuda_fwd(*wide, 2, wextra, 2, None, None, "silu", 0.25, 1e-6,
                               save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="extra must be"):
        fused_layer1._cuda_fwd(*args, 2, extra[:, :1], 2, None, None, "silu", 0.25, 1e-6,
                               save=False)


@pytest.mark.cuda
@pytest.mark.parametrize("use_rs", [False, True])
def test_cuda_whole_layer_backward_matches_plain(use_rs):
    """Forward with saves + backward kernel against the plain versions on
    the card, with the grouped bias; bit-identical from run to run.  Limit
    1e-3·max(1, max|plain|) per tensor: f32 sums over all rows in another
    order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, extra, r1, r2 = swin_inputs(G=2, images=3, m=18, C=48, H=2, D=24, F=96)
    dev = [t.cuda() for t in args]
    for i in (3, 5, 9, 11):
        dev[i] = dev[i].t().contiguous().t()
    extra = extra.cuda()
    r1, r2 = (r1.cuda(), r2.cuda()) if use_rs else (None, None)
    do = torch.randn(dev[0].shape, device="cuda")
    out, saved = fused_layer1.fused_transformer_layer_fwd(*dev, 2, extra, r1, r2)
    grads = fused_layer1.fused_transformer_layer_bwd(saved, do)
    again = fused_layer1.fused_transformer_layer_bwd(saved, do)
    out_p, saved_p = fused_layer1.fused_transformer_layer_fwd_reference(*dev, 2, extra,
                                                                        r1, r2)
    plain = fused_layer1.fused_transformer_layer_bwd_reference(saved_p, do)
    torch.testing.assert_close(out, out_p, atol=1e-4, rtol=1e-4)
    for k, k2, p in zip(grads, again, plain):
        if p is None:
            assert k is None
            continue
        assert torch.equal(k, k2)
        assert (k - p).abs().max().item() <= 1e-3 * max(1.0, p.abs().max().item())
