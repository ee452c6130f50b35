"""Swin's map-resident path and Swin with dropout through the port's entry
points, and the CUDA dispatch of the map-resident layer (B9).  Imports no
JAX, so its ``cuda`` tests run on the card.

- ``python -m vision_transformers_tpu_torch.train`` on
  configs/swin-transformer-s.conf shrunk to a tiny Swin on the CPU: under
  ``VTX_ATTN_IMPL=swin`` (set in the environment only) every layer of every
  step and of the valid pass runs ``fused_swin_layer``, and ``predict``
  serves the checkpoint; with ``arch.drop_attn`` / ``arch.drop_ff`` 0.1 the
  trainer takes the two-branch layers and draws the masks.
- The CUDA wrappers of ``fused_swin_layer`` with the kernel library replaced
  by ctypes callbacks of the declared signatures (this machine has no
  card): each call passes every argument the C entry declares — the map,
  the row → pixel table, the bias and its group count, the untiled
  per-sample row scales, the saves only in training — and the wrappers
  refuse what the kernels do not take.
- On a card (marker ``cuda``): the serving forward, the forward with saves
  and the backward against the plain versions, shifted with the grouped
  bias and unshifted with the broadcast one, with and without the row
  scales; the backward bit-identical across two runs.
"""

import contextlib
import ctypes
import json
import os

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch import ops, predict, train
from vision_transformers_tpu_torch.models import layers
from vision_transformers_tpu_torch.ops import _build, fused_swin
from vision_transformers_tpu_torch.utils.weights import seeded_images

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONF = os.path.join(ROOT, "configs", "swin-transformer-s.conf")
TINY = ["precision=f32", "training.epoch=1", "training.dataloader.batch_size=8",
        "data_backend=synthetic", "arch.image_size=[64, 64]", "arch.window_size=2",
        "arch.depths=[2, 2, 2, 2]", "arch.dims=[8, 16, 32, 64]", "arch.dim_head=4",
        "arch.n_heads=[2, 4, 8, 16]", "arch.dim_ffs=[32, 64, 128, 256]",
        "arch.n_class=10", "training.train_size=64", "training.valid_size=64",
        "log_freq=4"]


class spy:
    def __init__(self, monkeypatch, name):
        self.n, fn = 0, getattr(ops, name)

        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(ops, name, counted)


class layer_calls:
    """Counts the SwinLayer forwards."""

    def __init__(self, monkeypatch):
        from vision_transformers_tpu_torch.models.swin import SwinLayer

        self.n, fn = 0, SwinLayer.forward

        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(SwinLayer, "forward", counted)


def test_trainer_under_the_swin_env_force(tmp_path, capsys, monkeypatch):
    """Every layer forward of the training steps and the valid pass goes
    through the map-resident op, then ``predict`` under the same force."""
    from PIL import Image

    monkeypatch.setenv("VTX_ATTN_IMPL", "swin")
    kernel, calls = spy(monkeypatch, "fused_swin_layer"), layer_calls(monkeypatch)
    metrics = train.main(["--conf", CONF, "--device", "cpu", *TINY,
                          f"checker.storage=[{{type: local, path: {tmp_path}}}]"])
    assert all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss"))
    assert kernel.n == calls.n and kernel.n > 0 and kernel.n % 8 == 0
    trained = kernel.n
    files = []
    for i, img in enumerate(seeded_images(3, 2, 80)):
        files.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray(img).save(files[-1])
    capsys.readouterr()
    predict.main(["--conf", CONF, "--checkpoint", f"{tmp_path / 'epoch-001.pt'}:model",
                  "--device", "cpu", "--topk", "3", *files, *TINY[4:14]])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [e["file"] for e in lines] == files
    assert kernel.n == trained + 8


@pytest.mark.parametrize("force", [None, "swin"], ids=["default", "swin"])
def test_trainer_with_dropout(tmp_path, monkeypatch, force):
    """drop_attn = drop_ff = 0.1: training takes the two residual branches
    (no kernel op: the tiny micro-batches are under 32 rows on the default,
    and the 'swin' force yields to dropout), eval the forced op."""
    if force:
        monkeypatch.setenv("VTX_ATTN_IMPL", force)
    kernel, calls = spy(monkeypatch, "fused_swin_layer"), layer_calls(monkeypatch)
    train_calls = []
    drops, draw = [], layers.dropout

    def counted(x, rate, generator=None):
        drops.append((tuple(x.shape), rate))
        if rate > 0:
            train_calls.append(calls.n)
        return draw(x, rate, generator)

    monkeypatch.setattr(layers, "dropout", counted)
    metrics = train.main(["--conf", CONF, "--device", "cpu", *TINY,
                          "arch.drop_attn=0.1", "arch.drop_ff=0.1",
                          f"checker.storage=[{{type: local, path: {tmp_path}}}]"])
    assert all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss"))
    # two masks (probabilities, FF hidden) in each training layer forward
    trained = len(set(train_calls))
    assert len([d for d in drops if d[1] == 0.1]) == 2 * trained and trained > 0
    assert trained % 8 == 0
    assert kernel.n == (calls.n - trained if force else 0)  # the valid pass


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


def map_inputs(images=2, size=(8, 8), window=2, pack=2, shift=True, C=16, H=2, D=8,
               F=32, rs=True, seed=0, device="cpu"):
    """Seeded inputs of one map-resident layer call, scaled as chip_smoke.py
    scales its layer inputs (LayerNorm scales near 1, weights std 0.05),
    weights as transposed views of [out, in] matrices as the model passes
    them; the bias grouped [G, H, m, m] when shifted, one slab [1, H, m, m]
    when not; per-image row scales (one image dropped)."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, mean=0.0):
        a = (mean + s * rng.normal(size=shape)).astype(np.float32)
        return torch.from_numpy(a).to(device)

    HD, m = H * D, pack * window * window
    G = (size[0] // window) * (size[1] // (pack * window))
    args = [n(images, *size, C), n(C, s=0.1, mean=1.0), n(C, s=0.1),
            n(3 * HD, C, s=0.05).t(), n(3 * HD, s=0.1), n(C, HD, s=0.05).t(), n(C, s=0.1),
            n(C, s=0.1, mean=1.0), n(C, s=0.1), n(F, C, s=0.05).t(), n(F, s=0.1),
            n(C, F, s=0.05).t(), n(C, s=0.1)]
    extra = n(G if shift else 1, H, m, m, s=0.2)
    keep = torch.ones(images, device=device)
    keep[0] = 0.0
    scales = (keep / 0.9, keep.flip(0) / 0.9) if rs else (None, None)
    geo = fused_swin._geometry(args[0], extra, window, pack, shift)
    return args, extra, scales, geo


def test_cuda_forward_takes_the_map(monkeypatch):
    args, extra, (r1, r2), geo = map_inputs()
    B, H, W, C = args[0].shape
    with fake_cuda(monkeypatch) as lib:
        before = fused_swin.LAUNCHES
        out = fused_swin._cuda_fwd(*args, 2, extra, r1, r2, "silu", 0.25, 1e-6, geo,
                                   save=False)[0]
        serving = lib.calls["vtx_fused_swin_layer_fwd"]
        _, saves = fused_swin._cuda_fwd(*args, 2, extra, r1, r2, "silu", 0.25, 1e-6, geo,
                                        save=True)
        training = lib.calls["vtx_fused_swin_layer_fwd"]
    assert fused_swin.LAUNCHES == before + 2
    assert out.shape == args[0].shape
    pix = fused_swin.map_rows(H, W, 2, 2, True)
    for call in (serving, training):
        assert call[0] == args[0].data_ptr()
        assert call[21:26] == (extra.data_ptr(), geo.G, r1.data_ptr(), r2.data_ptr(),
                               pix.data_ptr())
        assert call[38:47] == (B, H, W, C, 2, 8, 32, 2, 2)
    assert serving[31:37] == (None,) * 6  # af and the statistics: no saves
    assert all(p is not None for p in training[31:37])
    assert len(saves) == 9 and saves[3].shape == (B * H * W, 32)
    assert saves[6].shape == (B * geo.G, 2, geo.m)  # lse per pair


def test_cuda_backward_returns_every_gradient(monkeypatch):
    args, extra, (r1, r2), geo = map_inputs(shift=False)
    with fake_cuda(monkeypatch) as lib:
        _, res = fused_swin._cuda_fwd(*args, 2, extra, r1, r2, "silu", 0.25, 1e-6, geo,
                                      save=True)
        saved = fused_swin.SwinSaved(fused_swin.L1Saved(*args, extra, r1, r2, *res, 2,
                                                        "silu", 0.25, 1e-6), geo)
        before = fused_swin.BWD_LAUNCHES
        grads = fused_swin._cuda_bwd(saved, torch.zeros_like(args[0]), (True, True), True)
        call = lib.calls["vtx_fused_swin_layer_bwd"]
        assert fused_swin.BWD_LAUNCHES == before + 1
        assert call[21:24] == (extra.data_ptr(), 1, r1.data_ptr())
        assert len(grads) == len(fused_swin.GRAD_NAMES)
        dx, dextra, drs_attn, drs_ff = grads[0], *grads[13:]
        assert dx.shape == args[0].shape and dextra.shape == extra.shape
        assert drs_attn.shape == drs_ff.shape == (2,)
        assert call[45] is not None  # the dbias partials of the window attention
        assert call[73:76] == (dextra.data_ptr(), drs_attn.data_ptr(), drs_ff.data_ptr())
        # nothing asked of the bias or the row scales: null pointers
        grads = fused_swin._cuda_bwd(saved, torch.zeros_like(args[0]), (False, False),
                                     False)
        call = lib.calls["vtx_fused_swin_layer_bwd"]
    assert grads[13:] == (None, None, None)
    assert call[45] is None and call[73:76] == (None, None, None)


def test_cuda_refuses_what_the_kernel_does_not_take(monkeypatch):
    args, extra, (r1, r2), geo = map_inputs()
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="silu"):
        fused_swin._cuda_fwd(*args, 2, extra, r1, r2, "gelu", 0.25, 1e-6, geo, save=False)
    wide, wextra, _, wgeo = map_inputs(D=40)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="32 wide"):
        fused_swin._cuda_fwd(*wide, 2, wextra, None, None, "silu", 0.25, 1e-6, wgeo,
                             save=False)
    with pytest.raises(ValueError, match="extra must be"):
        fused_swin._geometry(args[0], extra[:3], 2, 2, True)
    with pytest.raises(ValueError, match="does not split"):
        fused_swin._geometry(args[0][:, :7], extra, 2, 2, True)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="rs_attn"):
        fused_swin._cuda_fwd(*args, 2, extra, r1[:1], None, "silu", 0.25, 1e-6, geo,
                             save=False)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shift,rs", [(True, True), (True, False), (False, True)])
def test_cuda_map_layer_matches_plain(shift, rs):
    """The kernels against the plain versions on the card at an odd shape (3
    images of a 6x12 map, windows of 3 in pairs: 4 pairs of 18 tokens, heads
    24 wide): serving and training forward within atol = rtol = 1e-4 (f32
    sums in another order), each gradient within 1e-3·max(1, max|plain|),
    the backward bit-identical across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, extra, (r1, r2), geo = map_inputs(images=3, size=(6, 12), window=3, pack=2,
                                            shift=shift, C=48, H=2, D=24, F=96, rs=rs,
                                            device="cuda")
    kw = dict(window=3, shift=shift, pack=2)
    do = torch.randn(args[0].shape, device="cuda")
    serving = fused_swin.fused_swin_layer(*args, 2, extra, r1, r2, **kw)
    out, saved = fused_swin.fused_swin_layer_fwd(*args, 2, extra, r1, r2, **kw)
    grads = fused_swin.fused_swin_layer_bwd(saved, do)
    again = fused_swin.fused_swin_layer_bwd(saved, do)
    ref, saved_p = fused_swin.fused_swin_layer_fwd_reference(*args, 2, extra, r1, r2, **kw)
    plain = fused_swin.fused_swin_layer_bwd_reference(saved_p, do)
    torch.testing.assert_close(serving, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    for name, k, k2, p in zip(fused_swin.GRAD_NAMES, grads, again, plain):
        if p is None:
            assert k is None, name
            continue
        assert torch.equal(k, k2), name
        assert (k - p).abs().max().item() <= 1e-3 * max(1.0, p.abs().max().item()), name
