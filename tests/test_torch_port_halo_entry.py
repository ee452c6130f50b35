"""Halo through the port's entry points, and the CUDA dispatch of the two
Halo ops.

- ``python -m vision_transformers_tpu_torch.train`` on
  tests/data/halo_s_port.conf, shrunk to a tiny Halo on the CPU with
  DropPath 0.1, writes an ``epoch-001.pt`` that ``predict`` serves.
- The C entry points' parameter lists in csrc/*.cu against the ctypes
  signatures declared in ops/_build.py, kind for kind.
- The CUDA wrappers of ``fused_halo_layer`` and ``halo_attention_direct``,
  forward and backward: with the kernel library replaced by ctypes
  callbacks of the declared signatures (this machine has no card), each
  call passes every argument the C entry declares — the bias, the row
  scales, the map geometry, the dbias chunk count and its partial buffer —
  and counts one launch; what the kernels do not take raises.
- On a card (marker ``cuda``): both ops' forward with saves and backward
  against the plain versions, bit-identical across two runs.
"""

import contextlib
import ctypes
import json
import os
import re

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch import predict, train
from vision_transformers_tpu_torch.ops import _build, fused_halo
from vision_transformers_tpu_torch.ops import fused_halo_layer as fhl
from vision_transformers_tpu_torch.utils.weights import seeded_images
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONF = os.path.join(ROOT, "tests", "data", "halo_s_port.conf")
TINY = ["precision=f32", "training.epoch=1", "training.dataloader.batch_size=8",
        "data_backend=synthetic", "arch.image_size=64", "arch.window_size=2",
        "arch.halo_size=1", "arch.depths=[1, 1, 1, 1]", "arch.dims=[8, 16, 32, 64]",
        "arch.dim_head=4", "arch.n_heads=[2, 4, 8, 16]", "arch.dim_ffs=[16, 32, 64, 128]",
        "arch.n_class=10", "arch.drop_path=0.1", "training.train_size=64",
        "training.valid_size=64", "log_freq=4"]


def test_trainer_writes_a_checkpoint_predict_serves(tmp_path, capsys):
    from PIL import Image

    metrics = train.main(["--conf", CONF, "--device", "cpu", *TINY,
                          f"checker.storage=[{{type: local, path: {tmp_path}}}]"])
    assert all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss"))
    ckpt = tmp_path / "epoch-001.pt"
    obj = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert sorted(obj) == ["epoch", "model", "optimizer"]
    assert "block1.1.attn.rel_pos.weight" in obj["model"]
    files = []
    for i, img in enumerate(seeded_images(3, 2, 80)):
        files.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray(img).save(files[-1])
    capsys.readouterr()
    predict.main(["--conf", CONF, "--checkpoint", f"{ckpt}:model", "--device", "cpu",
                  "--topk", "3", *files, *TINY[4:16]])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [e["file"] for e in lines] == files
    assert all(len(e["topk"]) == 3 for e in lines)


def c_entry_kinds(name):
    """The kinds (P pointer, L long long, I int, F float) of the C entry
    ``name``'s parameters, read from csrc/*.cu."""
    for path in sorted((_build._CSRC).glob("*.cu")):
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", path.read_text(), re.S)
        if m:
            kinds = []
            for p in (p.strip() for p in m.group(1).split(",")):
                kinds.append("P" if "*" in p else "L" if p.startswith("long long")
                             else "I" if p.startswith("int") else
                             "F" if p.startswith("float") else p)
            return kinds
    raise AssertionError(f"no C entry {name}")


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_declared_signatures_match_the_c_entries(name):
    kind = {ctypes.c_void_p: "P", ctypes.c_longlong: "L", ctypes.c_int: "I",
            ctypes.c_float: "F"}
    assert [kind[t] for t in _build._SIGNATURES[name]] == c_entry_kinds(name)


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


def halo_inputs(B=2, H=8, W=8, C=16, nh=2, D=8, F=32, window=4, halo=1, seed=0):
    """Inputs scaled as chip_smoke.py's ``layer_args`` (see
    test_torch_port_swin_entry.py's ``swin_inputs``), weights as transposed
    views of [out, in] matrices."""
    rng = np.random.default_rng(seed)
    k = window + 2 * halo

    def n(*shape, s=1.0, mean=0.0):
        return torch.from_numpy((mean + s * rng.normal(size=shape)).astype(np.float32))

    HD = nh * D
    args = [n(B, H, W, C), n(C, s=0.1, mean=1.0), n(C, s=0.1), n(3 * HD, C, s=0.05).t(),
            n(C, HD, s=0.05).t(), n(C, s=0.1), n(C, s=0.1, mean=1.0), n(C, s=0.1),
            n(F, C, s=0.05).t(), n(F, s=0.1), n(C, F, s=0.05).t(), n(C, s=0.1),
            n(nh, window * window, k * k, s=0.5)]
    return args, n(B), n(B)


def test_cuda_layer_forward_passes_geometry_bias_and_row_scales(monkeypatch):
    args, r1, r2 = halo_inputs()
    with fake_cuda(monkeypatch) as lib:
        before = fhl.LAUNCHES
        fhl._cuda_fwd(*args, 2, r1, r2, "silu", 4, 1, 0.25, 1e-6, save=False)
        serving = lib.calls["vtx_fused_halo_layer_fwd"]
        out, saves = fhl._cuda_fwd(*args, 2, r1, r2, "silu", 4, 1, 0.25, 1e-6, save=True)
        training = lib.calls["vtx_fused_halo_layer_fwd"]
    assert fhl.LAUNCHES == before + 2
    wqkv = args[3]
    for call in (serving, training):
        assert call[3:6] == (wqkv.data_ptr(), *wqkv.stride())  # the view's strides
        assert call[20:23] == (args[12].data_ptr(), r1.data_ptr(), r2.data_ptr())
        assert call[33:42] == (2, 8, 8, 16, 2, 8, 32, 4, 1)
        assert all(p is not None for p in call[27:29] + call[30:32])  # the statistics
    assert serving[29] is None and serving[44] == 0  # no lse: no saves
    assert training[29] is not None and training[44] == 1
    assert out.shape == args[0].shape
    assert saves[0].shape == (2, 8, 8, 48) and saves[6].shape == (2, 2, 64)  # qkv, lse


def test_cuda_layer_backward_passes_chunks_and_gradients(monkeypatch):
    args, r1, r2 = halo_inputs()
    with fake_cuda(monkeypatch) as lib:
        _, res = fhl._cuda_fwd(*args, 2, r1, r2, "silu", 4, 1, 0.25, 1e-6, save=True)
        saved = fhl.HaloSaved(*args, r1, r2, *res, 2, "silu", 4, 1, 0.25, 1e-6)
        before = fhl.BWD_LAUNCHES
        grads = fhl._cuda_bwd(saved, torch.zeros_like(args[0]), (True, True))
        call = lib.calls["vtx_fused_halo_layer_bwd"]
    assert fhl.BWD_LAUNCHES == before + 1
    assert len(grads) == len(fhl.GRAD_NAMES)
    chunks = fused_halo.dbias_chunks(2 * 4, 2, 4, 1, 8)
    assert call[42] == chunks and 1 <= chunks <= 8
    assert call[36] is None  # one key tile: no dq partials
    dbias, drs_attn, drs_ff = grads[12:]
    assert dbias.shape == args[12].shape and drs_attn.shape == drs_ff.shape == (2,)
    assert call[69:72] == (dbias.data_ptr(), drs_attn.data_ptr(), drs_ff.data_ptr())
    assert call[72:81] == (2, 8, 8, 16, 2, 8, 32, 4, 1)
    # the weight gradients come back in the weight views' layout
    assert grads[3].shape == args[3].shape and grads[3].stride() == args[3].stride()
    grads = fhl._cuda_bwd(saved, torch.zeros_like(args[0]), (False, False))
    assert grads[13:] == (None, None)


def test_cuda_direct_forward_and_backward(monkeypatch):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 8, 12, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(2, 8, 12, 32)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(2, 16, 64)).astype(np.float32))
    with fake_cuda(monkeypatch) as lib:
        before = fused_halo.LAUNCHES, fused_halo.BWD_LAUNCHES
        out, lse = fused_halo._cuda_fwd(q, kv, bias, 4, 2, 2, 0.3, save=True)
        fwd = lib.calls["vtx_halo_attention_direct_fwd"]
        saved = fused_halo.DirectSaved(q, kv, bias, out, lse, 4, 2, 2, 0.3)
        dq, dkv, dbias = fused_halo._cuda_bwd(saved, torch.zeros_like(q))
        bwd = lib.calls["vtx_halo_attention_direct_bwd"]
    assert (fused_halo.LAUNCHES, fused_halo.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert fwd[:5] == (q.data_ptr(), kv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                       lse.data_ptr())
    assert fwd[5:12] == (2, 8, 12, 2, 8, 4, 2) and lse.shape == (2, 2, 96)
    assert bwd[8] == fused_halo.dbias_chunks(12, 2, 4, 2, 8)
    assert bwd[9] is None  # one key tile: no dq partials
    assert bwd[10:13] == (dq.data_ptr(), dkv.data_ptr(), dbias.data_ptr())
    assert dq.shape == q.shape and dkv.shape == kv.shape and dbias.shape == bias.shape


def test_cuda_refuses_what_the_kernels_do_not_take(monkeypatch):
    args, r1, r2 = halo_inputs()
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="silu"):
        fhl._cuda_fwd(*args, 2, r1, r2, "gelu", 4, 1, 0.25, 1e-6, save=False)
    wide, _, _ = halo_inputs(C=80, nh=2, D=40)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="32 wide"):
        fhl._cuda_fwd(*wide, 2, None, None, "silu", 4, 1, 0.25, 1e-6, save=False)
    # the attention alone takes heads up to 64 wide: 40 passes its pointers on
    q40, kv40 = torch.zeros(1, 8, 8, 80), torch.zeros(1, 8, 8, 160)
    with fake_cuda(monkeypatch) as lib:
        out, _ = fused_halo._cuda_fwd(q40, kv40, torch.zeros(2, 16, 36), 4, 1, 2, 0.3,
                                      save=False)
        call = lib.calls["vtx_halo_attention_direct_fwd"]
    assert call[:2] == (q40.data_ptr(), kv40.data_ptr()) and call[3] == out.data_ptr()
    assert call[5:12] == (1, 8, 8, 2, 40, 4, 1)
    q72, kv72 = torch.zeros(1, 8, 8, 144), torch.zeros(1, 8, 8, 288)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="64 wide"):
        fused_halo._cuda_fwd(q72, kv72, torch.zeros(2, 16, 36), 4, 1, 2, 0.3, save=False)
    big, _, _ = halo_inputs(H=16, W=16, window=16, halo=1)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="64 tokens"):
        fhl._cuda_fwd(*big, 2, None, None, "silu", 16, 1, 0.25, 1e-6, save=False)
    deep, _, _ = halo_inputs(window=4, halo=3)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="2·halo ≤ window"):
        fhl._cuda_fwd(*deep, 2, None, None, "silu", 4, 3, 0.25, 1e-6, save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="bias must be"):
        fhl._cuda_fwd(*args[:12], args[12][:, :8], 2, None, None, "silu", 4, 1, 0.25,
                      1e-6, save=False)
    q = torch.zeros(1, 8, 8, 16)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="contiguous"):
        fused_halo._cuda_fwd(q, torch.zeros(1, 8, 8, 48)[..., :32], torch.zeros(2, 16, 36),
                             4, 1, 2, 0.3, save=False)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _close(k, p):
    return (k - p).abs().max().item() <= 1e-3 * max(1.0, p.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("use_rs", [False, True])
def test_cuda_layer_backward_matches_plain(use_rs):
    """Forward with saves + backward kernels against the plain versions on
    the card; bit-identical from run to run.  Limit 1e-3·max(1, max|plain|)
    per tensor: f32 sums over all rows in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, r1, r2 = halo_inputs(B=3, H=12, W=8, C=48, nh=2, D=24, F=96, window=4, halo=2)
    dev = [t.cuda() for t in args]
    r1, r2 = (r1.cuda(), r2.cuda()) if use_rs else (None, None)
    do = torch.randn(dev[0].shape, device="cuda")
    kw = dict(window=4, halo=2)
    out, saved = fhl.fused_halo_layer_fwd(*dev, 2, r1, r2, **kw)
    grads = fhl.fused_halo_layer_bwd(saved, do)
    again = fhl.fused_halo_layer_bwd(saved, do)
    out_p, saved_p = fhl.fused_halo_layer_fwd_reference(*dev, 2, r1, r2, **kw)
    plain = fhl.fused_halo_layer_bwd_reference(saved_p, do)
    torch.testing.assert_close(out, out_p, atol=1e-4, rtol=1e-4)
    for k, k2, p in zip(grads, again, plain):
        if p is None:
            assert k is None
            continue
        assert torch.equal(k, k2) and _close(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("D,window,halo", [(32, 8, 2), (64, 8, 2), (32, 8, 4)],
                         ids=["d32", "d64", "two-key-tiles"])
def test_cuda_direct_backward_matches_plain(D, window, halo):
    """Forward and backward kernels against the plain versions on 8x16
    maps: heads 32 and 64 wide, and 256 keys a window (two backward key
    tiles, dq summed over them in order); the backward bit-identical from
    run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    k = window + 2 * halo
    q = torch.randn(2, 8, 16, 2 * D, device="cuda", generator=g)
    kv = torch.randn(2, 8, 16, 4 * D, device="cuda", generator=g)
    bias = torch.randn(2, window * window, k * k, device="cuda", generator=g)
    do = torch.randn(2, 8, 16, 2 * D, device="cuda", generator=g)
    out, saved = fused_halo.halo_attention_direct_fwd(q, kv, bias, window, halo, 2)
    grads = fused_halo.halo_attention_direct_bwd(saved, do)
    again = fused_halo.halo_attention_direct_bwd(saved, do)
    out_p, saved_p = fused_halo.halo_attention_direct_fwd(q.cpu(), kv.cpu(), bias.cpu(),
                                                          window, halo, 2)
    plain = fused_halo.halo_attention_direct_bwd(saved_p, do.cpu())
    torch.testing.assert_close(out.cpu(), out_p, atol=1e-4, rtol=1e-4)
    for k_, k2, p in zip(grads, again, plain):
        assert torch.equal(k_, k2) and _close(k_.cpu(), p)
