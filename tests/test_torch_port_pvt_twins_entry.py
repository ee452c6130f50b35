"""PVT and Twins-SVT through the port's entry points, and the CUDA dispatch
of the reduced-kv attention and of the attention layer with a bias.

- ``python -m vision_transformers_tpu_torch.train`` on
  tests/data/pvt_s_port.conf and twins_svt_s_port.conf, shrunk to tiny
  models on the CPU (PVT with its reduced-kv attention forced to
  ``fused``), writes an ``epoch-001.pt`` that ``predict`` serves.
- The parameter lists of the C entries this port's B6 kernel and the
  biased attention layer have, in csrc/*.cu, against the ctypes signatures
  declared in ops/_build.py, kind for kind.
- The CUDA wrappers of ``fused_attention`` and of ``fused_attention_layer``
  with a bias, forward and backward: with the kernel library replaced by
  ctypes callbacks of the declared signatures (this machine has no card),
  each call passes every argument the C entry declares — the strides of
  the head views, the query chunks of the backward, the bias (B6's in each
  form, read through its (g, m) strides), its group count, its gradient
  buffers — and counts one launch; what the kernels do not take raises.
- On a card (marker ``cuda``): both against their plain versions, the
  backward bit-identical across two runs; B6 also with each bias form and
  its gradient.
"""

import contextlib
import ctypes
import json
import os
import re

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch import ops, predict, train
from vision_transformers_tpu_torch.ops import _build, fused_layer
from vision_transformers_tpu_torch.ops import fused_attention_mod as fa
from vision_transformers_tpu_torch.utils.weights import seeded_images
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
COMMON = ["precision=f32", "training.epoch=1", "training.dataloader.batch_size=8",
          "data_backend=synthetic", "arch.n_class=10", "arch.drop_path=0.1", "log_freq=4"]
TINY = {  # conf → (arch overrides, image size)
    "pvt_s_port.conf": (["arch.image_size=32", "arch.depths=[1, 1, 1, 1]",
                         "arch.patch_embed_dims=[16, 32, 64, 128]", "arch.n_heads=[1, 2, 4, 8]",
                         "arch.dim_ffs=[32, 64, 128, 256]", "arch.reductions=[4, 2, 2, 1]"], 32),
    "twins_svt_s_port.conf": (["arch.window_size=2", "arch.depths=[1, 1, 1, 1]",
                               "arch.dims=[16, 32, 64, 128]", "arch.dim_head=8",
                               "arch.n_heads=[2, 4, 8, 16]",
                               "arch.dim_ffs=[32, 64, 128, 256]"], 64),
}


@pytest.mark.parametrize("conf_name", list(TINY))
def test_trainer_writes_a_checkpoint_predict_serves(tmp_path, capsys, conf_name):
    from PIL import Image

    conf = os.path.join(ROOT, "tests", "data", conf_name)
    arch, size = TINY[conf_name]
    sizes = [f"training.train_size={size}", f"training.valid_size={size}"]
    ops.set_sra_impl("fused")
    try:
        metrics = train.main(["--conf", conf, "--device", "cpu", *COMMON, *arch, *sizes,
                              f"checker.storage=[{{type: local, path: {tmp_path}}}]"])
    finally:
        ops.set_sra_impl(None)
    assert all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss"))
    ckpt = tmp_path / "epoch-001.pt"
    obj = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert sorted(obj) == ["epoch", "model", "optimizer"]
    files = []
    for i, img in enumerate(seeded_images(3, 2, size + 16)):
        files.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray(img).save(files[-1])
    capsys.readouterr()
    predict.main(["--conf", conf, "--checkpoint", f"{ckpt}:model", "--device", "cpu",
                  "--topk", "3", *files, "arch.n_class=10", *arch, *sizes])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [e["file"] for e in lines] == files
    assert all(len(e["topk"]) == 3 for e in lines)


def c_entry_kinds(name):
    """The kinds (P pointer, L long long, I int, F float) of the C entry
    ``name``'s parameters, read from csrc/*.cu."""
    for path in sorted(_build._CSRC.glob("*.cu")):
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", path.read_text(), re.S)
        if m:
            return ["P" if "*" in p else "L" if p.startswith("long long") else
                    "I" if p.startswith("int") else "F" if p.startswith("float") else p
                    for p in (p.strip() for p in m.group(1).split(","))]
    raise AssertionError(f"no C entry {name}")


@pytest.mark.parametrize("name", ["vtx_fused_attention_fwd", "vtx_fused_attention_bwd",
                                  "vtx_fused_attention_layer_fwd",
                                  "vtx_fused_attention_layer_bwd"])
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
            def record(*args, name=name):
                self.calls[name] = args
                return 0

            fn = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(record)
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


def head_views(B=2, M=10, N=3, G=4, D=8, seed=0):
    """q, k, v as the models pass them: [B, G, rows, D] views of a q
    projection [B, M, G·D] and of the two halves of a kv projection
    [B, N, 2·G·D]."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, M, G * D, generator=g)
    kv = torch.randn(B, N, 2 * G * D, generator=g)

    def heads(t):
        return t.reshape(B, -1, G, D).permute(0, 2, 1, 3)

    return heads(q), heads(kv[..., :G * D]), heads(kv[..., G * D:])


def test_cuda_fused_attention_passes_the_views_strides(monkeypatch):
    q, k, v = head_views()
    with fake_cuda(monkeypatch) as lib:
        before = fa.LAUNCHES, fa.BWD_LAUNCHES
        out, lse = fa._cuda_fwd(q, k, v, None, 0.3, save=True)
        fwd = lib.calls["vtx_fused_attention_fwd"]
        saved = fa.SraSaved(q, k, v, None, out, lse, 0.3)
        do = torch.zeros(2, 10, 4, 8).permute(0, 2, 1, 3)
        dq, dk, dv, dextra = fa._cuda_bwd(saved, do)
        bwd = lib.calls["vtx_fused_attention_bwd"]
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    # no copy: the views' pointers and (b, g, row) strides
    assert fwd[:4] == (q.data_ptr(), 10 * 32, 8, 32)
    assert fwd[4:8] == (k.data_ptr(), 3 * 64, 8, 64)
    assert fwd[8] == v.data_ptr() == k.data_ptr() + 32 * 4
    assert fwd[12:15] == (None, 0, 0)  # no bias
    assert fwd[15:22] == (out.data_ptr(), lse.data_ptr(), 2, 4, 10, 3, 8)
    assert abs(fwd[22] - 0.3) < 1e-7
    # out and dq in the [B, M, G, D] memory order, returned as [B, G, M, D]
    assert out.shape == dq.shape == (2, 4, 10, 8)
    assert out.stride() == dq.stride() == (320, 8, 32, 1) and lse.shape == (2, 4, 10)
    assert bwd[15:17] == (out.data_ptr(), lse.data_ptr())
    assert bwd[17:21] == (do.data_ptr(), *do.stride()[:3])
    chunks = fa.dkdv_chunks(2, 4, 10, 3)
    # one query tile and one key tile: no partials
    assert bwd[21:25] == (None, None, chunks, None) and chunks == 1
    assert bwd[25:28] == (dq.data_ptr(), dk.data_ptr(), None) and bwd[28:33] == (2, 4, 10, 3, 8)
    assert dk.shape == dv.shape == (2, 4, 3, 8) and dv.data_ptr() > dk.data_ptr()
    assert dextra is None


def test_cuda_fused_attention_serving_call_saves_nothing(monkeypatch):
    q, k, v = head_views(N=1)
    with fake_cuda(monkeypatch) as lib:
        out, lse = fa._cuda_fwd(q, k, v, None, 0.3, save=False)
    assert lib.calls["vtx_fused_attention_fwd"][16] is None and lse is None
    assert out.shape == q.shape


def test_cuda_fused_attention_refuses_what_the_kernels_do_not_take(monkeypatch):
    q, k, v = head_views()
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="does not broadcast"):
        fa._cuda_fwd(q, k, v, torch.zeros(10, 4), 0.1, save=False)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="float32"):
        fa._cuda_fwd(q, k, v, torch.zeros(10, 3, dtype=torch.float64), 0.1, save=False)
    with fake_cuda(monkeypatch) as lib:  # a bias the kernels take passes its pointer
        extra = torch.zeros(10, 3)
        fa._cuda_fwd(q, k, v, extra, 0.1, save=False)
    assert lib.calls["vtx_fused_attention_fwd"][12:15] == (extra.data_ptr(), 0, 3)
    wq, wk, wv = head_views(D=72)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="64 wide"):
        fa._cuda_fwd(wq, wk, wv, None, 0.1, save=False)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="float32"):
        fa._cuda_fwd(q.double(), k.double(), v.double(), None, 0.1, save=False)
    with fake_cuda(monkeypatch), pytest.raises(ValueError, match="k and v"):
        fa._cuda_fwd(q, k, v[:, :, :2], None, 0.1, save=False)


@pytest.mark.parametrize("form", ["mn", "1mn", "gmn", "g1n"])
@pytest.mark.parametrize("need_dextra", [False, True])
def test_cuda_fused_attention_passes_the_bias_and_its_gradient(monkeypatch, form, need_dextra):
    """Each form of the bias goes to the kernels as a [G, M, N] view (stride
    0 where it broadcasts, no copy), and with its gradient asked the
    backward hands over the dS buffer and dextra [G, M, N]."""
    q, k, v = head_views(B=2, M=10, N=3, G=4, D=8)
    shape = {"mn": (10, 3), "1mn": (1, 10, 3), "gmn": (4, 10, 3), "g1n": (4, 1, 3)}[form]
    extra = torch.randn(*shape)
    strides = {"mn": (0, 3), "1mn": (0, 3), "gmn": (30, 3), "g1n": (3, 0)}[form]
    with fake_cuda(monkeypatch) as lib:
        out, lse = fa._cuda_fwd(q, k, v, extra, 0.3, save=True)
        fwd = lib.calls["vtx_fused_attention_fwd"]
        saved = fa.SraSaved(q, k, v, extra, out, lse, 0.3)
        dq, dk, dv, dextra = fa._cuda_bwd(saved, torch.zeros_like(out), need_dextra)
        bwd = lib.calls["vtx_fused_attention_bwd"]
    assert fwd[12:15] == (extra.data_ptr(), *strides)
    assert bwd[12:15] == (extra.data_ptr(), *strides)
    if need_dextra:
        assert dextra.shape == (4, 10, 3) and bwd[27] == dextra.data_ptr()
        assert bwd[24] is not None  # the dS buffer
        assert fa.extra_grad(dextra, extra).shape == extra.shape
    else:
        assert dextra is None and bwd[24] is None and bwd[27] is None


def test_cuda_fused_attention_backward_partials_past_one_tile(monkeypatch):
    """More than 64 keys: dq goes through key-tile partials; few (b, g) pairs
    and many query tiles: dk / dv through query-chunk partials."""
    q, k, v = head_views(B=1, M=300, N=70, G=1, D=8)
    with fake_cuda(monkeypatch) as lib:
        out, lse = fa._cuda_fwd(q, k, v, None, 0.3, save=True)
        saved = fa.SraSaved(q, k, v, None, out, lse, 0.3)
        fa._cuda_bwd(saved, torch.zeros_like(out))
        bwd = lib.calls["vtx_fused_attention_bwd"]
    chunks = fa.dkdv_chunks(1, 1, 300, 70)
    assert chunks == 5  # five query tiles, one chunk each
    assert bwd[21] is not None and bwd[22] is not None and bwd[23] == chunks


def layer_inputs(B=4, N=18, C=32, H=2, D=16, seed=0):
    """Inputs scaled as chip_smoke.py's ``layer_args``, the weights as
    transposed views, and Twins' [N, N] pair mask."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, mean=0.0):
        return torch.from_numpy((mean + s * rng.normal(size=shape)).astype(np.float32))

    HD = H * D
    args = [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1), n(3 * HD, C, s=0.05).t(),
            n(3 * HD, s=0.1), n(C, HD, s=0.05).t(), n(C, s=0.1)]
    same = torch.arange(N) // (N // 2)
    mask = torch.where(same[:, None] == same[None, :], 0.0, -1e9)
    return args, mask, n(B)


@pytest.mark.parametrize("need_dextra", [False, True])
def test_cuda_layer_passes_the_bias_forward_and_backward(monkeypatch, need_dextra):
    args, mask, rs = layer_inputs()
    # the [N, N] mask broadcast over heads: one group [1, H, N, N]
    extra_g, groups = fused_layer.extra_groups(mask, 4, 2, 18)
    assert extra_g.shape == (1, 2, 18, 18) and groups == 1
    with fake_cuda(monkeypatch) as lib:
        before = (fused_layer.LAUNCHES, fused_layer.BIAS_LAUNCHES, fused_layer.BWD_LAUNCHES,
                  fused_layer.BIAS_BWD_LAUNCHES)
        out, res = fused_layer._cuda_fwd(*args, 2, extra_g, groups, rs, 0.25, 1e-6,
                                         save=True)
        fwd = lib.calls["vtx_fused_attention_layer_fwd"]
        saved = fused_layer.AttnSaved(*args, rs, *res, extra_g, 2, 0.25, 1e-6)
        grads = fused_layer._cuda_bwd(saved, torch.zeros_like(out), True, need_dextra)
        bwd = lib.calls["vtx_fused_attention_layer_bwd"]
    after = (fused_layer.LAUNCHES, fused_layer.BIAS_LAUNCHES, fused_layer.BWD_LAUNCHES,
             fused_layer.BIAS_BWD_LAUNCHES)
    assert after == tuple(b + 1 for b in before)
    assert fwd[11:14] == (extra_g.data_ptr(), 1, rs.data_ptr())
    assert bwd[11:14] == (extra_g.data_ptr(), 1, rs.data_ptr())
    # the window attention writes dq itself: no dq partials with the bias
    dq_part, dbpart, dextra = bwd[21], bwd[24], bwd[41]
    assert dq_part is None
    assert len(grads) == 9 and grads[7].shape == (4,)
    if need_dextra:
        assert grads[8].shape == (1, 2, 18, 18) and dextra == grads[8].data_ptr()
        assert dbpart is not None
    else:
        assert grads[8] is None and dextra is None and dbpart is None
    assert bwd[42:47] == (4, 18, 32, 2, 16)


def test_cuda_layer_refuses_a_bias_with_wide_heads(monkeypatch):
    # heads wider than 64 are refused with or without the bias ...
    args, _, _ = layer_inputs(C=80, H=1, D=80)
    extra_g, groups = fused_layer.extra_groups(torch.zeros(18, 18), 4, 1, 18)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="64 wide"):
        fused_layer._cuda_fwd(*args, 1, extra_g, groups, None, 0.125, 1e-6, save=False)
    # ... and up to 64 wide the bias runs, on the packed-row core (heads over
    # 32 wide leave the window attention), as it does without one
    args, _, _ = layer_inputs(C=64, H=1, D=64)
    with fake_cuda(monkeypatch) as lib:
        fused_layer._cuda_fwd(*args, 1, extra_g, groups, None, 0.125, 1e-6, save=False)
        assert lib.calls["vtx_fused_attention_layer_fwd"][11:13] == (extra_g.data_ptr(), 1)
        fused_layer._cuda_fwd(*args, 1, None, 1, None, 0.125, 1e-6, save=False)
    assert lib.calls["vtx_fused_attention_layer_fwd"][11:13] == (None, 1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _close(k, p):
    return (k - p).abs().max().item() <= 1e-3 * max(1.0, p.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 37, 1, 64), (3, 2, 70, 4, 32), (2, 1, 200, 49, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_fused_attention_matches_plain(shape):
    """Forward with saves + backward kernels against the plain versions on
    the card on the models' strided views; bit-identical from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    B, G, M, N, D = shape
    q, k, v = (t.cuda() for t in head_views(B, M, N, G, D))
    do = torch.randn(B, G, M, D, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    out, saved = fa.fused_attention_fwd(q, k, v)
    grads = fa.fused_attention_bwd(saved, do)[:3]
    again = fa.fused_attention_bwd(saved, do)[:3]
    out_p, lse_p = fa.attention_fwd_reference(q, k, v, None, saved.scale)
    plain = fa.attention_bwd_reference(q, k, v, None, lse_p, do, saved.scale)[:3]
    torch.testing.assert_close(out, out_p, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(saved.lse, lse_p, atol=1e-4, rtol=1e-4)
    for g, g2, p in zip(grads, again, plain):
        assert torch.equal(g, g2) and _close(g, p)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["mn", "1mn", "gmn"])
def test_cuda_fused_attention_with_bias_matches_plain(form):
    """B6 with each bias form on the card: forward within 1e-4, dq / dk /
    dv / dextra within 1e-3·max(1, max|plain|), bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    B, G, M, N, D = 2, 3, 77, 49, 64
    q, k, v = (t.cuda() for t in head_views(B, M, N, G, D))
    shape = {"mn": (M, N), "1mn": (1, M, N), "gmn": (G, M, N)}[form]
    gen = torch.Generator("cuda").manual_seed(2)
    extra = 0.5 * torch.randn(*shape, device="cuda", generator=gen)
    do = torch.randn(B, G, M, D, device="cuda", generator=gen)
    out, saved = fa.fused_attention_fwd(q, k, v, extra)
    grads = fa.fused_attention_bwd(saved, do)
    again = fa.fused_attention_bwd(saved, do)
    out_p, lse_p = fa.attention_fwd_reference(q, k, v, extra, saved.scale)
    plain = fa.attention_bwd_reference(q, k, v, extra, lse_p, do, saved.scale)
    torch.testing.assert_close(out, out_p, atol=1e-4, rtol=1e-4)
    for g, g2, p in zip(grads, again, plain):
        assert torch.equal(g, g2) and _close(g, p)


@pytest.mark.cuda
@pytest.mark.parametrize("need_dextra", [False, True])
def test_cuda_layer_with_mask_matches_plain(need_dextra):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, mask, rs = layer_inputs(B=6, N=98, C=64, H=2, D=32)
    args, mask, rs = [a.cuda() for a in args], mask.cuda(), rs.cuda()
    dz = torch.randn(args[0].shape, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    out, saved = fused_layer.fused_attention_layer_fwd(*args, 2, row_scale=rs, extra=mask)
    grads = fused_layer.fused_attention_layer_bwd(saved, dz, need_dextra=need_dextra)
    again = fused_layer.fused_attention_layer_bwd(saved, dz, need_dextra=need_dextra)
    out_p, saved_p = fused_layer.fused_attention_layer_fwd_reference(
        *args, 2, row_scale=rs, extra_g=saved.extra_g)
    plain = fused_layer.fused_attention_layer_bwd_reference(saved_p, dz,
                                                            need_dextra=need_dextra)
    torch.testing.assert_close(out, out_p, atol=1e-4, rtol=1e-4)
    for g, g2, p in zip(grads, again, plain):
        if p is None:
            assert g is None
            continue
        assert torch.equal(g, g2) and _close(g, p)
