"""The bias-free attention of the attention layer B1 and the whole layer B2
on the packed-row tensor-core core (csrc/attention_tc.cuh through
``vtx::packed_attention_fwd`` / ``_bwd``, compiled into
csrc/fused_attention_qkv.cu), checked on the CPU.

Without a bias (ViT's layers: N 197, heads 64 wide; Twins-SVT-S's last
stage: N 49, heads 32 wide) the layers' attention is B3's core, whose
backward writes dq as one partial per 64-key tile and sums them in order.
The wrappers of B1 and B2 are driven through ctypes callbacks of the
declared signatures: the backward passes the dq partials [ceil(N / 64),
B·N, H·D] (none with one key tile) and no Δ, LN-output or data-gradient
workspace; the bias calls still pass the window attention's dbias
partials and no dq partials.  The C entries' parameter names are read from
csrc/ (the kinds of every entry against ``_build._SIGNATURES`` are
tests/test_torch_port_halo_entry.py's).  The ``cuda`` tests hold both
layers' kernels, forward and backward, against their plain versions on the
card.  No JAX here, so the ``cuda`` tests run where JAX is absent.
"""

import contextlib
import ctypes
import re

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch.ops import _build, fused_layer, fused_layer1
from torch_port_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-4  # chip_smoke.KERNEL_TOL

# name → (B, N, C, H, D, F): a ViT-like layer past one key tile, and
# Twins-SVT-S stage 4's bias-free call (49 tokens, heads 32 wide) cut in width
SHAPES = {"vit": (2, 197, 128, 2, 64, 256), "twins_stage4": (2, 49, 64, 2, 32, 256)}


def c_entry_names(name):
    """The parameter names of the C entry ``name``, read from csrc/*.cu."""
    for path in sorted(_build._CSRC.glob("*.cu")):
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", path.read_text(), re.S)
        if m:
            return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    raise AssertionError(f"no C entry {name}")


class FakeLib:
    """Each declared entry point as a ctypes callback of its argtypes: a
    call converts every argument as the real library's would (a wrong
    count or type raises) and is recorded by parameter name."""

    def __init__(self):
        self.calls = {}
        self._keep = []
        for name, argtypes in _build._SIGNATURES.items():
            proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)

            def record(*args, name=name):
                self.calls[name] = dict(zip(c_entry_names(name), args))
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


def recorded(monkeypatch, name, *modules):
    """Record every workspace the wrappers allocate through ``name``."""
    made, make = [], getattr(fused_layer, name)

    def alloc(*args):
        made.append(make(*args))
        return made[-1]

    for mod in modules:
        monkeypatch.setattr(mod, name, alloc)
    return made


def layer_inputs(B, N, C, H, D, F, seed=0):
    """Seeded f32 inputs of the whole layer (weights as transposed views of
    [out, in] matrices, as the models pass them); B1 takes the first 7."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, mean=0.0):
        return torch.from_numpy((mean + s * rng.standard_normal(shape)).astype(np.float32))

    HD = H * D
    return [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1), n(3 * HD, C, s=0.05).t(),
            n(3 * HD, s=0.1), n(HD, C, s=0.05).t(), n(C, s=0.1), n(C, s=0.1, mean=1.0),
            n(C, s=0.1), n(F, C, s=0.05).t(), n(F, s=0.1), n(C, F, s=0.05).t(), n(C, s=0.1)]


def expected_partials(B, N, H, D):
    """The dq partials' shape, None with one key tile."""
    key_tiles = -(-N // 64)
    return (key_tiles, B * N, H * D) if key_tiles > 1 else None


@pytest.mark.parametrize("entry", ["vtx_fused_attention_layer_bwd",
                                   "vtx_fused_transformer_layer_bwd"])
def test_entries_take_dq_partials_and_no_dropped_workspace(entry):
    names = c_entry_names(entry)
    assert len(names) == len(_build._SIGNATURES[entry])
    assert "dq_part" in names and "dbpart" in names
    assert not {"delta", "u", "da"} & set(names)
    # the forward entries still take u, the LayerNorm output's workspace
    assert "u" in c_entry_names(entry.replace("_bwd", "_fwd"))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_b1_bias_free_calls_pass_lse_and_dq_partials(monkeypatch, shape):
    B, N, C, H, D, F = SHAPES[shape]
    args = layer_inputs(B, N, C, H, D, F)[:7]
    made = recorded(monkeypatch, "dq_partials", fused_layer)
    with fake_cuda(monkeypatch) as lib:
        before = (fused_layer.LAUNCHES, fused_layer.BIAS_LAUNCHES, fused_layer.BWD_LAUNCHES,
                  fused_layer.BIAS_BWD_LAUNCHES)
        fused_layer._cuda_fwd(*args, H, None, 1, None, D ** -0.5, 1e-6, save=False)
        serving = lib.calls["vtx_fused_attention_layer_fwd"]
        out, res = fused_layer._cuda_fwd(*args, H, None, 1, None, D ** -0.5, 1e-6,
                                         save=True)
        training = lib.calls["vtx_fused_attention_layer_fwd"]
        saved = fused_layer.AttnSaved(*args, None, *res, None, H, D ** -0.5, 1e-6)
        grads = fused_layer._cuda_bwd(saved, torch.zeros_like(out), False, False)
        bwd = lib.calls["vtx_fused_attention_layer_bwd"]
    after = (fused_layer.LAUNCHES, fused_layer.BIAS_LAUNCHES, fused_layer.BWD_LAUNCHES,
             fused_layer.BIAS_BWD_LAUNCHES)
    assert after == (before[0] + 2, before[1], before[2] + 1, before[3])
    assert serving["extra"] is None and serving["lse"] is None
    assert training["extra"] is None and training["lse"] == res[4].data_ptr()
    assert res[4].shape == (B, H, N)
    assert bwd["extra"] is None and bwd["lse"] == res[4].data_ptr()
    assert len(made) == 1
    if expected_partials(B, N, H, D) is None:
        assert made[0] is None and bwd["dq_part"] is None
    else:
        assert made[0].shape == expected_partials(B, N, H, D)
        assert bwd["dq_part"] == made[0].data_ptr()
    assert bwd["dbpart"] is None and bwd["dextra"] is None
    assert (bwd["B"], bwd["N"], bwd["C"], bwd["H"], bwd["D"]) == (B, N, C, H, D)
    assert len(grads) == 9 and grads[7] is None and grads[8] is None


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_b2_bias_free_backward_passes_dq_partials(monkeypatch, shape):
    B, N, C, H, D, F = SHAPES[shape]
    args = layer_inputs(B, N, C, H, D, F)
    made = recorded(monkeypatch, "dq_partials", fused_layer1)
    r = torch.ones(B)
    with fake_cuda(monkeypatch) as lib:
        _, res = fused_layer1._cuda_fwd(*args, H, None, 1, r, r, "silu", D ** -0.5, 1e-6,
                                        save=True)
        fwd = lib.calls["vtx_fused_transformer_layer_fwd"]
        saved = fused_layer1.L1Saved(*args, None, r, r, *res, H, "silu", D ** -0.5, 1e-6)
        grads = fused_layer1._cuda_bwd(saved, torch.zeros_like(args[0]), (True, True), True)
        bwd = lib.calls["vtx_fused_transformer_layer_bwd"]
    assert fwd["extra"] is None and fwd["lse"] == res[6].data_ptr()
    assert bwd["extra"] is None and bwd["lse"] == res[6].data_ptr()
    assert len(made) == 1
    if expected_partials(B, N, H, D) is None:
        assert made[0] is None and bwd["dq_part"] is None
    else:
        assert made[0].shape == expected_partials(B, N, H, D)
        assert bwd["dq_part"] == made[0].data_ptr()
    assert bwd["dbpart"] is None and bwd["dextra"] is None and grads[13] is None
    assert bwd["drs_attn"] == grads[14].data_ptr() and bwd["drs_ff"] == grads[15].data_ptr()


def test_bias_calls_pass_the_dbias_partials_and_no_dq_partials(monkeypatch):
    B, N, C, H, D, F, G = 4, 18, 32, 2, 16, 64, 2
    args = layer_inputs(B, N, C, H, D, F)
    extra = torch.randn(G, H, N, N)
    made = recorded(monkeypatch, "bias_partials", fused_layer, fused_layer1)
    with fake_cuda(monkeypatch) as lib:
        out, res = fused_layer._cuda_fwd(*args[:7], H, extra, G, None, 0.25, 1e-6, save=True)
        saved = fused_layer.AttnSaved(*args[:7], None, *res, extra, H, 0.25, 1e-6)
        b1 = fused_layer._cuda_bwd(saved, torch.zeros_like(out), False, True)
        b1_call = lib.calls["vtx_fused_attention_layer_bwd"]
        _, res = fused_layer1._cuda_fwd(*args, H, extra, G, None, None, "silu", 0.25, 1e-6,
                                        save=True)
        saved = fused_layer1.L1Saved(*args, extra, None, None, *res, H, "silu", 0.25, 1e-6)
        b2 = fused_layer1._cuda_bwd(saved, torch.zeros_like(args[0]), (False, False), True)
        b2_call = lib.calls["vtx_fused_transformer_layer_bwd"]
    assert len(made) == 2
    for call, part, dextra in ((b1_call, made[0], b1[8]), (b2_call, made[1], b2[13])):
        assert call["extra"] == extra.data_ptr() and call["groups"] == G
        assert call["dq_part"] is None
        assert call["dbpart"] == part.data_ptr()
        assert part.shape == (fused_layer.window_chunks(B, G, H), G, H, N, N)
        assert call["dextra"] == dextra.data_ptr() and dextra.shape == extra.shape


def test_bias_free_calls_refuse_heads_over_64_wide(monkeypatch):
    B, N, C, H, D, F = 2, 9, 160, 2, 80, 64
    args = layer_inputs(B, N, C, H, D, F)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="64 wide"):
        fused_layer._cuda_fwd(*args[:7], H, None, 1, None, 0.1, 1e-6, save=False)
    with fake_cuda(monkeypatch), pytest.raises(NotImplementedError, match="64 wide"):
        fused_layer1._cuda_fwd(*args, H, None, 1, None, None, "silu", 0.1, 1e-6,
                               save=False)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def within_bwd(name, k, p):
    tol = 1e-3 * max(1.0, p.abs().max().item())
    err = (k - p).abs().max().item()
    assert err <= tol, f"{name}: max|kernel-plain| {err:.3e} > {tol:.3e}"


def compare(names, out, out_p, grads, again, plain):
    assert torch.allclose(out, out_p, atol=FWD_TOL, rtol=FWD_TOL)
    for name, k, k2, p in zip(names, grads, again, plain):
        if p is None:
            assert k is None, name
            continue
        assert torch.isfinite(k).all() and k.shape == p.shape, name
        assert torch.equal(k, k2), f"{name} differs between two runs"
        within_bwd(name, k, p)


def card_inputs(shape, rows_scaled):
    """The layer's inputs on the card, a per-sample row scale of dropped and
    kept samples, and an output gradient."""
    B, N, C, H, D, F = SHAPES[shape]
    a = [t.cuda() for t in layer_inputs(B, N, C, H, D, F, seed=3)]
    r = torch.tensor([0.0] + [1 / 0.9] * (B - 1)).cuda() if rows_scaled else None
    do = torch.from_numpy(np.random.default_rng(4).standard_normal((B, N, C))
                          .astype(np.float32)).cuda()
    return a, r, do, H


@pytest.mark.cuda
@pytest.mark.parametrize("rows_scaled", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_b1_bias_free_matches_plain(shape, rows_scaled):
    """On the card: the forward within 1e-4, every gradient within
    1e-3·max(1, max|plain|) and bit-identical across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, r, do, H = card_inputs(shape, rows_scaled)
    out, saved = fused_layer.fused_attention_layer_fwd(*a[:7], H, row_scale=r)
    grads = fused_layer.fused_attention_layer_bwd(saved, do)
    again = fused_layer.fused_attention_layer_bwd(saved, do)
    out_p, saved_p = fused_layer.fused_attention_layer_fwd_reference(*a[:7], H, row_scale=r)
    plain = fused_layer.fused_attention_layer_bwd_reference(saved_p, do)
    serving = fused_layer.fused_attention_layer(*a[:7], H, row_scale=r)
    assert torch.allclose(serving, out_p, atol=FWD_TOL, rtol=FWD_TOL)
    names = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwout", "dbout", "drs",
             "dextra")
    compare(names, out, out_p, grads, again, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_b2_bias_free_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, r, do, H = card_inputs(shape, True)
    out, saved = fused_layer1.fused_transformer_layer_fwd(*a, H, None, r, r)
    grads = fused_layer1.fused_transformer_layer_bwd(saved, do)
    again = fused_layer1.fused_transformer_layer_bwd(saved, do)
    out_p, saved_p = fused_layer1.fused_transformer_layer_fwd_reference(*a, H, None, r, r)
    plain = fused_layer1.fused_transformer_layer_bwd_reference(saved_p, do)
    serving = fused_layer1.fused_transformer_layer(*a, H)
    assert torch.allclose(serving, fused_layer1.fused_transformer_layer_reference(*a, H),
                          atol=FWD_TOL, rtol=FWD_TOL)
    compare(fused_layer1.GRAD_NAMES, out, out_p, grads, again, plain)
