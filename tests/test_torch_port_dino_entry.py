"""B1 (the attention layer) with the block-diagonal mask of DINO's packed
local crops at heads 64 wide: its calls leave the window attention (heads
up to 32 wide) for the packed-row tensor-core core (csrc/attention_tc.cuh
through ``vtx::packed_attention_fwd`` / ``_bwd``), the bias added in f32
after the product.

On the CPU the wrappers are driven through ctypes callbacks of the declared
signatures: the mask reaches the C entry with heads 64 wide, the backward
passes the core's dq partials [ceil(N / 64), B·N, H·D] and, the mask
needing no gradient, no dS buffer; the bias launches are counted; calls
the window attention takes (Twins' heads 16 wide) still pass its dbias
partials.  The ``cuda`` tests hold the kernels at the DINO local call
(111 tokens, 3 crops of 37 a row) against the plain versions on the card:
forward within 1e-4, every gradient within 1e-3·max(1, max|plain|) and
bit-identical across two runs, and every masked probability exactly 0 (the
output of a crop does not move with the other crops' tokens).  No JAX here,
so the ``cuda`` tests run where JAX is absent.
"""

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch.models.vit import pack_mask
from vision_transformers_tpu_torch.ops import fused_layer
from test_torch_port_vit_attention_tc import (compare, expected_partials, fake_cuda,
                                              layer_inputs, recorded)
from torch_port_threads import one_torch_thread  # noqa: F401

GRAD_NAMES = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwout", "dbout", "drs")


def test_window_route_rule():
    assert fused_layer.window_on_bias(True, 98, 32)      # Twins / Swin pairs
    assert not fused_layer.window_on_bias(True, 111, 64)  # DINO's packed locals
    assert not fused_layer.window_on_bias(True, 129, 32)
    assert not fused_layer.window_on_bias(False, 49, 32)


@pytest.mark.parametrize("need_dextra", [False, True], ids=["mask", "bias_with_grad"])
def test_b1_mask_at_heads_64_wide_takes_the_packed_core(monkeypatch, need_dextra):
    B, N, C, H, D, F = 4, 74, 128, 2, 64, 256  # 2 crops of 37 a row: two key tiles
    args = layer_inputs(B, N, C, H, D, F)[:7]
    mask = pack_mask(2, 37, "cpu")
    made = recorded(monkeypatch, "dq_partials", fused_layer)
    windows = recorded(monkeypatch, "bias_partials", fused_layer)
    with fake_cuda(monkeypatch) as lib:
        before = (fused_layer.LAUNCHES, fused_layer.BIAS_LAUNCHES, fused_layer.BWD_LAUNCHES,
                  fused_layer.BIAS_BWD_LAUNCHES)
        extra_g, groups = fused_layer.extra_groups(mask, B, H, N)
        out, res = fused_layer._cuda_fwd(*args, H, extra_g, groups, None, D ** -0.5, 1e-6,
                                         save=True)
        fwd = lib.calls["vtx_fused_attention_layer_fwd"]
        saved = fused_layer.AttnSaved(*args, None, *res, extra_g, H, D ** -0.5, 1e-6)
        grads = fused_layer._cuda_bwd(saved, torch.zeros_like(out), False, need_dextra)
        bwd = lib.calls["vtx_fused_attention_layer_bwd"]
    after = (fused_layer.LAUNCHES, fused_layer.BIAS_LAUNCHES, fused_layer.BWD_LAUNCHES,
             fused_layer.BIAS_BWD_LAUNCHES)
    assert after == tuple(b + 1 for b in before)
    assert fwd["extra"] == extra_g.data_ptr() and fwd["groups"] == 1 and fwd["D"] == 64
    assert bwd["extra"] == extra_g.data_ptr() and bwd["lse"] == res[4].data_ptr()
    assert windows == [] and len(made) == 1
    assert made[0].shape == expected_partials(B, N, H, D)
    assert bwd["dq_part"] == made[0].data_ptr()
    if need_dextra:  # the core's dS buffer [B, H, N, N], summed over the rows
        assert bwd["dbpart"] is not None and grads[8].shape == (1, H, N, N)
        assert bwd["dextra"] == grads[8].data_ptr()
    else:
        assert bwd["dbpart"] is None and bwd["dextra"] is None and grads[8] is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def card_inputs(B, N, C, H, D, seed=3):
    a = [t.cuda() for t in layer_inputs(B, N, C, H, D, 4 * C, seed=seed)[:7]]
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((B, N, C))
                          .astype(np.float32)).cuda()
    return a, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 111, 128, 2, 64), (4, 74, 128, 2, 64)],
                         ids=["pack3_N111", "pack2_N74"])
def test_cuda_b1_with_the_dino_mask_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, C, H, D = shape
    pack = N // 37
    mask = pack_mask(pack, 37, "cuda")
    a, do = card_inputs(B, N, C, H, D)
    with torch.no_grad():
        serving = fused_layer.fused_attention_layer(*a, H, extra=mask)
    out, saved = fused_layer.fused_attention_layer_fwd(*a, H, extra=mask)
    grads = fused_layer.fused_attention_layer_bwd(saved, do, need_dextra=False)
    again = fused_layer.fused_attention_layer_bwd(saved, do, need_dextra=False)
    out_p, saved_p = fused_layer.fused_attention_layer_fwd_reference(
        *a, H, extra_g=saved.extra_g)
    plain = fused_layer.fused_attention_layer_bwd_reference(saved_p, do, need_dextra=False)
    assert torch.allclose(serving, out_p, atol=1e-4, rtol=1e-4)
    compare(("out",) + GRAD_NAMES + ("dextra",), out, out_p, (out,) + grads,
            (out,) + again, (out_p,) + plain)
    assert torch.isfinite(saved.lse).all()
    # the crops do not see each other: moving the last crop's tokens leaves
    # the first crop's output exactly as it was
    x2 = a[0].clone()
    x2[:, -37:] += 1.0
    with torch.no_grad():
        moved = fused_layer.fused_attention_layer(x2, *a[1:], H, extra=mask)
    assert torch.equal(moved[:, :37], serving[:, :37])
