"""The GEMM core's thin door, ops/gemm.py::gemm (csrc/gemm_tc.cu's
``vtx_gemm_tc``), which chip_smoke.py's phase 3m and the ``cuda`` tests
use to hold the core alone.  Imports no JAX, so the ``cuda``-marked tests
run on a card (README: the card-only tests).

- On the CPU, ``gemm`` is its plain version: each form against torch
  written out (the epilogue bias → silu → row scale → residual; B9's map
  forms, the residual read or the output written at the map row; split-K
  over Aᵀ storage).
- The CUDA wrapper, with the kernel library replaced by ctypes callbacks
  of the declared signatures: each form passes every argument the C entry
  declares (the form code, the leading dimension, the weight view's
  strides, the row table, the slabs' workspace) and counts one launch;
  what the kernel does not take raises.
- On a card (marker ``cuda``): every form at odd shapes within atol = rtol
  = 1e-4 of the plain version, split-K within 1e-3·max(1, max|plain|) and
  bit-identical across two runs.
"""

import numpy as np
import pytest
import torch

from test_torch_port_halo_entry import fake_cuda
from vision_transformers_tpu_torch.ops import gemm as gm


def operands(M, N, K, seed=0):
    """a [M, K], the weight as a w.t() view [K, N], bias, a row scale per 5
    rows, a residual, and a permutation table of 7 rows."""
    rng = np.random.default_rng([seed, M, N, K])

    def n(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32))

    pix = torch.from_numpy(rng.permutation(7).astype(np.int32))
    return n(M, K), n(N, K, s=K ** -0.5).t(), n(N, s=0.1), 0.5 + n(-(-M // 5)).abs(), \
        n(M, N), pix


def test_cpu_rows_form_is_the_epilogue_written_out():
    a, b, bias, rs, res, _ = operands(21, 10, 13)
    out = gm.gemm(a, b, bias, True, rs, 5, res)
    z = a @ b + bias
    want = z * torch.sigmoid(z) * rs.repeat_interleave(5)[:21, None] + res
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(gm.gemm(a, b), a @ b, atol=0, rtol=0)


@pytest.mark.parametrize("form", ["map_res", "map_out"])
def test_cpu_map_forms_address_the_map_row(form):
    a, b, bias, rs, res, pix = operands(21, 10, 13)
    out = gm.gemm(a, b, bias, False, rs, 7, res, pix, form)
    rows = (torch.arange(21) // 7) * 7 + pix.long()[torch.arange(21) % 7]
    y = (a @ b + bias) * rs.repeat_interleave(7)[:21, None]
    if form == "map_res":  # row m reads the residual's map row
        torch.testing.assert_close(out, y + res[rows], atol=1e-6, rtol=1e-6)
    else:  # row m is written to its map row
        torch.testing.assert_close(out[rows], y + res, atol=1e-6, rtol=1e-6)
    assert torch.equal(gm.map_rows_of(pix, 21), rows)


def test_cpu_splitk_form_takes_the_transposes_storage():
    at, dy = torch.randn(50, 6), torch.randn(50, 9)
    torch.testing.assert_close(gm.gemm(at, dy, form="splitk", splits=3), at.t() @ dy,
                               atol=0, rtol=0)


@pytest.mark.parametrize("form", sorted(gm.FORMS))
def test_cuda_wrapper_passes_every_argument(monkeypatch, form):
    a, b, bias, rs, res, pix = operands(21, 10, 13)
    if form == "splitk":
        a, b, kw = torch.randn(13, 21), torch.randn(13, 10), dict(splits=4)
    elif form == "rows":
        kw = dict(bias=bias, silu=True, rs=rs, rs_rows=5, res=res)
    else:
        kw = dict(bias=bias, rs=rs[:3].contiguous(), rs_rows=7, res=res, pix=pix)
    with fake_cuda(monkeypatch) as lib:
        before = gm.GEMM_LAUNCHES
        out = gm._cuda_gemm(a, b, kw.get("bias"), kw.get("silu", False), kw.get("rs"),
                            kw.get("rs_rows", 1), kw.get("res"), kw.get("pix"), form,
                            kw.get("splits", 1))
        call = lib.calls["vtx_gemm_tc"]
    assert gm.GEMM_LAUNCHES == before + 1 and out.shape == (21, 10)
    assert call[0] == a.data_ptr() and call[2:5] == (b.data_ptr(), *b.stride())
    assert call[1] == (21 if form == "splitk" else 13)  # lda: M for Aᵀ storage
    assert call[9] == out.data_ptr() and call[12] == gm.FORMS[form]
    assert call[17:21] == (21, 10, 13, int(form == "rows"))
    if form == "splitk":
        assert call[5:9] == (None, None, 1, None) and call[13] is not None
        assert call[14:17] == (4, 10, 1)  # slabs, out strides
    else:
        assert call[5] == bias.data_ptr() and call[6] == kw["rs"].data_ptr()
        assert call[7:9] == (kw["rs_rows"], res.data_ptr()) and call[13] is None
    if form.startswith("map"):
        assert call[10:12] == (pix.data_ptr(), 7)
    else:
        assert call[10:12] == (None, 0)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    a, b, bias, rs, res, pix = operands(21, 10, 13)
    cases = [
        (ValueError, "form must be", dict(form="cols")),
        (ValueError, "b must be", dict(b=b[:-1])),
        (ValueError, "contiguous 2-D", dict(a=a.t().contiguous().t())),
        (NotImplementedError, "float32", dict(a=a.double())),
        (ValueError, "no epilogue", dict(form="splitk", bias=bias)),
        (ValueError, "rs must cover", dict(rs=rs[:2], rs_rows=5)),
        (ValueError, "res must be", dict(res=res[:, :-1])),
        (ValueError, "the map forms take pix", dict(form="map_out", pix=pix.long())),
        (ValueError, "the map forms take pix", dict(form="map_res", pix=pix[:5])),
    ]
    for err, match, kw in cases:
        args = dict(a=a, b=b, form="rows") | kw
        if args["form"] == "splitk":
            args["a"] = torch.randn(13, 21)
        with fake_cuda(monkeypatch), pytest.raises(err, match=match):
            if args["form"] not in gm.FORMS:
                gm.gemm(**args)
            else:
                gm._cuda_gemm(args["a"], args["b"], args.get("bias"), False, args.get("rs"),
                              args.get("rs_rows", 1), args.get("res"), args.get("pix"),
                              args["form"], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(gm.FORMS))
@pytest.mark.parametrize("M,N,K", [(37, 29, 45), (300, 200, 100), (130, 7, 1536)])
def test_cuda_gemm_matches_plain(form, M, N, K):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    if form == "splitk":
        at, dy = torch.randn(K, M), torch.randn(K, N)
        out = gm.gemm(at.cuda(), dy.cuda(), form="splitk", splits=3)
        again = gm.gemm(at.cuda(), dy.cuda(), form="splitk", splits=3)
        plain = gm.gemm_reference(at, dy, form="splitk")
        assert torch.equal(out, again)
        assert (out.cpu() - plain).abs().max().item() <= 1e-3 * max(
            1.0, plain.abs().max().item())
        return
    a, b, bias, rs, res, _ = operands(M * 7, N, K)
    pix = torch.randperm(7, generator=torch.Generator().manual_seed(M)).to(torch.int32)
    args = (a, b, bias, True, rs, 5, res) + ((pix, form) if form != "rows" else ())
    out = gm.gemm(*(t.cuda() if isinstance(t, torch.Tensor) else t for t in args))
    torch.testing.assert_close(out.cpu(), gm.gemm_reference(*args), atol=1e-4, rtol=1e-4)
