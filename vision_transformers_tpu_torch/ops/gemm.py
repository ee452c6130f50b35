"""The GEMM core of the port's hand-written kernels (``csrc/gemm_tc.cu``),
called alone.

Every projection inside the attention layer B1, the whole layer B2, the
whole Halo layer B4, the FF layer B7, the attention block B8 and the
map-resident Swin layer B9 runs on this one GEMM, reached from their C
entries through ``launch_gemm``, ``launch_gemm_map`` and
``launch_gemm_splitk`` (``csrc/common.cuh``).  The models never call
:func:`gemm`: it is the thin door through which chip_smoke.py's phase 3m
and the ``cuda``-marked tests hold the core against its plain version and
time it at the paths' shapes.

    out[M, N] = epilogue(a[M, K] · b[K, N])
    epilogue  = (+ bias[n]) → silu → (× rs[m // rs_rows]) → (+ res[m, n])

``form``:

- ``"rows"``: a row-major [M, K], the epilogue above;
- ``"map_res"`` / ``"map_out"``: B9's map addressing — the residual row m
  is read (map_res), or the output row m written (map_out), at map row
  ``(m // hw)·hw + pix[m % hw]`` of the same [M, N] layout, pix [hw] an
  int32 row → pixel table;
- ``"splitk"``: a is given as its transpose's storage (``at`` [K, M],
  contiguous: the weight gradients' activations), the product is taken as
  ``splits`` K-slabs summed in slab order, no epilogue.

b is any 2-D strided view (the models' ``linear.weight.t()`` and its
transpose), read in place.  A CPU tensor runs :func:`gemm_reference`; a
CUDA tensor runs the kernel or raises.
"""

from __future__ import annotations

import torch

from .fused_layer import _raise_on, check_f32, check_matrix, check_vector, ptr

__all__ = ["gemm", "gemm_reference", "map_rows_of", "FORMS", "GEMM_LAUNCHES"]

# kernel launches through :func:`gemm` (only chip_smoke.py's phase 3m and the
# card's tests call it; the ops' own launches of the core are theirs)
GEMM_LAUNCHES = 0

FORMS = {"rows": 0, "map_res": 1, "map_out": 2, "splitk": 3}


def map_rows_of(pix: torch.Tensor, M: int) -> torch.Tensor:
    """The map row of each of the M rows: (m // hw)·hw + pix[m % hw]."""
    hw = pix.numel()
    m = torch.arange(M, device=pix.device)
    return (m // hw) * hw + pix.long()[m % hw]


def gemm_reference(a, b, bias=None, silu=False, rs=None, rs_rows=1, res=None, pix=None,
                   form="rows"):
    """Plain f32 version of :func:`gemm` (for ``"splitk"`` ``a`` is the
    [K, M] storage of the left operand's transpose)."""
    lhs = a.float().t() if form == "splitk" else a.float()
    out = lhs @ b.float()
    if form == "splitk":
        return out
    if bias is not None:
        out = out + bias.float()
    if silu:
        out = out / (1 + torch.exp(-out))
    if rs is not None:
        out = out * rs.float().repeat_interleave(rs_rows)[:out.shape[0], None]
    rows = None if form == "rows" else map_rows_of(pix, out.shape[0])
    if res is not None:
        out = out + (res.float()[rows] if form == "map_res" else res.float())
    if form == "map_out":
        placed = torch.empty_like(out)
        placed[rows] = out
        out = placed
    return out


def gemm(a, b, bias=None, silu=False, rs=None, rs_rows=1, res=None, pix=None,
         form="rows", splits=1):
    """out [M, N] = epilogue(a · b) on the GEMM core; see the module."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {sorted(FORMS)}, got {form!r}")
    if a.is_cuda:
        return _cuda_gemm(a, b, bias, silu, rs, rs_rows, res, pix, form, splits)
    if a.device.type != "cpu":
        raise NotImplementedError(f"no gemm for device {a.device}")
    return gemm_reference(a, b, bias, silu, rs, rs_rows, res, pix, form)


def _cuda_gemm(a, b, bias, silu, rs, rs_rows, res, pix, form, splits):
    """The kernel launch behind :func:`gemm`, after the checks of what it
    takes."""
    global GEMM_LAUNCHES
    check_f32(a.device, a=a, b=b, bias=bias, rs=rs, res=res)
    if a.ndim != 2 or not a.is_contiguous() or b.ndim != 2:
        raise ValueError(f"a must be a contiguous 2-D tensor and b 2-D, got "
                         f"{tuple(a.shape)} strides {a.stride()}, {tuple(b.shape)}")
    K, M = a.shape if form == "splitk" else a.shape[::-1]
    N = b.shape[1]
    check_matrix("b", b, K, N)
    if form == "splitk":
        if any(t is not None for t in (bias, rs, res)) or silu:
            raise ValueError("the split-K form takes no epilogue")
        if splits < 1:
            raise ValueError(f"splits must be ≥ 1, got {splits}")
    else:
        check_vector("bias", bias, N)
        if rs is not None and (rs.ndim != 1 or not rs.is_contiguous() or rs_rows < 1
                               or rs.numel() * rs_rows < M):
            raise ValueError(f"rs must cover {M} rows at {rs_rows} a scale, got "
                             f"{tuple(rs.shape)}")
        if res is not None and (tuple(res.shape) != (M, N) or not res.is_contiguous()):
            raise ValueError(f"res must be a contiguous [{M}, {N}], got {tuple(res.shape)}")
    if form in ("map_res", "map_out"):
        if pix is None or pix.dtype != torch.int32 or pix.device != a.device \
                or pix.ndim != 1 or not pix.is_contiguous() or M % pix.numel():
            raise ValueError("the map forms take pix, a contiguous int32 table on the "
                             "device whose length divides M")
    from ._build import build

    lib = build()
    opts = dict(device=a.device, dtype=torch.float32)
    out = torch.empty((M, N), **opts)
    part = torch.empty((splits * M * N,), **opts) if form == "splitk" else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        GEMM_LAUNCHES += 1
        err = lib.vtx_gemm_tc(
            ptr(a), M if form == "splitk" else K, ptr(b), b.stride(0), b.stride(1),
            ptr(bias), ptr(rs), rs_rows, ptr(res), ptr(out), ptr(pix),
            0 if pix is None else pix.numel(), FORMS[form], ptr(part), splits, N, 1,
            M, N, K, int(silu), stream)
    _raise_on(err, "gemm")
    return out
