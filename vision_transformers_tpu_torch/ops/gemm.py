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

What the core takes in of the layers' passes (``GemmExtra`` in
``csrc/common.cuh``), in the row form and, for the producer's transforms,
the split-K form:

- ``ln=(mu, rstd, g, b)``: a is staged as the LayerNorm apply
  ``(a − mu[t])·rstd[t]·g[f] + b[f]`` (t the token: a's row, or in the
  split-K form its k; f the feature) — :func:`stage_a`;
- ``act_a="silu" | "gelu"``: a is staged as act(a);
- ``rs_b=r, rs_b_rows=R``: b's row k is staged × r[k // R];
- ``hid=h`` (row form): after the bias and silu, the epilogue takes the row
  partials of v·act(h) (``row_partials``), then v ×= rs, v ×= act'(h);
  ``col_partials`` asks for the column sums of the final value per 16-row
  slice.  :func:`epilogue_partials` emulates both in the kernel's order.

A call takes A's LayerNorm, or act on A (with B's row scale where given),
or B's row scale alone, or the epilogue's options.  With either partial
asked for, :func:`gemm` returns (out, rpart, cpart): rpart [M, ceil(N /
64)], cpart [ceil(M / 16), N] (None where not asked).

The core's bf16 form, :func:`gemm_bf16` (the projections of B1 and B2 at
the JAX package's default precision): a, b, bias and res bfloat16, rs f32,
f32 sums; the row form rounds where the JAX kernels round,
``round(round(round(a·b) + bias)·round(rs)) + res`` rounded (silu after the
bias, rounded), or with ``out_f32`` returns the f32 sums; the split-K form
returns the f32 sum of its slabs.  Neither takes the passes' options.
:func:`gemm_bf16_reference` is its plain version.  The kernel routes by
shape (``csrc/gemm_tc.cu``): by TMA (``csrc/gemm_bf16_tma.cuh``) wherever
every operand's rows and the output's are 16-byte strides from 16-byte
bases (b may be K-major, the forward's ``w.t()``, or N-major, the data
gradients' weight read in place), else on the register path; the TMA
path picks its tile width by N.  ``promote`` chooses the TMA path's
accumulation for chip_smoke.py's promotion check (``True``: the sums
promoted every 64 k, at f32 out, K-major operands; ``False``: one
accumulator over K, the rule's); None keeps the rule's, and a choice the
kernels do not take raises.  ``plan=True`` also returns what ran:
:data:`PLAN_KEYS` → values (route "tma" or "registers").
"""

from __future__ import annotations

import ctypes

import torch

from .fused_layer import (_act, _act_grad, _raise_on, _rb, check_dtype, check_f32, check_matrix,
                          check_vector, ptr)

__all__ = ["gemm", "gemm_reference", "map_rows_of", "stage_a", "epilogue_partials",
           "drs_sums", "FORMS", "ACTS", "GEMM_LAUNCHES", "RPART_COLS", "CPART_ROWS",
           "gemm_bf16", "gemm_bf16_reference", "PLAN_KEYS"]

# kernel launches through :func:`gemm` (only chip_smoke.py's phase 3m and the
# card's tests call it; the ops' own launches of the core are theirs)
GEMM_LAUNCHES = 0

FORMS = {"rows": 0, "map_res": 1, "map_out": 2, "splitk": 3}
ACTS = {None: -1, "silu": 0, "gelu": 1}  # csrc/common.cuh ACT_NONE, ACT_SILU, ACT_GELU
RPART_COLS = 64   # csrc/common.cuh: the row partials' column groups
CPART_ROWS = 16   # csrc/common.cuh: the column partials' row slices
DRS_ROWS = 64     # csrc/common.cuh: rows a block of the dr pass sums
PLAN_KEYS = ("route", "bn", "promote", "stages")  # csrc/common.cuh Bf16Opts


def map_rows_of(pix: torch.Tensor, M: int) -> torch.Tensor:
    """The map row of each of the M rows: (m // hw)·hw + pix[m % hw]."""
    hw = pix.numel()
    m = torch.arange(M, device=pix.device)
    return (m // hw) * hw + pix.long()[m % hw]


def stage_a(a, ln=None, act=None, token_is_k=False):
    """The value the producer stages of operand a (its [M, K] view; the
    split-K form: ``token_is_k``, a's rows the features): the LayerNorm
    apply in ln_rows_kernel's expression, ((a − mu)·rstd)·g + b, or act(a),
    or a itself."""
    a = a.float()
    if ln is not None:
        mu, rstd, g, b = (t.float() for t in ln)
        if token_is_k:
            return (a - mu[None, :]) * rstd[None, :] * g[:, None] + b[:, None]
        return (a - mu[:, None]) * rstd[:, None] * g[None, :] + b[None, :]
    if act is not None:
        return _act(a, act)
    return a


def _scale_rows(x, rs, rows):
    return x * rs.float().repeat_interleave(rows)[:x.shape[0], None]


def _pad(x, dim, multiple):
    pad = -x.shape[dim] % multiple
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


def epilogue_partials(prod, value):
    """The epilogue's partial sums in the kernel's order (csrc/gemm_tc.cu):
    ``prod`` [M, N] the row partials' terms (v·act(hid)), ``value`` [M, N]
    the final values.  → rpart [M, ceil(N / 64)]: each lane sums its 16
    columns (8j + 2·lane + e of the group, j then e), then the four lanes
    as a shuffle tree ((l0 + l1) + (l2 + l3)); cpart [ceil(M / 16), N]: a
    lane's two rows (q and q + 8 of the 16-row slice), then the eight lane
    rows as a shuffle tree."""
    p = _pad(prod.float(), 1, RPART_COLS)
    M, Np = p.shape
    p = p.reshape(M, Np // RPART_COLS, 8, 4, 2)       # (m, group, j, lane, e)
    t = p.new_zeros(M, Np // RPART_COLS, 4)
    for j in range(8):
        for e in range(2):
            t = t + p[:, :, j, :, e]
    t = t[..., 0::2] + t[..., 1::2]                    # lane ⊕ 1
    rpart = t[..., 0] + t[..., 1]                      # lane ⊕ 2

    v = _pad(value.float(), 0, CPART_ROWS)
    v = v.reshape(v.shape[0] // CPART_ROWS, 2, 8, -1)  # (slice, h, q, n)
    c = (torch.zeros_like(v[:, 0]) + v[:, 0]) + v[:, 1]
    for _ in range(3):                                 # q ⊕ 1, ⊕ 2, ⊕ 4
        c = c[:, 0::2] + c[:, 1::2]
    return rpart, c[:, 0]


def drs_sums(rpart, dy, bias, rows_per_scale):
    """The row-scale gradient from the row partials: per sample, Σ over its
    rows of the partials and of dy·bias (csrc/common.cuh drs_part_kernel),
    chunk by chunk of DRS_ROWS rows, the chunks in order."""
    M = rpart.shape[0]
    per_row = rpart.float().sum(1)
    if bias is not None:
        per_row = per_row + (dy.float().reshape(M, -1) * bias.float()).sum(1)
    per = per_row.reshape(-1, rows_per_scale)
    out = per.new_zeros(per.shape[0])
    for z in range(0, rows_per_scale, DRS_ROWS):
        out = out + per[:, z:z + DRS_ROWS].sum(1)
    return out


def gemm_reference(a, b, bias=None, silu=False, rs=None, rs_rows=1, res=None, pix=None,
                   form="rows", ln=None, act_a=None, rs_b=None, rs_b_rows=1, hid=None,
                   hid_act="silu", row_partials=False, col_partials=False):
    """Plain f32 version of :func:`gemm` (for ``"splitk"`` ``a`` is the
    [K, M] storage of the left operand's transpose)."""
    splitk = form == "splitk"
    lhs = stage_a(a.t() if splitk else a, ln, act_a, token_is_k=splitk)
    rhs = b.float() if rs_b is None else _scale_rows(b.float(), rs_b, rs_b_rows)
    out = lhs @ rhs
    if splitk:
        return out
    if bias is not None:
        out = out + bias.float()
    if silu:
        out = out / (1 + torch.exp(-out))
    prod = None
    if hid is not None:
        prod = out * _act(hid.float(), hid_act)
    if rs is not None:
        out = _scale_rows(out, rs, rs_rows)
    if hid is not None:
        out = out * _act_grad(hid.float(), hid_act)
    rows = None if form == "rows" else map_rows_of(pix, out.shape[0])
    if res is not None:
        out = out + (res.float()[rows] if form == "map_res" else res.float())
    if form == "map_out":
        placed = torch.empty_like(out)
        placed[rows] = out
        out = placed
    if not (row_partials or col_partials):
        return out
    rpart, cpart = epilogue_partials(prod if prod is not None else torch.zeros_like(out),
                                     out)
    return out, rpart if row_partials else None, cpart if col_partials else None


def gemm(a, b, bias=None, silu=False, rs=None, rs_rows=1, res=None, pix=None,
         form="rows", splits=1, **extra):
    """out [M, N] = epilogue(a · b) on the GEMM core; see the module.
    ``extra``: ln, act_a, rs_b, rs_b_rows, hid, hid_act, row_partials,
    col_partials."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {sorted(FORMS)}, got {form!r}")
    if a.is_cuda:
        return _cuda_gemm(a, b, bias, silu, rs, rs_rows, res, pix, form, splits, **extra)
    if a.device.type != "cpu":
        raise NotImplementedError(f"no gemm for device {a.device}")
    return gemm_reference(a, b, bias, silu, rs, rs_rows, res, pix, form, **extra)


def _cuda_gemm(a, b, bias, silu, rs, rs_rows, res, pix, form, splits, ln=None, act_a=None,
               rs_b=None, rs_b_rows=1, hid=None, hid_act="silu", row_partials=False,
               col_partials=False):
    """The kernel launch behind :func:`gemm`, after the checks of what it
    takes."""
    global GEMM_LAUNCHES
    ln_t = tuple(ln) if ln is not None else (None,) * 4
    check_f32(a.device, a=a, b=b, bias=bias, rs=rs, res=res, ln_mu=ln_t[0], ln_rstd=ln_t[1],
              ln_g=ln_t[2], ln_b=ln_t[3], rs_b=rs_b, hid=hid)
    if a.ndim != 2 or not a.is_contiguous() or b.ndim != 2:
        raise ValueError(f"a must be a contiguous 2-D tensor and b 2-D, got "
                         f"{tuple(a.shape)} strides {a.stride()}, {tuple(b.shape)}")
    K, M = a.shape if form == "splitk" else a.shape[::-1]
    N = b.shape[1]
    check_matrix("b", b, K, N)
    if act_a not in ACTS or hid_act not in ("silu", "gelu"):
        raise ValueError(f"act_a must be one of {list(ACTS)} and hid_act silu or gelu, got "
                         f"{act_a!r}, {hid_act!r}")
    if ln is not None:
        tokens, feats = (K, M) if form == "splitk" else (M, K)
        for name, t, n in zip(("mu", "rstd", "g", "b"), ln, (tokens, tokens, feats, feats)):
            check_vector(f"ln's {name}", t, n)
    if rs_b is not None and (rs_b.ndim != 1 or not rs_b.is_contiguous() or rs_b_rows < 1
                             or rs_b.numel() * rs_b_rows < K):
        raise ValueError(f"rs_b must cover {K} rows of b at {rs_b_rows} a scale, got "
                         f"{tuple(rs_b.shape)}")
    epilogue_extra = hid is not None or row_partials or col_partials
    if form == "splitk":
        if any(t is not None for t in (bias, rs, res)) or silu or epilogue_extra:
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
        if epilogue_extra or ln is not None or act_a is not None or rs_b is not None:
            raise ValueError("the map forms take none of the passes' options")
    if ln is not None and (act_a is not None or rs_b is not None):
        raise ValueError("the producer takes A's LayerNorm alone: not with act_a or rs_b")
    if epilogue_extra and (ln is not None or act_a is not None or rs_b is not None):
        raise ValueError("a call takes the producer's transforms or the epilogue's "
                         "options, not both")
    if row_partials and hid is None:
        raise ValueError("the row partials are of v·act(hid): they need hid")
    if hid is not None and (tuple(hid.shape) != (M, N) or not hid.is_contiguous()):
        raise ValueError(f"hid must be a contiguous [{M}, {N}], got {tuple(hid.shape)}")
    from ._build import build

    lib = build()
    opts = dict(device=a.device, dtype=torch.float32)
    out = torch.empty((M, N), **opts)
    part = torch.empty((splits * M * N,), **opts) if form == "splitk" else None
    rpart = torch.empty((M, -(-N // RPART_COLS)), **opts) if row_partials else None
    cpart = torch.empty((-(-M // CPART_ROWS), N), **opts) if col_partials else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        GEMM_LAUNCHES += 1
        err = lib.vtx_gemm_tc(
            ptr(a), M if form == "splitk" else K, ptr(b), b.stride(0), b.stride(1),
            ptr(bias), ptr(rs), rs_rows, ptr(res), ptr(out), ptr(pix),
            0 if pix is None else pix.numel(), FORMS[form], ptr(part), splits, N, 1,
            M, N, K, int(silu), *map(ptr, ln_t), ACTS[act_a], ptr(rs_b), rs_b_rows,
            ptr(hid), ACTS[hid_act], ptr(rpart), ptr(cpart), stream)
    _raise_on(err, "gemm")
    if row_partials or col_partials:
        return out, rpart, cpart
    return out


def gemm_bf16_reference(a, b, bias=None, silu=False, rs=None, rs_rows=1, res=None,
                        form="rows", out_f32=False):
    """Plain version of :func:`gemm_bf16` (``"splitk"``: ``a`` the [K, M]
    storage of the left operand's transpose): f32 products of the bf16
    values, the JAX kernels' rounding points after."""
    bf = torch.bfloat16
    lhs = (a.t() if form == "splitk" else a).float()
    out = lhs @ b.float()
    if form == "splitk" or out_f32:
        return out
    out = _rb(out, bf)
    if bias is not None:
        out = _rb(out + bias.float(), bf)
    if silu:
        out = _rb(out * torch.sigmoid(out), bf)
    if rs is not None:
        out = _rb(_scale_rows(out, _rb(rs.float(), bf), rs_rows), bf)
    if res is not None:
        out = out + res.float()
    return out.to(bf)


def gemm_bf16(a, b, bias=None, silu=False, rs=None, rs_rows=1, res=None, form="rows",
              splits=1, out_f32=False, promote=None, plan=False):
    """The GEMM core's bf16 form; see the module.  A CPU tensor runs
    :func:`gemm_bf16_reference` (and takes no kernel choice)."""
    if form not in ("rows", "splitk"):
        raise ValueError(f"the bf16 form takes form 'rows' or 'splitk', got {form!r}")
    if promote is not None and not isinstance(promote, bool):
        raise ValueError(f"promote must be None or a bool, got {promote!r}")
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise NotImplementedError(f"no gemm for device {a.device}")
        if plan or promote is not None:
            raise ValueError("the plain version has no kernel to choose or plan")
        return gemm_bf16_reference(a, b, bias, silu, rs, rs_rows, res, form, out_f32)
    global GEMM_LAUNCHES
    check_dtype(a.device, torch.bfloat16, a=a, b=b, bias=bias, res=res)
    check_dtype(a.device, torch.float32, rs=rs)
    if a.ndim != 2 or not a.is_contiguous() or b.ndim != 2:
        raise ValueError(f"a must be a contiguous 2-D tensor and b 2-D, got "
                         f"{tuple(a.shape)} strides {a.stride()}, {tuple(b.shape)}")
    K, M = a.shape if form == "splitk" else a.shape[::-1]
    N = b.shape[1]
    check_matrix("b", b, K, N)
    splitk = form == "splitk"
    if splitk and (any(t is not None for t in (bias, rs, res)) or silu or out_f32):
        raise ValueError("the split-K form takes no epilogue")
    if not splitk:
        check_vector("bias", bias, N)
        if out_f32 and (any(t is not None for t in (bias, rs, res)) or silu):
            raise ValueError("out_f32 takes no epilogue")
        if res is not None and (tuple(res.shape) != (M, N) or not res.is_contiguous()):
            raise ValueError(f"res must be a contiguous [{M}, {N}], got {tuple(res.shape)}")
    from ._build import build

    lib = build()
    f32 = splitk or out_f32
    out = torch.empty((M, N), device=a.device, dtype=torch.float32 if f32 else torch.bfloat16)
    part = torch.empty((splits * M * N,), device=a.device) if splitk else None
    ran = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        GEMM_LAUNCHES += 1
        err = lib.vtx_gemm_tc_bf16(
            ptr(a), M if splitk else K, ptr(b), b.stride(0), b.stride(1), ptr(bias), ptr(rs),
            rs_rows, ptr(res), ptr(out), int(out_f32), FORMS[form], ptr(part), splits, N, 1,
            M, N, K, int(silu), {None: 0, True: 1, False: 2}[promote], ran, stream)
    _raise_on(err, "gemm_bf16")
    if not plan:
        return out
    route = {"route": "tma" if ran[0] else "registers", "bn": ran[1], "promote": ran[2] == 1,
             "stages": ran[3]}
    return out, route
