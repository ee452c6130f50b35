"""The precision argument of the GEMM core (csrc/gemm_tc.cu), checked on
the CPU.

Every projection of the attention layer B1, the whole layer B2, the Halo
layer B4, the FF layer B7, the attention block B8 and the map-resident Swin
layer B9 runs on one GEMM that takes its products on the tensor cores in
3xTF32 (wgmma): each operand is split ONCE, as its tile is staged into
shared memory, as hi = tf32(x), lo = tf32(x − hi), both rounded by
``cvt.rna.tf32.f32`` (10 mantissa bits, to nearest, ties away from zero);
each 8-deep k step then adds lo·hi, hi·lo and hi·hi to f32 accumulators, the
small terms first.  The split-K form (the weight gradients xᵀ·dY over every
row of the batch) takes the rows in ``splits`` slabs of whole 16-deep steps
(``ops/fused_layer.py::_splits``), each summed on its own, then the slabs
in slab order.  Here torch emulates those products bit for bit in the
rounding of their operands, in the kernel's k-step (row forms) or slab
(split-K) order, and holds them to chip_smoke.py's limits against the f32
plain product:

- the row forms at each K the paths give (96: Swin-S stage 1 and Halo-S's
  projections; 192, 384, 768; 1536: ViT-S/16's and Swin-S stage 3's FF2;
  3072: Swin-S stage 4's), a few dozen output rows and columns of full K,
  activations of std 1 and 3 against a weight of std · K^-½ (chip_smoke's
  phase 3m inputs): within atol = rtol = 1e-4 (phase 3m and phase 3's
  forward limit) in 3xTF32, and outside it in one TF32 pass;
- the split-K weight gradients over the trainer's rows (ViT-S/16's 25,216,
  Swin-S stage 1's 200,704 at 64 images) in the slabs ``_splits`` gives the
  real [C, 3C] gradient: within 1e-3·max(1, max|plain|) (phase 3m's and 3b's
  backward limit) in 3xTF32.  One TF32 pass stays inside that relative
  limit too, at ~3e-4 of max|plain| (its error, ~2⁻¹¹ per product, averages
  out over 10⁵ rows), so there the tests also hold 3xTF32 to f32's own
  error: within 2e-6 of max|plain| (the f32 plain product is itself ~4e-7
  off the exact sum), where one pass is over 1e-4.

In the row forms one TF32 pass misses the limit by 7-9x at std 1 and by
50-75x at std 3, while 3xTF32 uses 1-13% of it.

The tensor cores' own f32 accumulation truncates (on the H100 the GEMM's
error grew in proportion to K, and a single accumulator over K = 3072
missed the 1e-4 limit: PERF.md), so the kernel adds the products of
each group of ``PROMOTE_K`` k into its sums with one f32 add (round to
nearest).  The emulation of that accumulator, each k step's product added
with its f32 sum rounded toward zero, shows both: a single accumulator
misses the limit at K = 1536 and 3072 (std 3), the promoted sums hold it at
every K.
"""

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch.ops import fused_layer as fl
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4            # chip_smoke.KERNEL_TOL: phase 3m's row forms, phase 3's forwards
BWD_TOL = 1e-3        # phase 3m's split-K and phase 3b's limit, × max(1, max|plain|)
BK = 16               # csrc/gemm_tc.cu: the depth of a staged slab
PROMOTE_K = 4 * BK    # csrc/gemm_tc.cu: k between two promotions (PROMOTE slabs)
K_OF_PATHS = (96, 192, 384, 768, 1536, 3072)
ROWS, COLS = 40, 36   # a few dozen outputs of full K
# (name, rows of the batch, the gradient's [M, N] whose _splits gives the slabs)
SPLITK = (("vit_s16_dwqkv", 25216, (384, 1152)), ("swin_s_stage1_dwqkv", 200704, (96, 288)))
SPLITK_COLS = 24


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded as cvt.rna.tf32.f32 rounds it: add half a unit of the 13
    dropped bits to the bit pattern, then clear them."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo) as the kernel's staging splits an element."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def products(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a·b over the whole of K in TF32 operands: lo·hi + hi·lo + hi·hi
    (passes = 3) or hi·hi (passes = 1)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def gemm_rows(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """The row forms: f32 accumulators, one 8-deep k step after another,
    each step's passes small terms first."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        acc = acc + products(a[:, k:k + 8], b[k:k + 8], passes)
    return acc


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 values rounded to f32 toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def gemm_tensor_cores(a: torch.Tensor, b: torch.Tensor, promote_k=None) -> torch.Tensor:
    """The row forms on a truncating accumulator: each k step's three passes
    (8 products each, summed exactly) added to it in turn, the sum rounded
    toward zero; every ``promote_k`` k (None: never) it is added to the f32
    sums and restarts from zero."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    part = torch.zeros_like(acc)
    for k in range(0, a.shape[1], 8):
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            part = toward_zero(part.double() + x[:, k:k + 8].double() @ y[k:k + 8].double())
        if promote_k and (k + 8) % promote_k == 0:
            acc, part = acc + part, torch.zeros_like(part)
    return acc + part


def gemm_splitk(at: torch.Tensor, b: torch.Tensor, splits: int, passes: int) -> torch.Tensor:
    """The split-K form on Aᵀ storage at [K, M]: slabs of whole BK steps,
    each summed on its own, then summed in slab order."""
    K = at.shape[0]
    chunk = -(-(-(-K // splits)) // BK) * BK
    out = torch.zeros(at.shape[1], b.shape[1])
    for k0 in range(0, K, chunk):
        out = out + products(at[k0:k0 + chunk].t(), b[k0:k0 + chunk], passes)
    return out


def row_inputs(K, std, seed=0):
    rng = np.random.default_rng([seed, K, int(std)])
    a = (std * rng.standard_normal((ROWS, K))).astype(np.float32)
    w = (std * K ** -0.5 * rng.standard_normal((COLS, K))).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(w).t()


def within_rows(out, plain) -> bool:
    return torch.allclose(out, plain, atol=TOL, rtol=TOL)


@pytest.fixture(scope="module", params=[(K, std) for std in (1.0, 3.0) for K in K_OF_PATHS],
                ids=lambda p: f"K{p[0]}-std{p[1]:g}")
def row_case(request):
    K, std = request.param
    a, b = row_inputs(K, std)
    return a, b, a @ b


def test_split_reassembles_the_operand():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    # hi keeps 11 significant bits, lo the next 11: x − hi − lo is below
    # 2⁻²¹ of |x|
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all()
    assert torch.equal(tf32(torch.tensor([1 + 2 ** -11, -(1 + 3 * 2 ** -11)])),
                       torch.tensor([1 + 2 ** -10, -(1 + 2 * 2 ** -10)]))


def test_3xtf32_rows_within_the_limit(row_case):
    a, b, plain = row_case
    out = gemm_rows(a, b, 3)
    assert within_rows(out, plain), (out - plain).abs().max().item()


def test_1xtf32_rows_outside_the_limit(row_case):
    a, b, plain = row_case
    assert not within_rows(gemm_rows(a, b, 1), plain)


def test_promoted_sums_hold_the_limit(row_case):
    a, b, plain = row_case
    out = gemm_tensor_cores(a, b, PROMOTE_K)
    assert within_rows(out, plain), (out - plain).abs().max().item()


@pytest.mark.parametrize("K", [1536, 3072])
def test_one_truncating_accumulator_misses_the_limit(K):
    a, b = row_inputs(K, 3.0)
    assert not within_rows(gemm_tensor_cores(a, b), a @ b)


def test_weight_layout_does_not_change_the_products():
    # the staging writes both layouts of the weight (K-major: the forward's
    # w.t() view; N-major: a data gradient's dY·W) to the same K-major tiles
    a, b = row_inputs(384, 1.0, seed=2)
    assert torch.equal(gemm_rows(a, b, 3), gemm_rows(a, b.contiguous(), 3))


@pytest.fixture(scope="module", params=[(c, std) for std in (1.0, 3.0) for c in SPLITK],
                ids=lambda p: f"{p[0][0]}-std{p[1]:g}")
def splitk_case(request):
    (name, rows, (M, N)), std = request.param
    rng = np.random.default_rng([rows, int(std)])
    at = torch.from_numpy((std * rng.standard_normal((rows, SPLITK_COLS))).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((rows, SPLITK_COLS)).astype(np.float32))
    return at, dy, fl._splits(M, N, rows), at.t() @ dy


def test_splitk_slabs_are_the_trainers(splitk_case):
    at, _, splits, _ = splitk_case
    # many slabs, each of whole 16-deep steps and at least 512 rows
    chunk = -(-(-(-at.shape[0] // splits)) // BK) * BK
    assert splits > 1 and chunk % BK == 0 and chunk >= 512
    assert (splits - 1) * chunk < at.shape[0] <= splits * chunk


def test_3xtf32_splitk_within_the_limit(splitk_case):
    at, dy, splits, plain = splitk_case
    err = (gemm_splitk(at, dy, splits, 3) - plain).abs().max().item()
    scale = max(1.0, plain.abs().max().item())
    assert err <= BWD_TOL * scale
    assert err <= 2e-6 * scale


def test_1xtf32_splitk_far_above_f32_error(splitk_case):
    at, dy, splits, plain = splitk_case
    err = (gemm_splitk(at, dy, splits, 1) - plain).abs().max().item()
    assert err > 1e-4 * max(1.0, plain.abs().max().item())
