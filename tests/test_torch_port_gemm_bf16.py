"""The precision argument of the GEMM core's bf16 form (csrc/gemm_bf16_tma.cuh),
checked on the CPU.

The projections of B1 and B2 at the JAX package's default precision run on
wgmma with bf16 operands: each k16 step's sixteen products are exact in f32
(8-bit significands), and the tensor cores add them to the tile's f32 sums.
That addition truncates (the f32 form's TF32 sums showed it on the H100, and
its promotion every 64 k exists for it: tests/test_torch_port_gemm_tf32x3.py).
The bf16 form keeps one accumulator over each tile's whole K, since the card
check (chip_smoke.py phase 3bf) finds its sums within their limits without
the promotion.  Here torch emulates that accumulator, each k16 step added
with its f32 sum rounded toward zero, with and without a promotion every 64
k, and holds both to phase 3bf's limits against the f32 plain product of
the same bf16 operands:

- the row forms at ViT-S/16's K (384: qkv, the out projection, FF1; 1152:
  dln; 1536: FF2), a few dozen outputs, activations of std 1 and 3 against
  weights of std K^-½: the f32 sums (dln, dacc₀) within 1e-3·max(1,
  max|plain|), the bf16 outputs (rounded once) within 1.6e-2·max(1,
  max|plain|);
- the split-K weight gradients over the trainer's 25,216 rows in the slabs
  the kernel takes (``_splits``' count, each slab a whole number of 64-deep
  stages), each slab in one accumulator, the slabs summed in order: within
  1e-3·max(1, max|plain|).

One truncating accumulator over K costs at most ~3e-6 of max|plain| here,
two to three orders of magnitude inside the limits, and the promotion
brings it to the f32 plain product's own error: that is why the kernel
keeps one accumulator.
"""

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch.ops import fused_layer as fl
from torch_port_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1.6e-2   # chip_smoke.BF16_FWD_TOL: a bf16 output, × max(1, max|plain|)
F32_TOL = 1e-3     # phase 3bf's f32-out and split-K limit
KSTEP = 16         # k of one wgmma (m64nNk16)
STAGE_K = 64       # csrc/gemm_bf16_tma.cuh: the depth of a stage, the promotion's interval
K_OF_PATHS = (384, 1152, 1536)
ROWS, COLS = 40, 36
VIT_ROWS = 128 * 197
# the two weight gradients' [M, N], whose _splits gives the slabs
SPLITK = (("dwqkv", (384, 1152)), ("dwout", (384, 384)))
SPLITK_COLS = 24


def bf16(x: np.ndarray) -> torch.Tensor:
    """x as the bf16 values the kernel reads, held in f32."""
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float()


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 values rounded to f32 toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def tensor_core_sums(a: torch.Tensor, b: torch.Tensor, promote: bool) -> torch.Tensor:
    """a·b as one tile's accumulator takes it: each k16 step's products
    (exact) added to the f32 sum rounded toward zero; with ``promote`` the
    sum of each 64-deep stage added to the tile's sums (round to nearest)
    and restarted."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    part = torch.zeros_like(acc)
    for k in range(0, a.shape[1], KSTEP):
        part = toward_zero(part.double() + a[:, k:k + KSTEP].double() @ b[k:k + KSTEP].double())
        if promote and (k + KSTEP) % STAGE_K == 0:
            acc, part = acc + part, torch.zeros_like(part)
    return acc + part


def bf16_chunk(K: int, splits: int) -> int:
    """csrc/gemm_tc.cu gemm_bf16_splitk: the slabs' depth, whole stages."""
    return -(-(-(-K // splits)) // STAGE_K) * STAGE_K


def within(out, plain, tol) -> float:
    """max|out − plain| as a share of its limit tol·max(1, max|plain|)."""
    return (out - plain).abs().max().item() / (tol * max(1.0, plain.abs().max().item()))


@pytest.fixture(scope="module", params=[(K, std) for std in (1.0, 3.0) for K in K_OF_PATHS],
                ids=lambda p: f"K{p[0]}-std{p[1]:g}")
def row_case(request):
    K, std = request.param
    rng = np.random.default_rng([K, int(std)])
    a = bf16(std * rng.standard_normal((ROWS, K)))
    b = bf16(std * K ** -0.5 * rng.standard_normal((K, COLS)))
    return a, b, a @ b


@pytest.mark.parametrize("promote", [False, True], ids=["one_accumulator", "promoted"])
def test_f32_sums_within_the_limit(row_case, promote):
    a, b, plain = row_case
    share = within(tensor_core_sums(a, b, promote), plain, F32_TOL)
    # one accumulator: ~1e-3 of the limit; promoted: the plain product's own error
    assert share <= (0.01 if not promote else 1e-3), share


def test_bf16_outputs_within_the_limit(row_case):
    a, b, plain = row_case
    out = tensor_core_sums(a, b, promote=False).to(torch.bfloat16).float()
    assert within(out, plain, FWD_TOL) <= 0.5


def test_the_truncation_shows_and_the_promotion_removes_it():
    # the emulated accumulator is not the exact sum: at K = 1536 one
    # accumulator's error is several times the promoted sums'
    rng = np.random.default_rng(7)
    a = bf16(3 * rng.standard_normal((ROWS, 1536)))
    b = bf16(3 * 1536 ** -0.5 * rng.standard_normal((1536, COLS)))
    exact = a.double() @ b.double()
    one = (tensor_core_sums(a, b, False).double() - exact).abs().max().item()
    promoted = (tensor_core_sums(a, b, True).double() - exact).abs().max().item()
    assert one > 3 * promoted > 0


@pytest.fixture(scope="module", params=SPLITK, ids=lambda p: p[0])
def splitk_case(request):
    name, (M, N) = request.param
    rng = np.random.default_rng(len(name))
    at = bf16(rng.standard_normal((VIT_ROWS, SPLITK_COLS)))
    dy = bf16(rng.standard_normal((VIT_ROWS, SPLITK_COLS)))
    return at, dy, fl._splits(M, N, VIT_ROWS), at.t() @ dy


def test_splitk_slabs_are_whole_stages(splitk_case):
    at, _, splits, _ = splitk_case
    chunk = bf16_chunk(at.shape[0], splits)
    assert splits > 1 and chunk % STAGE_K == 0 and chunk >= 512
    assert (splits - 1) * chunk < at.shape[0] <= splits * chunk  # no empty slab


def test_splitk_within_the_limit(splitk_case):
    at, dy, splits, plain = splitk_case
    chunk = bf16_chunk(at.shape[0], splits)
    out = torch.zeros_like(plain)
    for k0 in range(0, at.shape[0], chunk):  # each slab one accumulator, summed in order
        out = out + tensor_core_sums(at[k0:k0 + chunk].t(), dy[k0:k0 + chunk], False)
    assert within(out, plain, F32_TOL) <= 0.01
