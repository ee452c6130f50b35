// Pieces shared by the port's CUDA sources: the row LayerNorm, the
// declarations of the GEMM core (csrc/gemm_tc.cu: 3xTF32 on wgmma, with its
// split-K form for weight gradients, and its bf16 form) and the fixed-order
// column sums.  The passes take float32 and, where the bf16 forms of B1 and
// B2 need them, bf16 activations (T below) with f32 statistics and sums;
// everything launches on the caller's stream; nothing here allocates.
//
// bf16 follows the JAX package's rounding points (vision_transformers_tpu/
// ops/fused_layer.py, fused_layer1.py at dtype bfloat16): each step's result
// is computed in f32 from its bf16 inputs and rounded to bf16 (to nearest
// even) once, where the Pallas kernel's .astype(bfloat16) rounds it; sums,
// statistics and gradients of f32 parameters stay f32.
//
// Every reduction over rows is two-pass and fixed-order (per-slab partial
// sums, then one ordered sum over the slabs), never float atomics, so a
// result is bit-identical from run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vtx {

using bf16 = __nv_bfloat16;

// The element types of the kernels' activations, as int template arguments
// (so ptxas's and cuobjdump's names of the instantiations stay readable):
// F32, or BF16 with f32 accumulation
constexpr int F32 = 0, BF16 = 1;
template <int E>
struct Elt {
  using T = float;
};
template <>
struct Elt<BF16> {
  using T = bf16;
};

// an element as f32, and f32 stored as an element (bf16: rounded to nearest
// even); rnd: the value an element of type T would hold
__device__ __forceinline__ float get(const float* p) { return *p; }
__device__ __forceinline__ float get(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}
// two f32 as a bf16 pair (lo in the low half: the element at the lower address)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// a bf16 pair's elements as f32
__device__ __forceinline__ float lo_f32(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f32(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// T in a parameter that deduces nothing (its type comes from elsewhere)
template <typename T>
struct Id {
  using type = T;
};

// B9's map addressing (fused_swin.cu): row r of the sample-major window-pair
// rows lives at map pixel (r / hw)·hw + pix[r % hw], pix [hw] the table of
// ops/fused_swin.py::map_rows (hw = H·W, the rows of one sample).  The
// kernels below that take a MAP template parameter read (or write) the map
// through it; their MAP = false instantiations ignore it.
struct MapRows {
  const int* pix;
  int hw;
};

__device__ __forceinline__ long long map_pixel(const MapRows& mr, int r) {
  return (long long)(r / mr.hw) * mr.hw + mr.pix[r % mr.hw];
}

// ---------------------------------------------------------------------------
// GEMM (csrc/gemm_tc.cu, one copy for every source): out[M, N] =
// epilogue(A[M, K] · B[K, N]), row-major out, products in 3xTF32 on the
// tensor cores, in three forms:
//   launch_gemm         A row-major [M, K]; epilogue + bias[n] → silu →
//                       × rs[m / rs_rows] → + res[m, n], each optional
//   launch_gemm_map     the same, B9's: MAP_RES reads the residual row m at
//                       map pixel map_pixel(rows_map, m), MAP_OUT writes the
//                       output row there
//   launch_gemm_splitk  A given as Aᵀ storage (element (m, k) at
//                       A[m + k·lda]: accᵀ, uᵀ) for the weight gradients
//                       over K = B·N rows, as `splits` K-slabs written to
//                       `part` ([splits, M, N], no epilogue) and summed in
//                       order into out (element (m, n) at out[m*som + n*son])
//   B element (k, n) at B[k*sbk + n*sbn] in all three, so transposed weight
//   views (torch's Linear.weight.t()) are read in place.
// launch_gemm_x and launch_gemm_splitk_x take GemmExtra besides: operand
// transforms that the producer applies in registers as it stages a tile
// (before the TF32 split), so a LayerNorm's output, an activation or a row
// scale is never written to device memory, and epilogue options that take a
// pass's work into the output tile.
// ---------------------------------------------------------------------------

constexpr int MAP_NONE = 0, MAP_RES = 1, MAP_OUT = 2;

// The FF activations of vision_transformers_tpu/ops/fused_layer.py:90-108
// (ACT_NONE: none)
constexpr int ACT_NONE = -1, ACT_SILU = 0, ACT_GELU = 1;

// Column groups of the epilogue's row partials (rpart is [M, cdiv(N, 64)]),
// rows of its column partials' slices (cpart is [cdiv(M, 16), N]), and the
// rows a block of the row-scale gradient's pass sums (launch_drs)
constexpr int RPART_COLS = 64, CPART_ROWS = 16, DRS_ROWS = 64;

struct GemmExtra {
  // A (the producer): the LayerNorm apply (a − ln_mu[t])·ln_rstd[t]·ln_g[f]
  // + ln_b[f] from saved statistics, t the token (A's row; in the split-K
  // form its k) and f the feature (its k; in the split-K form its row); or,
  // without ln_mu, act_fwd<a_act>(a)
  const float* ln_mu = nullptr;
  const float* ln_rstd = nullptr;
  const float* ln_g = nullptr;
  const float* ln_b = nullptr;
  int a_act = ACT_NONE;
  // B (the producer): × b_rs[k / b_rs_rows]
  const float* b_rs = nullptr;
  int b_rs_rows = 1;
  // the epilogue (launch_gemm_x): with hid [M, N] (row stride N), after the
  // bias and silu, rpart [M, cdiv(N, 64)] (when non-null) takes Σ v·
  // act_fwd<hid_act>(hid) over each row's 64-column groups, then v ×= rs,
  // v ×= act_grad<hid_act>(hid); cpart [cdiv(M, 16), N] (when non-null)
  // takes the column sums of the final value over each 16-row slice (a
  // thread's two rows, then the eight lanes' as a shuffle tree)
  const float* hid = nullptr;
  int hid_act = ACT_SILU;
  float* rpart = nullptr;
  float* cpart = nullptr;
};

cudaError_t launch_gemm(const float* A, const float* B, long long sbk, long long sbn,
                        const float* bias, const float* rs, int rs_rows, const float* res,
                        float* out, int M, int N, int K, int silu, cudaStream_t stream);

cudaError_t launch_gemm_x(const float* A, const float* B, long long sbk, long long sbn,
                          const float* bias, const float* rs, int rs_rows, const float* res,
                          float* out, int M, int N, int K, int silu, const GemmExtra& x,
                          cudaStream_t stream);

template <int MAP>
cudaError_t launch_gemm_map(const float* A, const float* B, long long sbk, long long sbn,
                            const float* bias, const float* rs, int rs_rows,
                            const float* res, float* out, int M, int N, int K, int silu,
                            MapRows rows_map, cudaStream_t stream);

cudaError_t launch_gemm_splitk(const float* A, int lda, const float* B, long long sbk,
                               long long sbn, float* part, int splits, float* out,
                               long long som, long long son, int M, int N, int K,
                               cudaStream_t stream);

// the producer's transforms only (no epilogue in this form)
cudaError_t launch_gemm_splitk_x(const float* A, int lda, const float* B, long long sbk,
                                 long long sbn, float* part, int splits, float* out,
                                 long long som, long long son, int M, int N, int K,
                                 const GemmExtra& x, cudaStream_t stream);

// The bf16 form (gemm_tc.cu): A, B, bias and res bf16, wgmma k16 products
// into f32 sums; by TMA (gemm_bf16_tma.cuh) wherever it can describe the
// operands and the output, else on the register path.  The row form
// writes out bf16 at the JAX kernels' rounding points, round(round(round(acc)
// + bias)·round(rs)) + res rounded (silu after the bias, rounded, where
// set), or with out_f32 the sums as f32 (no epilogue); the split-K form
// writes the f32 partials and their ordered f32 sum.
cudaError_t launch_gemm_bf16(const bf16* A, const bf16* B, long long sbk, long long sbn,
                             const bf16* bias, const float* rs, int rs_rows, const bf16* res,
                             void* out, int out_f32, int M, int N, int K, int silu,
                             cudaStream_t stream);

cudaError_t launch_gemm_splitk_bf16(const bf16* A, int lda, const bf16* B, long long sbk,
                                    long long sbn, float* part, int splits, float* out,
                                    long long som, long long son, int M, int N, int K,
                                    cudaStream_t stream);

// The bf16 form's TMA path: A [M, K] row-major, or (the split-K form) its
// transpose's storage [K, M]; B [N, K] (K-major) or [K, N] (MN-major), rows
// ldb apart; out [splits, M, N] f32 (the partials, or with one slab the
// sums) or [M, N] bf16 through the epilogue; slab z takes k in [z·k_chunk,
// (z + 1)·k_chunk), k_chunk a multiple of 64
struct TmaGemm {
  const bf16* a;
  long long lda;
  const bf16* b;
  long long ldb;
  const bf16* bias;
  const float* rs;
  int rs_rows;
  const bf16* res;
  void* out;
  int splits, M, N, K, k_chunk, silu;
};

// The thin door's choice, 0 for the rule's: promote 1 every 64 k, 2 one
// accumulator over K.  plan, where not null, gets what ran: {1 TMA or 0 the
// register path, the tile's columns, promote, the ring's stages}.
struct Bf16Opts {
  int promote;
  int* plan;
};

// TA: A as its transpose's storage; TB: B MN-major; F32OUT: f32 out.
// Instantiated in gemm_bf16_fwd.cu (TA 0, TB 0), gemm_bf16_dgrad.cu (TA
// 0, TB 1) and gemm_bf16_splitk.cu (TA 1)
template <int TA, int TB, int F32OUT>
cudaError_t gemm_bf16_tma(const TmaGemm& g, const Bf16Opts& o, cudaStream_t stream);

}  // namespace vtx

using vtx::GemmExtra;
using vtx::bf16;
using vtx::BF16;
using vtx::F32;
using vtx::Elt;
using vtx::Id;
using vtx::get;
using vtx::put;
using vtx::rnd;
using vtx::pack_bf16;
using vtx::lo_f32;
using vtx::hi_f32;
using vtx::launch_gemm_bf16;
using vtx::launch_gemm_splitk_bf16;
using vtx::MapRows;
using vtx::map_pixel;
using vtx::ACT_NONE;
using vtx::ACT_SILU;
using vtx::ACT_GELU;
using vtx::RPART_COLS;
using vtx::DRS_ROWS;
using vtx::CPART_ROWS;
using vtx::MAP_NONE;
using vtx::MAP_RES;
using vtx::MAP_OUT;
using vtx::launch_gemm;
using vtx::launch_gemm_map;
using vtx::launch_gemm_splitk;
using vtx::launch_gemm_splitk_x;
using vtx::launch_gemm_x;

// internal linkage: each .cu that includes this gets its own copy
namespace {

// largest attention head width: the tensor-core attention core
// (attention_tc.cuh) stages a head 32 or 64 floats wide, with or without an
// additive bias; the window attention (window_attention_tc.cuh), which takes
// the bias calls of B1 and B2 over windows of up to 128 tokens and of B9,
// heads up to EXTRA_DMAX wide
constexpr int DMAX = 64;
constexpr int EXTRA_DMAX = 32;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The GEMM core's output tiles along N (128 columns, or 64 where that pads
// N less) and along M (128 rows).  A transform the producer stages is
// redone for every tile its operand's tile meets, so the backward stages
// one only where that is at most STAGE_TILES times (STAGE_ACT_TILES for an
// activation, whose exponential costs more), and otherwise runs the pass
// into free workspace (PERF.md: at Halo-S stage 1 the staged transforms
// cost less than the passes, at the later stages more)
constexpr int STAGE_TILES = 5, STAGE_ACT_TILES = 1;
inline int gemm_col_tiles(int N) {
  return cdiv(N, cdiv(N, 64) * 64 < cdiv(N, 128) * 128 ? 64 : 128);
}
inline int gemm_row_tiles(int M) { return cdiv(M, 128); }
inline long long cdivll(long long a, long long b) { return (a + b - 1) / b; }

#define VTX_CHECK(expr)                   \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

// ---------------------------------------------------------------------------
// LayerNorm over rows of [rows, C]: one warp per row.  Statistics in f32 in
// the fast-variance form E[x²]−μ² (vision_transformers_tpu/ops/
// fused_layer.py:69-76).  mu / rstd [rows] are written when non-null (the
// training forward saves them for the backward).  MAP: row r of x is map
// pixel map_pixel(rows_map, r) (u and the statistics stay in row order).
// ---------------------------------------------------------------------------

constexpr int LN_THREADS = 256;

// a warp's row statistics (every lane gets them): mu, rstd = rsqrt(var + eps)
template <typename T>
__device__ __forceinline__ void ln_row_stats(const T* xr, int C, float eps, float& mu,
                                             float& r) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = get(xr + c);
    s += v;
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  mu = s / C;
  const float var = ss / C - mu * mu;
  r = rsqrtf(var + eps);
}

// (T = bf16: x read as bf16, u rounded to bf16, the statistics f32)
template <bool MAP, typename T = float>
__global__ void __launch_bounds__(LN_THREADS)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ b, T* __restrict__ u,
               float* __restrict__ mu_out, float* __restrict__ rstd_out,
               int rows, int C, float eps, MapRows rows_map) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const T* xr = x + (MAP ? map_pixel(rows_map, row) : (long long)row) * C;
  float mu, r;
  ln_row_stats(xr, C, eps, mu, r);
  if (lane == 0 && mu_out) {
    mu_out[row] = mu;
    rstd_out[row] = r;
  }
  T* ur = u + (long long)row * C;
  for (int c = lane; c < C; c += 32) put(ur + c, (get(xr + c) - mu) * r * g[c] + b[c]);
}

// The statistics alone (mu, rstd [rows]), the same values as
// ln_rows_kernel's: the GEMM core's producer applies the LayerNorm from
// them (GemmExtra::ln_*), so its output is never written
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mu_out,
                float* __restrict__ rstd_out, int rows, int C, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // uniform across the warp
  float mu, r;
  ln_row_stats(x + (long long)row * C, C, eps, mu, r);
  if ((threadIdx.x & 31) == 0) {
    mu_out[row] = mu;
    rstd_out[row] = r;
  }
}

template <typename T>
inline cudaError_t launch_ln_stats(const T* x, float* mu, float* rstd, int rows, int C,
                                   float eps, cudaStream_t stream) {
  ln_stats_kernel<T><<<cdiv(rows, LN_THREADS / 32), LN_THREADS, 0, stream>>>(x, mu, rstd, rows,
                                                                           C, eps);
  return cudaGetLastError();
}

template <typename T>
inline cudaError_t launch_ln(const T* x, const float* g, const float* b,
                             T* u, float* mu, float* rstd, int rows, int C,
                             float eps, cudaStream_t stream) {
  ln_rows_kernel<false, T><<<cdiv(rows, LN_THREADS / 32), LN_THREADS, 0, stream>>>(
      x, g, b, u, mu, rstd, rows, C, eps, MapRows{nullptr, 1});
  return cudaGetLastError();
}

// the same with x read through the map addressing
inline cudaError_t launch_ln_map(const float* x, const float* g, const float* b,
                                 float* u, float* mu, float* rstd, int rows, int C,
                                 float eps, MapRows rows_map, cudaStream_t stream) {
  ln_rows_kernel<true><<<cdiv(rows, LN_THREADS / 32), LN_THREADS, 0, stream>>>(
      x, g, b, u, mu, rstd, rows, C, eps, rows_map);
  return cudaGetLastError();
}

constexpr int REDUCE_THREADS = 256;

// out[m*som + n*son] = Σ_{z < S} part[z, m, n], summed in z order (O =
// bf16: the f32 sum rounded once)
template <typename O>
__global__ void __launch_bounds__(REDUCE_THREADS)
splitk_reduce_kernel(const float* __restrict__ part, int S, int M, int N,
                     O* __restrict__ out, long long som, long long son) {
  const long long idx = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const long long MN = (long long)M * N;
  if (idx >= MN) return;
  float s = 0.f;
  for (int z = 0; z < S; ++z) s += part[z * MN + idx];
  const long long m = idx / N, n = idx % N;
  put(out + m * som + n * son, s);
}

template <typename O>
inline cudaError_t launch_splitk_reduce(const float* part, int S, int M, int N,
                                        O* out, long long som, long long son,
                                        cudaStream_t stream) {
  const long long blocks = cdivll((long long)M * N, REDUCE_THREADS);
  splitk_reduce_kernel<<<(unsigned)blocks, REDUCE_THREADS, 0, stream>>>(
      part, S, M, N, out, som, son);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Column sums over rows of [M, C]:
//   out[c] = Σ_m A[m, c]                                   (X == nullptr)
//   out[c] = Σ_m A[m, c] · rs[m / rs_rows]                 (rs: a row scale)
//   out[c] = Σ_m A[m, c] · (X[m, c] − mu[m]) · rstd[m]     (the LN's x̂)
// Pass 1: block (column tile, row chunk z) writes part[z, c]; pass 2 sums
// the chunks in order.  MAP: row r of X is map pixel map_pixel(rows_map, r).
// ---------------------------------------------------------------------------

constexpr int COLSUM_THREADS = 128;
constexpr int COLSUM_ROWS = 128;  // rows per chunk (the GEMM epilogue's tile)

inline int colsum_chunks(int M) { return cdiv(M, COLSUM_ROWS); }

template <bool MAP, typename TA, typename TX>
__global__ void __launch_bounds__(COLSUM_THREADS)
colsum_kernel(const TA* __restrict__ A, const TX* __restrict__ X,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const float* __restrict__ rs, int rs_rows,
              float* __restrict__ part, int M, int C, MapRows rows_map) {
  const int c = blockIdx.x * COLSUM_THREADS + threadIdx.x;
  if (c >= C) return;
  const int r0 = blockIdx.y * COLSUM_ROWS, r1 = min(M, r0 + COLSUM_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) {
    const long long i = (long long)r * C + c;
    const long long xi = MAP ? map_pixel(rows_map, r) * C + c : i;
    // the scaled value rounded once, as a scaled f32 copy would hold it
    const float a = get(A + i);
    s += X ? a * ((get(X + xi) - mu[r]) * rstd[r]) : rs ? __fmul_rn(a, rs[r / rs_rows]) : a;
  }
  part[(long long)blockIdx.y * C + c] = s;
}

// part: scratch of colsum_chunks(M) * C floats; with rows_map.pix non-null,
// X is read through the map addressing; rs (per rs_rows rows) only without X
// and with f32 A.  A and X are f32 or bf16 (TX named where X is bf16); the
// sums f32
template <typename TA, typename TX = float>
inline cudaError_t launch_colsum(const TA* A, const typename Id<TX>::type* X, const float* mu,
                                 const float* rstd, float* part, float* out,
                                 int M, int C, cudaStream_t stream,
                                 MapRows rows_map = MapRows{nullptr, 1},
                                 const float* rs = nullptr, int rs_rows = 1) {
  const int chunks = colsum_chunks(M);
  if (chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(cdiv(C, COLSUM_THREADS), chunks);
  if (rows_map.pix)
    colsum_kernel<true, TA, TX><<<grid, COLSUM_THREADS, 0, stream>>>(A, X, mu, rstd, rs,
                                                                    rs_rows, part, M, C,
                                                                    rows_map);
  else
    colsum_kernel<false, TA, TX><<<grid, COLSUM_THREADS, 0, stream>>>(A, X, mu, rstd, rs,
                                                                     rs_rows, part, M, C,
                                                                     rows_map);
  VTX_CHECK(cudaGetLastError());
  return launch_splitk_reduce(part, chunks, 1, C, out, 0, 1, stream);
}

// ---------------------------------------------------------------------------
// Elementwise and row pieces of the backward passes
// ---------------------------------------------------------------------------

constexpr int EW_THREADS = 256;

inline unsigned ew_blocks(long long total) {
  return (unsigned)cdivll(total, EW_THREADS);
}

// dst = rs[row / rows_per_scale] · src over rows of width C (bf16: the
// scale rounded first and the product rounded, as the JAX kernels' da)
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
scale_rows_kernel(const T* __restrict__ src, const float* __restrict__ rs,
                  int rows_per_scale, int C, long long total,
                  T* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= total) return;
  put(dst + i, get(src + i) * rnd<T>(rs[(i / C) / rows_per_scale]));
}

// Per sample b (one block) of a residual branch y = rs[b] ⊙ (a·W + bias):
// given dacc₀ = dy·Wᵀ [N·HD per sample, f32] and the branch input a,
//   drs[b] = Σ_{rows of b} (dacc₀·a + dy·bias)   (when drs is non-null)
//   dacc   = rs[b] · dacc₀                         (f32: in place, dacc =
//                                                   dacc0; bf16: rounded)
constexpr int DRS_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(DRS_THREADS)
row_scale_grad_kernel(const float* dacc0, T* dacc, const T* __restrict__ acc,
                      const T* __restrict__ dz, const T* __restrict__ bout,
                      const float* __restrict__ rs, float* __restrict__ drs,
                      int N, int HD, int C) {
  __shared__ float red[DRS_THREADS];
  const int b = blockIdx.x, t = threadIdx.x;
  const float r = rs[b];
  const long long a0 = (long long)b * N * HD;
  float s = 0.f;
  for (long long i = t; i < (long long)N * HD; i += DRS_THREADS) {
    const float d0 = dacc0[a0 + i];
    s = fmaf(d0, get(acc + a0 + i), s);
    put(dacc + a0 + i, d0 * r);
  }
  if (drs) {
    if (bout) {
      const long long z0 = (long long)b * N * C;
      for (long long i = t; i < (long long)N * C; i += DRS_THREADS)
        s = fmaf(get(dz + z0 + i), get(bout + i % C), s);
    }
    red[t] = s;
    __syncthreads();
    for (int o = DRS_THREADS / 2; o > 0; o >>= 1) {
      if (t < o) red[t] += red[t + o];
      __syncthreads();
    }
    if (t == 0) drs[b] = red[0];
  }
}

// The row-scale gradient from the GEMM epilogue's row partials (GemmExtra::
// rpart) of a residual branch y = rs[b] ⊙ (a·W + bias):
//   drs[b] = Σ_{rows of b} (Σ_t rpart[row, t] + Σ_c dy[row, c]·bias[c])
// Block (chunk z, sample b) sums DRS_ROWS rows in a fixed order into
// dpart[z, b] (rpart's T partials of each row, then dy·bias when bias is
// non-null); then the chunks in order.

inline int drs_chunks(int rows_per_scale) { return cdiv(rows_per_scale, DRS_ROWS); }

__global__ void __launch_bounds__(DRS_THREADS)
drs_part_kernel(const float* __restrict__ rpart, int T, const float* __restrict__ dy,
                const float* __restrict__ bias, int C, int rows_per_scale,
                float* __restrict__ dpart) {
  __shared__ float red[DRS_THREADS];
  const int z = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const long long r0 = (long long)b * rows_per_scale + (long long)z * DRS_ROWS;
  const int rows = min(DRS_ROWS, rows_per_scale - z * DRS_ROWS);
  float s = 0.f;
  for (int i = t; i < rows * T; i += DRS_THREADS) s += rpart[r0 * T + i];
  if (bias)
    for (int i = t; i < rows * C; i += DRS_THREADS) s = fmaf(dy[r0 * C + i], bias[i % C], s);
  red[t] = s;
  __syncthreads();
  for (int o = DRS_THREADS / 2; o > 0; o >>= 1) {
    if (t < o) red[t] += red[t + o];
    __syncthreads();
  }
  if (t == 0) dpart[(long long)z * gridDim.y + b] = red[0];
}

// dpart: scratch of drs_chunks(rows_per_scale)·B floats
inline cudaError_t launch_drs(const float* rpart, int N, const float* dy, const float* bias,
                              int C, int rows_per_scale, int B, float* dpart, float* drs,
                              cudaStream_t stream) {
  const int chunks = drs_chunks(rows_per_scale);
  if (B > 65535) return cudaErrorInvalidValue;
  drs_part_kernel<<<dim3(chunks, B), DRS_THREADS, 0, stream>>>(
      rpart, cdiv(N, RPART_COLS), dy, bias, C, rows_per_scale, dpart);
  VTX_CHECK(cudaGetLastError());
  return launch_splitk_reduce(dpart, chunks, 1, B, drs, 0, 1, stream);
}

// u = (x − mu)·rstd·g + b, a forward LayerNorm's output from its saved
// statistics (the same expression as ln_rows_kernel, so bit-identical);
// MAP: row r of x is map pixel map_pixel(rows_map, r)
template <bool MAP, typename T = float>
__global__ void __launch_bounds__(EW_THREADS)
ln_apply_kernel(const T* __restrict__ x, const float* __restrict__ mu,
                const float* __restrict__ rstd, const float* __restrict__ g,
                const float* __restrict__ b, T* __restrict__ u, int C,
                long long total, MapRows rows_map) {
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= total) return;
  const long long r = i / C;
  const int c = i % C;
  const long long xi = MAP ? map_pixel(rows_map, (int)r) * C + c : i;
  put(u + i, (get(x + xi) - mu[r]) * rstd[r] * g[c] + b[c]);
}

// LayerNorm backward, one warp per row (fused_layer.py:79-87):
//   dx = dz + rstd·(dx̂ − mean(dx̂) − x̂·mean(dx̂⊙x̂)),  dx̂ = dln ⊙ g
// MAP: row r of x and of dx is map pixel map_pixel(rows_map, r) (dln, dz
// and the statistics stay in row order).  T = bf16: x, dz and dx bf16, the
// LN's part rounded before the residual's add (dz + dx_ln.astype(bf16)),
// dln f32
template <bool MAP, typename T = float>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_rows_kernel(const float* __restrict__ dln, const T* __restrict__ x,
                   const float* __restrict__ mu, const float* __restrict__ rstd,
                   const float* __restrict__ g, const T* __restrict__ dz,
                   T* __restrict__ dx, int rows, int C, MapRows rows_map) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const long long off = (long long)row * C;
  const long long xoff = MAP ? map_pixel(rows_map, row) * C : off;
  const float m = mu[row], r = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dxh = dln[off + c] * g[c];
    const float xh = (get(x + xoff + c) - m) * r;
    s1 += dxh;
    s2 = fmaf(dxh, xh, s2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float m1 = s1 / C, m2 = s2 / C;
  for (int c = lane; c < C; c += 32) {
    const float dxh = dln[off + c] * g[c];
    const float xh = (get(x + xoff + c) - m) * r;
    put(dx + xoff + c, get(dz + off + c) + rnd<T>(r * (dxh - m1 - xh * m2)));
  }
}

// The FF activations (ACT_SILU, ACT_GELU above): silu(h) = h·σ(h) in one
// expression for the GEMM core's producer and epilogue and every pass (so
// bit-identical), and gelu's tanh approximation (jax.nn.gelu's default).
// σ(h) = 1 / (1 + e^-h) by the fast reciprocal (2 ulp, no branch: the IEEE
// division's slow-path check serialized the GEMM core's per-element work);
// a huge 1 + e^-h (h below -87) gives σ = 0, as it should.
constexpr float GELU_C = 0.7978845608028654f;  // √(2/π)

__device__ __forceinline__ float sigmoid(float h) { return __fdividef(1.f, 1.f + expf(-h)); }

template <int ACT>
__device__ __forceinline__ float act_fwd(float h) {
  if (ACT == ACT_SILU) return h * sigmoid(h);
  return 0.5f * h * (1.f + tanhf(GELU_C * (h + 0.044715f * h * h * h)));
}

// d act / d h at h (fused_layer.py:98-108)
template <int ACT>
__device__ __forceinline__ float act_grad(float h) {
  if (ACT == ACT_SILU) {
    const float s = sigmoid(h);
    return s + h * s * (1.f - s);
  }
  const float t = tanhf(GELU_C * (h + 0.044715f * h * h * h));
  const float dt = (1.f - t * t) * GELU_C * (1.f + 3.f * 0.044715f * h * h);
  return 0.5f * (1.f + t) + 0.5f * h * dt;
}

// out = act(h), elementwise (in place allowed)
template <int ACT>
__global__ void __launch_bounds__(EW_THREADS)
act_kernel(const float* h, float* out, long long total) {
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= total) return;
  out[i] = act_fwd<ACT>(h[i]);
}

}  // namespace

// Host-side launch sequences shared between the sources; rows_per_scale is
// the number of rows that one per-sample row scale covers (N tokens of a
// sample).
namespace vtx {

// The FF residual branch of a pre-LN layer (fused_layer.cu), act = ACT_SILU
// or ACT_GELU:
//   out = z + rs_ff ⊙ (act(LN₂(z)·W₁ + b₁)·W₂ + b₂)
// The statistics pass writes mu2 / rstd2 (never null: the saves in
// training, workspace in serving); the FF1 GEMM's producer applies LN₂ from
// them and the FF2 GEMM's producer applies act to hid, so neither LN₂(z)
// nor act(hid) is written (each where its operand's tiles meet few output
// tiles, else a pass: LN₂(z) into out, act(hid) into af where given).
// Training (save): hid keeps the pre-activation.  Serving with silu: silu
// rides in FF1's epilogue.  b₁, b₂, rs_ff and af may be null.
cudaError_t ff_half_fwd(
    const float* z, const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs_ff, int rows_per_scale, float* hid, float* af, float* mu2,
    float* rstd2, float* out, int M, int C, int F, float eps, int act, int save,
    cudaStream_t s);

// rpart's floats in ff_half_bwd: the dh GEMM's row partials [M, cdiv(F,
// 64)], the drs pass's chunk sums [cdiv(rows_per_scale, 64), B], then the
// dh GEMM's column partials [cdiv(M, 16), F]
inline long long ff_rpart_floats(int M, int F, int B, int rows_per_scale) {
  return (long long)M * ((F + RPART_COLS - 1) / RPART_COLS) +
         (long long)B * ((rows_per_scale + DRS_ROWS - 1) / DRS_ROWS) +
         (long long)((M + CPART_ROWS - 1) / CPART_ROWS) * F;
}

// The FF half's backward, steps 1-4 of fused_layer1_bwd.cu: given dout, the
// gradients of W₁, b₁, W₂, b₂, LN₂ and r₂, and dz = dout + LN₂ᵀ(dln₂).
// Workspace: dh [M, F], dln [M, C], rpart [ff_rpart_floats] (used with rs_ff
// and drs_ff, or db1f), wpart, cpart.
cudaError_t ff_half_bwd(
    const float* z, const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs_ff, int rows_per_scale, const float* hid, const float* mu2,
    const float* rstd2, const float* dout, float* dh, float* dln, float* rpart,
    float* wpart, int splits_w1, int splits_w2,
    float* cpart, float* dz, float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f, float* drs_ff,
    int B, int M, int C, int F, int act, cudaStream_t s);

// Steps 1-2 of the attention branch's backward (fused_layer_bwd.cu): dwout =
// accᵀ·(rs ⊙ dz) (the scale applied as the GEMM stages dz), dbout, dacc =
// rs ⊙ dz·woutᵀ and dr.
cudaError_t out_proj_bwd(
    const float* acc, const float* wout, long long wout_s0, long long wout_s1,
    const float* bout, const float* rs, int rows_per_scale, const float* dz,
    float* dacc, float* wpart, int splits_out, float* cpart,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, int B, int M, int C, int HD, cudaStream_t s);

// Steps 4-5 on the qkv projection's input a [M, C] (fused_layer_bwd.cu):
// dwqkv = xa(a)ᵀ·dqkv (split-K slabs summed in order; xa the producer's
// transform of a, e.g. the LayerNorm apply), dbqkv = Σ_rows dqkv (when
// non-null), da = dqkv·wqkvᵀ; B8's backward (fused_attention_qkv.cu) ends
// with it
cudaError_t qkv_in_bwd(const float* a, const GemmExtra& xa, const float* wqkv,
                       long long wqkv_s0, long long wqkv_s1, const float* dqkv, float* wpart,
                       int splits_qkv, float* cpart, float* dwqkv, long long dwqkv_s0,
                       long long dwqkv_s1, float* dbqkv, float* da, int M, int C, int HD,
                       cudaStream_t s);

// Steps 4-6 of the attention branch's backward: dwqkv = LN(x)ᵀ·dqkv with the
// LayerNorm applied from the saved statistics as the GEMM stages x, dbqkv,
// dln = dqkv·wqkvᵀ and the LN backward dx = dz + LNᵀ(dln) with dg, db.
cudaError_t qkv_proj_bwd(
    const float* x, const float* ln_g, const float* ln_b, const float* mu,
    const float* rstd, const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* dqkv, const float* dz, float* dln, float* wpart,
    int splits_qkv, float* cpart, float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv, int M,
    int C, int HD, cudaStream_t s);

// Backward of the attention residual branch (fused_layer_bwd.cu), shared by
// the attention layer's backward and the whole layer's (fused_layer1_bwd.cu).
// extra / dextra / dbpart may be null, and so may dq_part where N ≤ 64 or
// where the bias takes the window attention; see fused_layer_bwd.cu.
cudaError_t attention_half_bwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* rs, const float* extra, int groups, const float* qkv,
    const float* acc, const float* mu, const float* rstd, const float* lse,
    const float* dz, float* dacc, float* dq_part, float* dqkv,
    float* dln, float* dbpart, float* wpart, int splits_out, int splits_qkv,
    float* cpart, float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, float* dextra, int B, int N, int C, int H, int D, float scale,
    cudaStream_t s);

// The packed-row attention on the tensor cores (attention_tc.cuh, compiled
// into fused_attention_qkv.cu alone): qkv [B, N, 3·H·D] (q-heads | k-heads
// | v-heads), extra the grouped bias [G, H, N, N] (row b in group b / (B /
// G)) or null, heads up to 64 wide, any N.  The forward writes out [B, N,
// H·D] and, when non-null, lse [B, H, N]: B3, B8 and the bias-free
// attention of B1 and B2 (fused_layer.cu) ...
cudaError_t packed_attention_fwd(const float* qkv, const float* extra, int groups,
                                 float* out, float* lse, int B, int N, int H, int D,
                                 float scale, cudaStream_t s);

// ... and the backward, on the forward's out and lse and dout [B, N, H·D],
// writes dqkv in the layout of qkv: Δ in its prologue, one pass of key-tile
// blocks, dq through the partials dq_part [ceil(N / 64), B·N, H·D] (null
// where N ≤ 64) summed in key-tile order; with a non-null dextra, dS into
// dsbuf [B, H, N, N] and its ordered sum over each group's rows into dextra
// (fused_layer_bwd.cu)
cudaError_t packed_attention_bwd(const float* qkv, const float* extra, int groups,
                                 const float* out, const float* lse, const float* dout,
                                 float* dq_part, float* dsbuf, float* dqkv, float* dextra,
                                 int B, int N, int H, int D, float scale, cudaStream_t s);

// The bf16 form of the packed-row attention (attention_bf16_tma.cuh,
// compiled into attention_bf16.cu: wgmma fed by TMA), bias-free, D a
// multiple of 8 up to 64, any N: the forward writes out [B, N, H·D] bf16
// and lse [B, H, N] f32 when non-null; the backward writes dqkv bf16, dq
// summed over the key tiles in shared memory (N ≤ 256) or through f32
// key-tile partials summed in order, rounded once either way; ws is its
// workspace of packed_attention_bwd_bf16_floats floats (never null)
cudaError_t packed_attention_fwd_bf16(const bf16* qkv, bf16* out, float* lse, int B, int N,
                                      int H, int D, float scale, cudaStream_t s);

cudaError_t packed_attention_bwd_bf16(const bf16* qkv, const bf16* out, const float* lse,
                                      const bf16* dout, float* ws, bf16* dqkv, int B,
                                      int N, int H, int D, float scale, cudaStream_t s);

long long packed_attention_bwd_bf16_floats(int B, int N, int H, int D);

// B9's attention over sample-major window pairs (fused_swin.cu): qkv
// [P·N, 3·H·D] of P = B·G pairs, pair p taking the bias extra[p mod
// groups] [H, N, N] (groups = G, or 1 for one slab), heads up to 32 wide;
// the forward writes out [P·N, H·D] and, when non-null, lse [P, H, N]
// (fused_layer.cu) ...
cudaError_t window_attention_fwd(const float* qkv, const float* extra, int groups,
                                 float* out, float* lse, int P, int N, int H, int D,
                                 float scale, cudaStream_t s);

// ... and the backward writes dqkv and, when dextra is non-null, the
// per-block dS sums into dbpart [wta::bwd_chunks(P, groups, H), groups, H,
// N, N] and dextra[g] = their sum in chunk order, the windows of a chunk in
// sample order (fused_layer_bwd.cu); both on the tensor-core window
// attention (window_attention_tc.cuh), N ≤ 128
cudaError_t window_attention_bwd(const float* qkv, const float* dacc, const float* acc,
                                 const float* lse, const float* extra, int groups,
                                 float* dbpart, float* dqkv, float* dextra, int P, int N,
                                 int H, int D, float scale, cudaStream_t s);
}  // namespace vtx
