// Pieces shared by the port's CUDA sources: the row LayerNorm, the
// declarations of the GEMM core (csrc/gemm_tc.cu: 3xTF32 on wgmma, with its
// split-K form for weight gradients) and the fixed-order column sums.
// Everything is float32 and launches on the caller's stream; nothing here
// allocates.
//
// Every reduction over rows is two-pass and fixed-order (per-slab partial
// sums, then one ordered sum over the slabs), never float atomics, so a
// result is bit-identical from run to run.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace vtx {

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
// ---------------------------------------------------------------------------

constexpr int MAP_NONE = 0, MAP_RES = 1, MAP_OUT = 2;

cudaError_t launch_gemm(const float* A, const float* B, long long sbk, long long sbn,
                        const float* bias, const float* rs, int rs_rows, const float* res,
                        float* out, int M, int N, int K, int silu, cudaStream_t stream);

template <int MAP>
cudaError_t launch_gemm_map(const float* A, const float* B, long long sbk, long long sbn,
                            const float* bias, const float* rs, int rs_rows,
                            const float* res, float* out, int M, int N, int K, int silu,
                            MapRows rows_map, cudaStream_t stream);

cudaError_t launch_gemm_splitk(const float* A, int lda, const float* B, long long sbk,
                               long long sbn, float* part, int splits, float* out,
                               long long som, long long son, int M, int N, int K,
                               cudaStream_t stream);

}  // namespace vtx

using vtx::MapRows;
using vtx::map_pixel;
using vtx::MAP_NONE;
using vtx::MAP_RES;
using vtx::MAP_OUT;
using vtx::launch_gemm;
using vtx::launch_gemm_map;
using vtx::launch_gemm_splitk;

// internal linkage: each .cu that includes this gets its own copy
namespace {

// largest attention head width: the FMA attention kernels hold a head's
// vectors in registers, zero-padded to this width; with an additive bias the
// tensor-core window attention (window_attention_tc.cuh) takes heads up to
// EXTRA_DMAX wide
constexpr int DMAX = 64;
constexpr int EXTRA_DMAX = 32;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
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

template <bool MAP>
__global__ void __launch_bounds__(LN_THREADS)
ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ b, float* __restrict__ u,
               float* __restrict__ mu_out, float* __restrict__ rstd_out,
               int rows, int C, float eps, MapRows rows_map) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const float* xr = x + (MAP ? map_pixel(rows_map, row) : (long long)row) * C;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = xr[c];
    s += v;
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / C;
  const float var = ss / C - mu * mu;
  const float r = rsqrtf(var + eps);
  if (lane == 0 && mu_out) {
    mu_out[row] = mu;
    rstd_out[row] = r;
  }
  float* ur = u + (long long)row * C;
  for (int c = lane; c < C; c += 32) ur[c] = (xr[c] - mu) * r * g[c] + b[c];
}

inline cudaError_t launch_ln(const float* x, const float* g, const float* b,
                             float* u, float* mu, float* rstd, int rows, int C,
                             float eps, cudaStream_t stream) {
  ln_rows_kernel<false><<<cdiv(rows, LN_THREADS / 32), LN_THREADS, 0, stream>>>(
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

// out[m*som + n*son] = Σ_{z < S} part[z, m, n], summed in z order
__global__ void __launch_bounds__(REDUCE_THREADS)
splitk_reduce_kernel(const float* __restrict__ part, int S, int M, int N,
                     float* __restrict__ out, long long som, long long son) {
  const long long idx = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const long long MN = (long long)M * N;
  if (idx >= MN) return;
  float s = 0.f;
  for (int z = 0; z < S; ++z) s += part[z * MN + idx];
  const long long m = idx / N, n = idx % N;
  out[m * som + n * son] = s;
}

inline cudaError_t launch_splitk_reduce(const float* part, int S, int M, int N,
                                        float* out, long long som, long long son,
                                        cudaStream_t stream) {
  const long long blocks = cdivll((long long)M * N, REDUCE_THREADS);
  splitk_reduce_kernel<<<(unsigned)blocks, REDUCE_THREADS, 0, stream>>>(
      part, S, M, N, out, som, son);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Column sums over rows of [M, C]:
//   out[c] = Σ_m A[m, c]                                   (X == nullptr)
//   out[c] = Σ_m A[m, c] · (X[m, c] − mu[m]) · rstd[m]     (the LN's x̂)
// Pass 1: block (column tile, row chunk z) writes part[z, c]; pass 2 sums
// the chunks in order.  MAP: row r of X is map pixel map_pixel(rows_map, r).
// ---------------------------------------------------------------------------

constexpr int COLSUM_THREADS = 128;
constexpr int COLSUM_ROWS = 128;  // rows per chunk

inline int colsum_chunks(int M) { return cdiv(M, COLSUM_ROWS); }

template <bool MAP>
__global__ void __launch_bounds__(COLSUM_THREADS)
colsum_kernel(const float* __restrict__ A, const float* __restrict__ X,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              float* __restrict__ part, int M, int C, MapRows rows_map) {
  const int c = blockIdx.x * COLSUM_THREADS + threadIdx.x;
  if (c >= C) return;
  const int r0 = blockIdx.y * COLSUM_ROWS, r1 = min(M, r0 + COLSUM_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) {
    const long long i = (long long)r * C + c;
    const long long xi = MAP ? map_pixel(rows_map, r) * C + c : i;
    s += X ? A[i] * ((X[xi] - mu[r]) * rstd[r]) : A[i];
  }
  part[(long long)blockIdx.y * C + c] = s;
}

// part: scratch of colsum_chunks(M) * C floats; with rows_map.pix non-null,
// X is read through the map addressing
inline cudaError_t launch_colsum(const float* A, const float* X, const float* mu,
                                 const float* rstd, float* part, float* out,
                                 int M, int C, cudaStream_t stream,
                                 MapRows rows_map = MapRows{nullptr, 1}) {
  const int chunks = colsum_chunks(M);
  if (chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(cdiv(C, COLSUM_THREADS), chunks);
  if (rows_map.pix)
    colsum_kernel<true><<<grid, COLSUM_THREADS, 0, stream>>>(A, X, mu, rstd, part, M, C,
                                                            rows_map);
  else
    colsum_kernel<false><<<grid, COLSUM_THREADS, 0, stream>>>(A, X, mu, rstd, part, M,
                                                             C, rows_map);
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

// dst = rs[row / rows_per_scale] · src over rows of width C
__global__ void __launch_bounds__(EW_THREADS)
scale_rows_kernel(const float* __restrict__ src, const float* __restrict__ rs,
                  int rows_per_scale, int C, long long total,
                  float* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= total) return;
  dst[i] = src[i] * rs[(i / C) / rows_per_scale];
}

// Per sample b (one block) of a residual branch y = rs[b] ⊙ (a·W + bias):
// given dacc₀ = dy·Wᵀ [N·HD per sample] and the branch input a,
//   drs[b] = Σ_{rows of b} (dacc₀·a + dy·bias)   (when drs is non-null)
//   dacc   = rs[b] · dacc₀                         (in place)
constexpr int DRS_THREADS = 256;

__global__ void __launch_bounds__(DRS_THREADS)
row_scale_grad_kernel(float* __restrict__ dacc, const float* __restrict__ acc,
                      const float* __restrict__ dz, const float* __restrict__ bout,
                      const float* __restrict__ rs, float* __restrict__ drs,
                      int N, int HD, int C) {
  __shared__ float red[DRS_THREADS];
  const int b = blockIdx.x, t = threadIdx.x;
  const float r = rs[b];
  const long long a0 = (long long)b * N * HD;
  float s = 0.f;
  for (long long i = t; i < (long long)N * HD; i += DRS_THREADS) {
    const float d0 = dacc[a0 + i];
    s = fmaf(d0, acc[a0 + i], s);
    dacc[a0 + i] = d0 * r;
  }
  if (drs) {
    if (bout) {
      const long long z0 = (long long)b * N * C;
      for (long long i = t; i < (long long)N * C; i += DRS_THREADS)
        s = fmaf(dz[z0 + i], bout[i % C], s);
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

// u = (x − mu)·rstd·g + b, a forward LayerNorm's output from its saved
// statistics (the same expression as ln_rows_kernel, so bit-identical);
// MAP: row r of x is map pixel map_pixel(rows_map, r)
template <bool MAP>
__global__ void __launch_bounds__(EW_THREADS)
ln_apply_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                const float* __restrict__ rstd, const float* __restrict__ g,
                const float* __restrict__ b, float* __restrict__ u, int C,
                long long total, MapRows rows_map) {
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= total) return;
  const long long r = i / C;
  const int c = i % C;
  const long long xi = MAP ? map_pixel(rows_map, (int)r) * C + c : i;
  u[i] = (x[xi] - mu[r]) * rstd[r] * g[c] + b[c];
}

// LayerNorm backward, one warp per row (fused_layer.py:79-87):
//   dx = dz + rstd·(dx̂ − mean(dx̂) − x̂·mean(dx̂⊙x̂)),  dx̂ = dln ⊙ g
// MAP: row r of x and of dx is map pixel map_pixel(rows_map, r) (dln, dz
// and the statistics stay in row order)
template <bool MAP>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_rows_kernel(const float* __restrict__ dln, const float* __restrict__ x,
                   const float* __restrict__ mu, const float* __restrict__ rstd,
                   const float* __restrict__ g, const float* __restrict__ dz,
                   float* __restrict__ dx, int rows, int C, MapRows rows_map) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const long long off = (long long)row * C;
  const long long xoff = MAP ? map_pixel(rows_map, row) * C : off;
  const float m = mu[row], r = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dxh = dln[off + c] * g[c];
    const float xh = (x[xoff + c] - m) * r;
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
    const float xh = (x[xoff + c] - m) * r;
    dx[xoff + c] = dz[off + c] + r * (dxh - m1 - xh * m2);
  }
}

// The FF activations of vision_transformers_tpu/ops/fused_layer.py:90-108:
// silu(h) = h·σ(h) in the GEMM epilogue's expression (so bit-identical), and
// gelu's tanh approximation (jax.nn.gelu's default)
constexpr int ACT_SILU = 0, ACT_GELU = 1;
constexpr float GELU_C = 0.7978845608028654f;  // √(2/π)

template <int ACT>
__device__ __forceinline__ float act_fwd(float h) {
  if (ACT == ACT_SILU) return h / (1.f + expf(-h));
  return 0.5f * h * (1.f + tanhf(GELU_C * (h + 0.044715f * h * h * h)));
}

// d act / d h at h (fused_layer.py:98-108)
template <int ACT>
__device__ __forceinline__ float act_grad(float h) {
  if (ACT == ACT_SILU) {
    const float s = 1.f / (1.f + expf(-h));
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

// Δ[b, h, n] = Σ_d dacc[m, h·D + d] · acc[m, h·D + d]   (m = b·N + n): the
// row sums of dO ⊙ O that the attention backward passes read
__global__ void __launch_bounds__(EW_THREADS)
attn_delta_kernel(const float* __restrict__ dacc, const float* __restrict__ acc,
                  float* __restrict__ delta, int B, int N, int H, int D) {
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= (long long)B * H * N) return;
  const int n = i % N;
  const int h = (i / N) % H;
  const long long b = i / ((long long)N * H);
  const long long off = (b * N + n) * H * D + (long long)h * D;
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(dacc[off + d], acc[off + d], s);
  delta[i] = s;
}

// ---------------------------------------------------------------------------
// The grouped bias's gradient: dextra[g, h, q, k] = Σ_{r < R} ds[g·R + r,
// h, q, k], R = B / G rows per group, summed in r order (one thread per
// output element)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(EW_THREADS)
group_sum_kernel(const float* __restrict__ ds, int R, long long per_row,
                 long long total, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (e >= total) return;
  const long long g = e / per_row, rem = e % per_row;
  const float* src = ds + g * R * per_row + rem;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += src[(long long)r * per_row];
  out[e] = s;
}

// ---------------------------------------------------------------------------
// Attention pieces of the FMA attention kernels of fused_layer.cu and
// fused_layer_bwd.cu (ViT's attention, without a bias).  Each kernel holds
// one query (or one key) per thread with its vectors zero-padded to DH and
// stages the other side, a tile of KT rows, in shared memory; these are the
// per-thread steps.
// ---------------------------------------------------------------------------

// One key tile of the forward's online softmax for the thread's query q:
// s_j = q·k_j·scale for the first n_valid of the KT staged keys, −inf past
// them; the running max m, sum l and unnormalised output o are rescaled to
// the new max and take the tile.  Every tile holds at least one valid key,
// so the new max is finite (alpha is 0 on the first tile, where m is −inf).
template <int DH, int KT>
__device__ __forceinline__ void softmax_tile_update(
    const float (&q)[DH], const float (*Ks)[DH], const float (*Vs)[DH], int n_valid,
    float scale, float& m, float& l, float (&o)[DH]) {
  float s[KT];
  float tile_max = -INFINITY;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) dot = fmaf(q[d], Ks[j][d], dot);
    s[j] = j < n_valid ? dot * scale : -INFINITY;
    tile_max = fmaxf(tile_max, s[j]);
  }
  const float m_new = fmaxf(m, tile_max);
  const float alpha = expf(m - m_new);
  l *= alpha;
#pragma unroll
  for (int d = 0; d < DH; ++d) o[d] *= alpha;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const float p = expf(s[j] - m_new);  // 0 past the valid keys
    l += p;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = fmaf(p, Vs[j][d], o[d]);
  }
  m = m_new;
}

// Key-thread backward pass (dk / dv), first of its two d-outer passes: for
// the BQ staged queries, p[i] = q_i·k and dp[i] = do_i·v, with k, v the
// thread's rows (k[d], v[d] read once per d; nothing else stays live).
template <int DH, int BQ>
__device__ __forceinline__ void key_thread_dots(
    const float (*Qs)[DH], const float (*dOs)[DH], const float* k, const float* v,
    float (&p)[BQ], float (&dp)[BQ]) {
#pragma unroll
  for (int i = 0; i < BQ; ++i) p[i] = dp[i] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    const float kd = k[d], vd = v[d];
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      p[i] = fmaf(Qs[i][d], kd, p[i]);     // the score q_i·k
      dp[i] = fmaf(dOs[i][d], vd, dp[i]);  // do_i·v
    }
  }
}

// ... and its second: dv += Σ_i p_i·do_i, dk += Σ_i ds_i·q_i
template <int DH, int BQ>
__device__ __forceinline__ void key_thread_accumulate(
    const float (*Qs)[DH], const float (*dOs)[DH], const float (&p)[BQ],
    const float (&ds)[BQ], float (&dk)[DH], float (&dv)[DH]) {
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    float v_acc = dv[d], k_acc = dk[d];
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      v_acc = fmaf(p[i], dOs[i][d], v_acc);
      k_acc = fmaf(ds[i], Qs[i][d], k_acc);
    }
    dv[d] = v_acc;
    dk[d] = k_acc;
  }
}

// Query-thread backward pass (dq), first of its two d-outer passes: for the
// KT staged keys, p[j] = q·k_j and dp[j] = do·v_j, with q, do the thread's
// rows
template <int DH, int KT>
__device__ __forceinline__ void query_thread_dots(
    const float* q, const float* dO, const float (*Ks)[DH], const float (*Vs)[DH],
    float (&p)[KT], float (&dp)[KT]) {
#pragma unroll
  for (int j = 0; j < KT; ++j) p[j] = dp[j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    const float qd = q[d], dod = dO[d];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      p[j] = fmaf(qd, Ks[j][d], p[j]);     // the score q·k_j
      dp[j] = fmaf(dod, Vs[j][d], dp[j]);  // do·v_j
    }
  }
}

// ... and its second: dq += Σ_j ds_j·k_j
template <int DH, int KT>
__device__ __forceinline__ void query_thread_accumulate(
    const float (*Ks)[DH], const float (&ds)[KT], float (&dq)[DH]) {
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    float acc = dq[d];
#pragma unroll
    for (int j = 0; j < KT; ++j) acc = fmaf(ds[j], Ks[j][d], acc);
    dq[d] = acc;
  }
}

}  // namespace

// Host-side launch sequences shared between the sources; rows_per_scale is
// the number of rows that one per-sample row scale covers (N tokens of a
// sample).
namespace vtx {

// The FF residual branch of a pre-LN layer (fused_layer.cu), act = ACT_SILU
// or ACT_GELU (the template parameter of its kernels):
//   out = z + rs_ff ⊙ (act(LN₂(z)·W₁ + b₁)·W₂ + b₂)
// Serving (af null): silu rides in the first GEMM's epilogue into hid, gelu
// is applied to hid in place.  Training (af non-null): hid keeps the
// pre-activation, af = act(hid), and mu2 / rstd2 are saved.  b₁, b₂ and
// rs_ff may be null.
cudaError_t ff_half_fwd(
    const float* z, const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs_ff, int rows_per_scale, float* u, float* hid, float* af,
    float* mu2, float* rstd2, float* out, int M, int C, int F, float eps, int act,
    cudaStream_t s);

// The FF half's backward, steps 1-5 of fused_layer1_bwd.cu: given dout, the
// gradients of W₁, b₁, W₂, b₂, LN₂ and r₂, and dz = dout + LN₂ᵀ(dln₂).
cudaError_t ff_half_bwd(
    const float* z, const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs_ff, int rows_per_scale, const float* hid, const float* mu2,
    const float* rstd2, const float* dout, float* da, float* af, float* dh,
    float* u, float* dln, float* wpart, int splits_w1, int splits_w2,
    float* cpart, float* dz, float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f, float* drs_ff,
    int B, int M, int C, int F, int act, cudaStream_t s);

// Steps 1-2 of the attention branch's backward (fused_layer_bwd.cu): da =
// rs ⊙ dz, dwout = accᵀ·da, dbout, dacc = rs ⊙ dz·woutᵀ and dr.
cudaError_t out_proj_bwd(
    const float* acc, const float* wout, long long wout_s0, long long wout_s1,
    const float* bout, const float* rs, int rows_per_scale, const float* dz,
    float* da, float* dacc, float* wpart, int splits_out, float* cpart,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, int B, int M, int C, int HD, cudaStream_t s);

// Steps 4-5 on the qkv projection's input a [M, C] (fused_layer_bwd.cu):
// dwqkv = aᵀ·dqkv (split-K slabs summed in order), dbqkv = Σ_rows dqkv (when
// non-null), da = dqkv·wqkvᵀ; B8's backward (fused_attention_qkv.cu) ends
// with it
cudaError_t qkv_in_bwd(const float* a, const float* wqkv, long long wqkv_s0,
                       long long wqkv_s1, const float* dqkv, float* wpart, int splits_qkv,
                       float* cpart, float* dwqkv, long long dwqkv_s0, long long dwqkv_s1,
                       float* dbqkv, float* da, int M, int C, int HD, cudaStream_t s);

// Steps 4-6 of the attention branch's backward: u = LN(x) from the saved
// statistics, dwqkv = uᵀ·dqkv, dbqkv, dln = dqkv·wqkvᵀ and the LN backward
// dx = dz + LNᵀ(dln) with dg, db.
cudaError_t qkv_proj_bwd(
    const float* x, const float* ln_g, const float* ln_b, const float* mu,
    const float* rstd, const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* dqkv, const float* dz, float* u, float* dln, float* wpart,
    int splits_qkv, float* cpart, float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv, int M,
    int C, int HD, cudaStream_t s);

// Backward of the attention residual branch (fused_layer_bwd.cu), shared by
// the attention layer's backward and the whole layer's (fused_layer1_bwd.cu).
// extra / dextra / dbpart may be null; see fused_layer_bwd.cu.
cudaError_t attention_half_bwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* rs, const float* extra, int groups, const float* qkv,
    const float* acc, const float* mu, const float* rstd, const float* lse,
    const float* dz, float* da, float* dacc, float* delta, float* dqkv, float* u,
    float* dln, float* dbpart, float* wpart, int splits_out, int splits_qkv,
    float* cpart, float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, float* dextra, int B, int N, int C, int H, int D, float scale,
    cudaStream_t s);

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
