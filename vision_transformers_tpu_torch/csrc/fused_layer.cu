// Forward kernels of the pre-LN transformer layer, float32, for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels
//   vision_transformers_tpu/ops/fused_layer.py:116   _attn_layer_fwd_kernel
//       z = x + r ⊙ OutProj(MHSA(QkvProj(LN1(x))))
//   vision_transformers_tpu/ops/fused_layer1.py:91   _l1_fwd_kernel
//       o = z + (silu(LN2(z)·W1 + b1)·W2 + b2)
// with one C entry point per op, each a short sequence of hand-written
// launches on the caller's stream:
//   vtx_fused_attention_layer_fwd   = ln_rows → gemm(+bqkv) → attention → gemm(+bout, ×r, +x)
//   vtx_fused_transformer_layer_fwd = the above → ln_rows → gemm(+b1, silu) → gemm(+b2, ×r₂, +z)
// The Pallas kernels keep every intermediate in VMEM; here the LN output,
// qkv, the attention output and the FF hidden go through device memory
// between launches (workspace the wrapper allocates).  In training the
// attention half keeps what its backward (fused_layer_bwd.cu) reads instead
// of discarding it: qkv, the attention output acc, the LN statistics
// mu / rstd and the softmax log-sum-exp lse [B, H, N] (the JAX kernel's
// "acc+qkv" save, fused_layer.py:404-419, plus what recomputing u and p
// needs).  r is the optional per-sample DropPath scale [B].  The whole
// layer's training forward (fused_layer1.py:526's "z+acc+qkv" save) keeps
// the same plus z, the LN₂ statistics and the FF pre-activation hid, which
// its backward (fused_layer1_bwd.cu) reads; it takes both row scales
// (r₁ = rs_attn, r₂ = rs_ff) and Swin's grouped attention bias extra
// [G, H, N, N] (row b in group b / (B/G), fused_layer1.py:501).
//
// What bounds it on this card.  At ViT-S/16 (N=197, C=384, F=1536) the four
// projections are about 8.4 GFLOP per image over 12 layers, the scores and
// AV about 0.7, so the layer is bound by the GEMMs' arithmetic.  This first
// version computes them with plain f32 FMAs (no tensor cores, no TF32), in a
// tiled shared-memory GEMM: 128x64 output tiles, 16-deep k slabs, 8x4
// outputs per thread.  Attention never stores an N x N matrix: one block per
// (batch, head, 64-query tile), one query per thread, key/value tiles
// streamed through shared memory with an online max-subtracted softmax in
// f32, so any N works.
//
// What later work changes: bf16 operands on wgmma with TMA-fed shared-memory
// rings (the tensor cores are ~15x the f32 FMA rate), and fusing each op's
// launch sequence into fewer launches so intermediates stay on chip.
//
// Numerics follow the JAX kernels: LN statistics in f32 in the fast-variance
// form E[x²]−μ² (fused_layer.py:69-76), f32 accumulation, softmax in f32.
// Weights are read through (row, col) strides, so a transposed view
// (torch's Linear.weight.t()) is consumed in place, without a copy.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Attention over the packed projection qkv [B*N, 3*H*D] (q-heads | k-heads |
// v-heads) → out [B*N, H*D], and the row log-sum-exp lse [B, H, N] of the
// scaled scores when lse is non-null.  Grid (query tiles, H, B); one query
// per thread.  DH: the register width of a head (≥ D, zero-padded).  HAS_EXTRA: the scores carry the additive bias
// extra[g, h] [N, N] of the row's group g = b / rows_per_group (Swin's
// relative-position bias and shift mask), staged in shared memory per key
// tile.  Masked pairs hold −1e9, not −inf: a tile whose keys are all masked
// gives finite scores, and the first tile with a visible key rescales what
// it left by exp(−1e9 − m) = 0, so neither lse nor the output sees a NaN.
// ---------------------------------------------------------------------------

constexpr int AQ = 64;     // queries per block = threads per block
constexpr int AKV = 32;    // keys per shared-memory tile

// SAVE_LSE: the training forward's variant, which also writes lse (a
// separate instantiation keeps the serving kernel's registers as they were)
template <int DH, bool SAVE_LSE, bool HAS_EXTRA>
__global__ void __launch_bounds__(AQ)
attention_kernel(const float* __restrict__ qkv, const float* __restrict__ extra,
                 int rows_per_group, float* __restrict__ out,
                 float* __restrict__ lse, int N, int H, int D, float scale) {
  __shared__ float Ks[AKV][DH];
  __shared__ float Vs[AKV][DH];
  __shared__ float Es[HAS_EXTRA ? AQ : 1][AKV + 1];
  const int b = blockIdx.z, h = blockIdx.y;
  const int HD = H * D;
  const long long row_stride = 3LL * HD;
  const float* base = qkv + (long long)b * N * row_stride;
  const int q0 = blockIdx.x * AQ;
  const int qi = q0 + threadIdx.x;
  const float* ebase = HAS_EXTRA
      ? extra + ((long long)(b / rows_per_group) * H + h) * N * N : nullptr;

  // zero-padded to DH, so the unrolled dots need no width test
  float q[DH], o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = (qi < N && d < D) ? base[(long long)qi * row_stride + h * D + d] : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += AKV) {
    for (int idx = threadIdx.x; idx < AKV * DH; idx += AQ) {
      const int j = idx / DH, d = idx % DH;
      const int kj = k0 + j;
      const bool ok = kj < N && d < D;
      const float* rowp = base + (long long)kj * row_stride + h * D + d;
      Ks[j][d] = ok ? rowp[HD] : 0.f;
      Vs[j][d] = ok ? rowp[2 * HD] : 0.f;
    }
    if (HAS_EXTRA) {
      for (int idx = threadIdx.x; idx < AQ * AKV; idx += AQ) {
        const int i = idx / AKV, j = idx % AKV;
        const bool ok = q0 + i < N && k0 + j < N;
        Es[i][j] = ok ? ebase[(long long)(q0 + i) * N + k0 + j] : 0.f;
      }
    }
    __syncthreads();

    float s[AKV];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < AKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(q[d], Ks[j][d], dot);
      if (HAS_EXTRA)
        s[j] = (k0 + j < N) ? dot * scale + Es[threadIdx.x][j] : -INFINITY;
      else
        s[j] = (k0 + j < N) ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // every tile holds at least one real key, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < AKV; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for padded keys
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = fmaf(p, Vs[j][d], o[d]);
    }
    m = m_new;
    __syncthreads();
  }

  if (qi < N) {
    const float inv = 1.f / l;
    float* orow = out + ((long long)b * N + qi) * HD + h * D;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < D) orow[d] = o[d] * inv;
    if (SAVE_LSE) lse[((long long)b * H + h) * N + qi] = m + logf(l);
  }
}

template <int DH, bool HAS_EXTRA>
cudaError_t launch_attention_dh(const float* qkv, const float* extra,
                                int rows_per_group, float* out, float* lse,
                                int B, int N, int H, int D, float scale,
                                cudaStream_t stream) {
  const dim3 grid(cdiv(N, AQ), H, B);
  if (lse)
    attention_kernel<DH, true, HAS_EXTRA><<<grid, AQ, 0, stream>>>(
        qkv, extra, rows_per_group, out, lse, N, H, D, scale);
  else
    attention_kernel<DH, false, HAS_EXTRA><<<grid, AQ, 0, stream>>>(
        qkv, extra, rows_per_group, out, lse, N, H, D, scale);
  return cudaGetLastError();
}

// extra [G, H, N, N] or null; rows b of group b / (B / G).  Two
// instantiations serve the paths the port runs: without a bias the 64-wide
// heads of ViT (narrower heads are zero-padded), with a bias heads up to 32
// wide (Swin's D = 32); a bias with wider heads is refused.
cudaError_t launch_attention(const float* qkv, const float* extra, int groups,
                             float* out, float* lse, int B, int N, int H, int D,
                             float scale, cudaStream_t stream) {
  if (D > DMAX || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  if (!extra)
    return launch_attention_dh<DMAX, false>(qkv, nullptr, 1, out, lse, B, N, H, D,
                                            scale, stream);
  if (D > EXTRA_DMAX || groups < 1 || B % groups) return cudaErrorInvalidValue;
  return launch_attention_dh<EXTRA_DMAX, true>(qkv, extra, B / groups, out, lse, B,
                                               N, H, D, scale, stream);
}

// z = x + rs ⊙ OutProj(MHSA(QkvProj(LN(x)) + extra)), writing u, qkv, acc
// on the way (and mu, rstd, lse when non-null)
cudaError_t attention_half(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* extra, int groups, const float* rs, float* u, float* qkv,
    float* acc, float* mu, float* rstd, float* lse, float* z, int B, int N,
    int C, int H, int D, float scale, float eps, cudaStream_t stream) {
  const int M = B * N, HD = H * D;
  VTX_CHECK(launch_ln(x, ln_g, ln_b, u, mu, rstd, M, C, eps, stream));
  VTX_CHECK(launch_gemm(u, wqkv, wqkv_s0, wqkv_s1, bqkv, nullptr, 1, nullptr,
                        qkv, M, 3 * HD, C, 0, stream));
  VTX_CHECK(launch_attention(qkv, extra, groups, acc, lse, B, N, H, D, scale, stream));
  VTX_CHECK(launch_gemm(acc, wout, wout_s0, wout_s1, bout, rs, N, x, z, M, C,
                        HD, 0, stream));
  return cudaSuccess;
}

// o = z + rs_ff ⊙ (silu(LN2(z)·W1 + b1)·W2 + b2) after the attention half
// (vtx::ff_half_fwd below)
cudaError_t transformer_layer(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* extra, int groups, const float* rs_attn, const float* rs_ff,
    float* u, float* qkv, float* acc, float* z, float* hid, float* af,
    float* mu1, float* rstd1, float* lse, float* mu2, float* rstd2, float* out,
    int B, int N, int C, int H, int D, int F, float scale, float eps,
    cudaStream_t s) {
  VTX_CHECK(attention_half(x, ln1_g, ln1_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout,
                           wout_s0, wout_s1, bout, extra, groups, rs_attn, u,
                           qkv, acc, mu1, rstd1, lse, z, B, N, C, H, D, scale,
                           eps, s));
  return vtx::ff_half_fwd(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1,
                          b2, rs_ff, N, u, hid, af, mu2, rstd2, out, B * N, C, F,
                          eps, s);
}

}  // namespace

cudaError_t vtx::ff_half_fwd(
    const float* z, const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs_ff, int rows_per_scale, float* u, float* hid, float* af,
    float* mu2, float* rstd2, float* out, int M, int C, int F, float eps,
    cudaStream_t s) {
  VTX_CHECK(launch_ln(z, ln2_g, ln2_b, u, mu2, rstd2, M, C, eps, s));
  VTX_CHECK(launch_gemm(u, w1, w1_s0, w1_s1, b1, nullptr, 1, nullptr, hid, M, F,
                        C, af ? 0 : 1, s));
  if (af) {
    silu_kernel<<<ew_blocks((long long)M * F), EW_THREADS, 0, s>>>(
        hid, af, (long long)M * F);
    VTX_CHECK(cudaGetLastError());
  }
  VTX_CHECK(launch_gemm(af ? af : hid, w2, w2_s0, w2_s1, b2, rs_ff, rows_per_scale,
                        z, out, M, C, F, 0, s));
  return cudaSuccess;
}

// The C entry points return the first cudaError_t met (0 = success).
// rs, mu, rstd and lse may be null: the serving forward passes none of them.

extern "C" int vtx_fused_attention_layer_fwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* rs, float* u, float* qkv, float* acc, float* mu, float* rstd,
    float* lse, float* out, int B, int N, int C, int H, int D, float scale,
    float eps, void* stream) {
  return static_cast<int>(attention_half(
      x, ln_g, ln_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout,
      nullptr, 1, rs, u, qkv, acc, mu, rstd, lse, out, B, N, C, H, D, scale, eps,
      static_cast<cudaStream_t>(stream)));
}

// extra [G, H, N, N] (groups = G), rs_attn / rs_ff [B] and the saves
// af [M, F], mu1, rstd1 [M], lse [B, H, N], mu2, rstd2 [M] may be null; u,
// qkv, acc, z, hid are workspace the training forward keeps (hid then holds
// the FF pre-activation).
extern "C" int vtx_fused_transformer_layer_fwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* extra, int groups, const float* rs_attn, const float* rs_ff,
    float* u, float* qkv, float* acc, float* z, float* hid, float* af,
    float* mu1, float* rstd1, float* lse, float* mu2, float* rstd2, float* out,
    int B, int N, int C, int H, int D, int F, float scale, float eps,
    void* stream) {
  return static_cast<int>(transformer_layer(
      x, ln1_g, ln1_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1,
      bout, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1, b2, extra,
      groups, rs_attn, rs_ff, u, qkv, acc, z, hid, af, mu1, rstd1, lse, mu2,
      rstd2, out, B, N, C, H, D, F, scale, eps,
      static_cast<cudaStream_t>(stream)));
}
