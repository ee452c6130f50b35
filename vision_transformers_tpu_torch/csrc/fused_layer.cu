// Forward kernels of the pre-LN transformer layer, float32, for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels
//   vision_transformers_tpu/ops/fused_layer.py:116   _attn_layer_fwd_kernel
//       z = x + r ⊙ OutProj(MHSA(QkvProj(LN1(x))))
//   vision_transformers_tpu/ops/fused_layer1.py:91   _l1_fwd_kernel
//       o = z + (silu(LN2(z)·W1 + b1)·W2 + b2)
//   vision_transformers_tpu/ops/fused_attention.py:313   _qkv_fwd_kernel
//       out = softmax(q·kᵀ·scale + extra)·v per head, from the packed qkv
//   vision_transformers_tpu/ops/fused_layer.py:701   _ff_fwd_kernel
//       o = x + r ⊙ (act(LN(x)·W1 + b1)·W2 + b2), act silu or tanh-gelu
//   vision_transformers_tpu/ops/fused_block.py:57   _blk_fwd_kernel
//       out = OutProj(MHSA(x·Wqkv + bqkv + extra)), no LN, no residual
// with one C entry point per op, each a short sequence of hand-written
// launches on the caller's stream:
//   vtx_fused_attention_layer_fwd   = ln_rows → gemm(+bqkv) → attention → gemm(+bout, ×r, +x)
//   vtx_fused_transformer_layer_fwd = the above → ln_rows → gemm(+b1, silu) → gemm(+b2, ×r₂, +z)
//   vtx_fused_attention_qkv_fwd     = attention alone, [B, N, 3·H·D] → [B, N, H·D]
//   vtx_fused_ff_layer_fwd          = ln_rows → gemm(+b1, act) → gemm(+b2, ×r, +x)
//   vtx_fused_attention_block_fwd   = gemm(+bqkv) → attention → gemm(+bout)
// The Pallas kernels keep every intermediate in VMEM; here the LN output,
// qkv, the attention output and the FF hidden go through device memory
// between launches (workspace the wrapper allocates).  In training the
// attention half keeps what its backward (fused_layer_bwd.cu) reads instead
// of discarding it: qkv, the attention output acc, the LN statistics
// mu / rstd and the softmax log-sum-exp lse [B, H, N] (the JAX kernel's
// "acc+qkv" save, fused_layer.py:404-419, plus what recomputing u and p
// needs).  r is the optional per-sample DropPath scale [B]; the attention
// half takes an optional additive bias [G, H, N, N] as the whole layer does
// (Twins' block mask of a packed window pair, G = 1).  The whole layer's
// training forward (fused_layer1.py:526's "z+acc+qkv" save) keeps
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
// B3 (the attention alone, ViT's training path with dropout and Swin's
// forced 'fused' path) is the attention kernel above with its own entry: it
// reads the projection output [B, N, 3·H·D] as it lies and writes
// [B, N, H·D], the out projection's input, so nothing is transposed on
// either side, and keeps lse for its backward where the Pallas kernel
// recomputes the softmax.  At ViT-S/16 (B = 128, N = 197, H = 6, D = 64) it
// does 4·B·H·N²·D = 7.6 GFLOP over 58 MB of qkv and out: bound by the f32
// FMA rate (~0.11 ms at 67 TFLOP/s) against ~0.02 ms of bytes.  B7 (the FF
// residual branch alone, under the FF-kernel switch) is the whole layer's
// FF half: LN, a GEMM with b₁ and the activation (silu in its epilogue when
// nothing is saved, else a separate elementwise pass writing act(hid)), and
// a GEMM with b₂, the row scale and the residual; at ViT-S/16's 25,216
// rows its 4·M·C·F = 59.5 GFLOP of GEMM bound it (~0.9 ms at the f32 FMA
// rate).
//
// B8 (the attention block, ViT's and Swin's path under a 'block' force) is
// the attention half without its LN, residual and row scale: the same
// GEMM → attention → GEMM sequence (attention_block below, which the
// attention half runs after its LN), the output Cout wide.  At ViT-S/16
// (B = 128) its 37.4 GFLOP forward bound it (~0.56 ms at the f32 FMA rate).
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
// separate instantiation keeps the serving kernel's registers as they were).
// CYCLIC: B9's sample-major pairs, row b in group b mod rows_per_group (the
// argument is then the group count G) instead of b / rows_per_group.
template <int DH, bool SAVE_LSE, bool HAS_EXTRA, bool CYCLIC>
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
  const int group = CYCLIC ? b % rows_per_group : b / rows_per_group;
  const float* ebase = HAS_EXTRA ? extra + ((long long)group * H + h) * N * N : nullptr;

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
    softmax_tile_update<DH, AKV, HAS_EXTRA>(q, Ks, Vs, Es[HAS_EXTRA ? threadIdx.x : 0],
                                            N - k0, scale, m, l, o);
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

template <int DH, bool HAS_EXTRA, bool CYCLIC = false>
cudaError_t launch_attention_dh(const float* qkv, const float* extra,
                                int rows_per_group, float* out, float* lse,
                                int B, int N, int H, int D, float scale,
                                cudaStream_t stream) {
  const dim3 grid(cdiv(N, AQ), H, B);
  if (lse)
    attention_kernel<DH, true, HAS_EXTRA, CYCLIC><<<grid, AQ, 0, stream>>>(
        qkv, extra, rows_per_group, out, lse, N, H, D, scale);
  else
    attention_kernel<DH, false, HAS_EXTRA, CYCLIC><<<grid, AQ, 0, stream>>>(
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

// out = res + rs ⊙ (MHSA(a·Wqkv + bqkv + extra)·Wout + bout) over a [B·N, C]
// → out [B·N, Cout], writing qkv and acc on the way (and lse when non-null);
// rs (per sample, N rows each) and res may be null
cudaError_t attention_block(
    const float* a, const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* bqkv, const float* wout, long long wout_s0, long long wout_s1,
    const float* bout, const float* extra, int groups, const float* rs,
    const float* res, float* qkv, float* acc, float* lse, float* out, int B, int N,
    int C, int H, int D, int Cout, float scale, cudaStream_t stream) {
  const int M = B * N, HD = H * D;
  VTX_CHECK(launch_gemm(a, wqkv, wqkv_s0, wqkv_s1, bqkv, nullptr, 1, nullptr,
                        qkv, M, 3 * HD, C, 0, stream));
  VTX_CHECK(launch_attention(qkv, extra, groups, acc, lse, B, N, H, D, scale, stream));
  VTX_CHECK(launch_gemm(acc, wout, wout_s0, wout_s1, bout, rs, N, res, out, M, Cout,
                        HD, 0, stream));
  return cudaSuccess;
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
  VTX_CHECK(launch_ln(x, ln_g, ln_b, u, mu, rstd, B * N, C, eps, stream));
  return attention_block(u, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout,
                         extra, groups, rs, x, qkv, acc, lse, z, B, N, C, H, D, C, scale,
                         stream);
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
                          eps, ACT_SILU, s);
}

template <int ACT>
cudaError_t ff_half_fwd_act(
    const float* z, const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs_ff, int rows_per_scale, float* u, float* hid, float* af,
    float* mu2, float* rstd2, float* out, int M, int C, int F, float eps,
    cudaStream_t s) {
  const long long MF = (long long)M * F;
  // silu rides in the GEMM's epilogue where nothing keeps the pre-activation
  const bool epilogue_silu = ACT == ACT_SILU && !af;
  VTX_CHECK(launch_ln(z, ln2_g, ln2_b, u, mu2, rstd2, M, C, eps, s));
  VTX_CHECK(launch_gemm(u, w1, w1_s0, w1_s1, b1, nullptr, 1, nullptr, hid, M, F,
                        C, epilogue_silu ? 1 : 0, s));
  if (!epilogue_silu) {
    act_kernel<ACT><<<ew_blocks(MF), EW_THREADS, 0, s>>>(hid, af ? af : hid, MF);
    VTX_CHECK(cudaGetLastError());
  }
  VTX_CHECK(launch_gemm(af ? af : hid, w2, w2_s0, w2_s1, b2, rs_ff, rows_per_scale,
                        z, out, M, C, F, 0, s));
  return cudaSuccess;
}

}  // namespace

cudaError_t vtx::ff_half_fwd(
    const float* z, const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs_ff, int rows_per_scale, float* u, float* hid, float* af,
    float* mu2, float* rstd2, float* out, int M, int C, int F, float eps, int act,
    cudaStream_t s) {
  if (act == ACT_SILU)
    return ff_half_fwd_act<ACT_SILU>(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0,
                                     w2_s1, b2, rs_ff, rows_per_scale, u, hid, af, mu2,
                                     rstd2, out, M, C, F, eps, s);
  if (act == ACT_GELU)
    return ff_half_fwd_act<ACT_GELU>(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0,
                                     w2_s1, b2, rs_ff, rows_per_scale, u, hid, af, mu2,
                                     rstd2, out, M, C, F, eps, s);
  return cudaErrorInvalidValue;
}

// B9's attention (common.cuh): pair p of the P = B·G sample-major pairs
// takes extra[p mod groups]; the 32-wide instantiation with the bias
cudaError_t vtx::window_attention_fwd(const float* qkv, const float* extra, int groups,
                                      float* out, float* lse, int P, int N, int H,
                                      int D, float scale, cudaStream_t s) {
  if (!extra || D > EXTRA_DMAX || P > 65535 || H > 65535 || groups < 1 || P % groups)
    return cudaErrorInvalidValue;
  return launch_attention_dh<EXTRA_DMAX, true, true>(qkv, extra, groups, out, lse, P,
                                                     N, H, D, scale, s);
}

// The C entry points return the first cudaError_t met (0 = success).
// extra [G, H, N, N] (groups = G; heads up to 32 wide), rs, mu, rstd and lse
// may be null: the serving forward passes none of the last four.

extern "C" int vtx_fused_attention_layer_fwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* extra, int groups, const float* rs, float* u, float* qkv,
    float* acc, float* mu, float* rstd, float* lse, float* out, int B, int N, int C,
    int H, int D, float scale, float eps, void* stream) {
  return static_cast<int>(attention_half(
      x, ln_g, ln_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout,
      extra, groups, rs, u, qkv, acc, mu, rstd, lse, out, B, N, C, H, D, scale, eps,
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

// B3: attention straight from the packed projection qkv [B, N, 3·H·D] into
// out [B, N, H·D], no relayout on either side, and the row log-sum-exp lse
// [B, H, N] its backward (fused_layer_bwd.cu) reads when lse is non-null.
// extra [G, H, N, N] (groups = G; heads up to 32 wide) may be null; heads
// without it up to 64 wide.
extern "C" int vtx_fused_attention_qkv_fwd(
    const float* qkv, const float* extra, int groups, float* out, float* lse,
    int B, int N, int H, int D, float scale, void* stream) {
  return static_cast<int>(launch_attention(qkv, extra, groups, out, lse, B, N, H, D,
                                           scale, static_cast<cudaStream_t>(stream)));
}

// B7: the pre-LN FF residual branch out = x + rs ⊙ (act(LN(x)·W₁ + b₁)·W₂ + b₂)
// over M = B·N rows, rs [B] per sample (N rows each), act 0 = silu, 1 =
// tanh-gelu.  u [M, C] and hid [M, F] are workspace; in training (af [M, F]
// non-null) hid keeps the pre-activation and mu / rstd [M] are saved for
// the backward (fused_layer1_bwd.cu).  b1, b2, rs, af, mu and rstd may be
// null.
extern "C" int vtx_fused_ff_layer_fwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs, float* u, float* hid, float* af, float* mu, float* rstd,
    float* out, int B, int N, int C, int F, int act, float eps, void* stream) {
  if (B < 1 || N < 1 || (long long)B * N > 0x7fffffffLL) return cudaErrorInvalidValue;
  return static_cast<int>(vtx::ff_half_fwd(
      x, ln_g, ln_b, w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1, b2, rs, N, u, hid, af,
      mu, rstd, out, B * N, C, F, eps, act, static_cast<cudaStream_t>(stream)));
}

// B8: out = OutProj(MHSA(x·Wqkv + bqkv + extra)) + bout, x [B, N, C] → out
// [B, N, Cout], no LN and no residual.  qkv [B, N, 3·H·D] and acc [B, N, H·D]
// are workspace the training forward keeps with lse [B, H, N] for its
// backward (fused_layer_bwd.cu); lse may be null (serving).  extra
// [G, H, N, N] (groups = G; heads up to 32 wide), bqkv and bout may be null.
extern "C" int vtx_fused_attention_block_fwd(
    const float* x, const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* bqkv, const float* wout, long long wout_s0, long long wout_s1,
    const float* bout, const float* extra, int groups, float* qkv, float* acc,
    float* lse, float* out, int B, int N, int C, int H, int D, int Cout, float scale,
    void* stream) {
  return static_cast<int>(attention_block(
      x, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout, extra, groups,
      nullptr, nullptr, qkv, acc, lse, out, B, N, C, H, D, Cout, scale,
      static_cast<cudaStream_t>(stream)));
}
