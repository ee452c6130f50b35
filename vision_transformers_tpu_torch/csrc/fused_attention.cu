// Reduced-kv attention, forward and backward, float32, for Hopper (sm_90a):
//
//   out[b, g] = softmax(q[b, g]·k[b, g]ᵀ·scale)·v[b, g]
//
// with q [B, G, M, D] and k, v [B, G, N, D], M ≠ N.  Replaces the TPU (Pallas)
// kernels
//   vision_transformers_tpu/ops/fused_attention.py:67   _fwd_kernel
//   vision_transformers_tpu/ops/fused_attention.py:92   _bwd_kernel
// at the sites that run them: PVT's spatial-reduction attention (M = the
// stage's tokens, N = the conv-reduced ones) and Twins' global sub-sampled
// attention.  The additive bias ``extra`` of the JAX kernel is not taken
// here (no model passes one to this op; the wrapper refuses it).
//
// Operands are strided: element (b, g, r, d) of q, k, v and do at
// p[b·sb + g·sg + r·sr + d], so the heads of a projection's [B, rows, G·D]
// output (PVT's linear_q, the two halves of linear_kv) are read in place.
// out and dq are written as [B, M, G, D] (the order the output projection
// reads and the q projection's gradient has), dk / dv as [2, B, N, G, D].
// Two C entries, each a short sequence of launches on the caller's stream:
//
//   vtx_fused_attention_fwd   one block per (64-query tile, g, b), one query
//                             per thread; the q tile is loaded coalesced
//                             through shared memory, key / value tiles are
//                             staged there, online max-subtracted softmax in
//                             f32 (common.cuh softmax_tile_update); the
//                             output tile leaves through shared memory; the
//                             training forward also writes the log-sum-exp
//                             lse [B, G, M]
//   vtx_fused_attention_bwd   1. dq: one query per thread as the forward,
//                                Δ = rowsum(do ⊙ out) first (written for 2),
//                                then per key tile p = exp(q·kᵀ·s − lse),
//                                dS = p ⊙ (do·vᵀ − Δ), dq += dS·k·s
//                             2. dk / dv: one key per thread; the M queries
//                                are cut into chunks, and a block (key tile,
//                                chunk, g, b) streams its chunk's queries
//                                through shared memory and writes its own
//                                partial dk = Σ dSᵀ·q·s, dv = Σ pᵀ·do
//                             3. the chunks' partials summed in chunk order
//                                (common.cuh splitk_reduce_kernel)
// No float atomics anywhere, so the backward is bit-identical from run to run.
//
// What bounds it on this card.  The forward does 4·B·G·M·N·D operations
// against 4·B·G·(2·M + 2·N)·D bytes moved: at PVT-S stage 1 (128 images,
// M = 3136, N = 49, D = 64) 5.0 GFLOP against 0.2 GB, so the f32 FMA rate
// (67 TFLOP/s at 700 W) and the memory rate (3.35 TB/s) bound it about
// equally (0.075 vs 0.062 ms); from PVT-S stage 2 and Twins' stage 2 on the
// bytes bound it.  What the design does about it: each of q, do and out is
// read once, through coalesced tile loads, and kv stays in shared memory
// for a whole query tile.  The trouble spot is the backward's dk / dv: N is
// 1-64 while M is up to 3,136, and at PVT-S stage 1 there are only
// B·G = 128 (image, head) pairs for 132 SMs, so one block per pair would
// leave the card idle; the query axis is split into chunks (about two
// waves of blocks) whose partials are summed in order afterwards, as the
// split-K weight gradients and the Halo dbias partials are.  N = 1 (Twins
// stage 4) is a tile of one key: p ≡ 1, dS = 0 up to rounding.
//
// What later work changes: mma / wgmma tiles for the two products, the
// lse and Δ folded into fewer passes, bf16 operands, the bias.

#include "common.cuh"

namespace {

constexpr int FQ = 64;    // queries per block = threads (forward, dq)
constexpr int FKV = 32;   // keys per shared-memory tile (forward)
constexpr int FKD = 16;   // keys per shared-memory tile (dq)
constexpr int FKB = 64;   // keys per block = threads (dk / dv)
constexpr int FBQ = 16;   // queries per shared-memory tile (dk / dv)

// A strided [B, G, rows, D] operand with unit stride along D.
struct Strided {
  const float* p;
  long long sb, sg, sr;
  __device__ __forceinline__ const float* row(int b, int g, int r) const {
    return p + b * sb + g * sg + (long long)r * sr;
  }
};

// Rows [r0, r0 + n) of operand t at (b, g) into the tile T (rows padded),
// zero past n rows and past D; neighbouring threads take neighbouring d.
template <int DH, int ROWS, int PAD, int THREADS>
__device__ __forceinline__ void load_tile(float (*T)[DH + PAD], const Strided& t, int b,
                                          int g, int r0, int n, int D) {
  for (int idx = threadIdx.x; idx < ROWS * DH; idx += THREADS) {
    const int i = idx / DH, d = idx % DH;
    T[i][d] = (i < n && d < D) ? t.row(b, g, r0 + i)[d] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward: grid (query tiles, G, B), one query per thread
// ---------------------------------------------------------------------------

template <int DH, bool SAVE_LSE>
__global__ void __launch_bounds__(FQ)
mha_fwd_kernel(Strided q, Strided k, Strided v, float* __restrict__ out,
               float* __restrict__ lse, int G, int M, int N, int D, float scale) {
  __shared__ float Qs[FQ][DH + 1];  // the q tile in, the output tile out
  __shared__ float Ks[FKV][DH];
  __shared__ float Vs[FKV][DH];
  const int g = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int q0 = blockIdx.x * FQ, rows = min(FQ, M - q0);
  load_tile<DH, FQ, 1, FQ>(Qs, q, b, g, q0, rows, D);
  __syncthreads();
  float qr[DH], o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = Qs[t][d];
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < N; k0 += FKV) {
    const int nk = min(FKV, N - k0);
    load_tile<DH, FKV, 0, FQ>(Ks, k, b, g, k0, nk, D);
    load_tile<DH, FKV, 0, FQ>(Vs, v, b, g, k0, nk, D);
    __syncthreads();
    softmax_tile_update<DH, FKV, false>(qr, Ks, Vs, nullptr, nk, scale, m, l, o);
    __syncthreads();
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < DH; ++d) Qs[t][d] = o[d] * inv;
  if (SAVE_LSE && t < rows) lse[((long long)b * G + g) * M + q0 + t] = m + logf(l);
  __syncthreads();
  for (int idx = t; idx < rows * D; idx += FQ) {
    const int i = idx / D, d = idx % D;
    out[(((long long)b * M + q0 + i) * G + g) * D + d] = Qs[i][d];
  }
}

// ---------------------------------------------------------------------------
// 1. dq (and Δ): grid (query tiles, G, B), one query per thread; its q and
//    do rows in (padded) shared memory, key tiles of k and v staged there,
//    two d-outer passes per tile (common.cuh query_thread_*)
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(FQ)
mha_bwd_dq_kernel(Strided q, Strided k, Strided v, const float* __restrict__ out,
                  Strided dout, const float* __restrict__ lse,
                  float* __restrict__ delta, float* __restrict__ dq, int G, int M,
                  int N, int D, float scale) {
  __shared__ float Qs[FQ][DH + 1];   // out, then q; then the dq tile
  __shared__ float dOs[FQ][DH + 1];
  __shared__ float Ks[FKD][DH];
  __shared__ float Vs[FKD][DH];
  const int g = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int q0 = blockIdx.x * FQ, rows = min(FQ, M - q0);
  const Strided o_rows{out, (long long)M * G * D, D, (long long)G * D};
  load_tile<DH, FQ, 1, FQ>(Qs, o_rows, b, g, q0, rows, D);
  load_tile<DH, FQ, 1, FQ>(dOs, dout, b, g, q0, rows, D);
  __syncthreads();
  // Δ = do·out in d order (fused_layer_bwd.cu's attn_delta_kernel's sum)
  float dl = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) dl = fmaf(dOs[t][d], Qs[t][d], dl);
  const long long lrow = ((long long)b * G + g) * M + q0 + t;
  const float l = t < rows ? lse[lrow] : 0.f;
  if (t < rows) delta[lrow] = dl;
  __syncthreads();
  load_tile<DH, FQ, 1, FQ>(Qs, q, b, g, q0, rows, D);
  float dqa[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) dqa[d] = 0.f;

  for (int k0 = 0; k0 < N; k0 += FKD) {
    const int nk = min(FKD, N - k0);
    __syncthreads();  // Qs written, or the last tile fully read
    load_tile<DH, FKD, 0, FQ>(Ks, k, b, g, k0, nk, D);
    load_tile<DH, FKD, 0, FQ>(Vs, v, b, g, k0, nk, D);
    __syncthreads();
    float p[FKD], ds[FKD];  // the scores and do·v, then p and dS
    query_thread_dots<DH, FKD>(Qs[t], dOs[t], Ks, Vs, p, ds);
#pragma unroll
    for (int j = 0; j < FKD; ++j) {
      p[j] = (t < rows && j < nk) ? expf(p[j] * scale - l) : 0.f;
      ds[j] = p[j] * (ds[j] - dl);
    }
    query_thread_accumulate<DH, FKD>(Ks, ds, dqa);
  }
  __syncthreads();  // every thread is done with Qs
#pragma unroll
  for (int d = 0; d < DH; ++d) Qs[t][d] = dqa[d] * scale;
  __syncthreads();
  for (int idx = t; idx < rows * D; idx += FQ) {
    const int i = idx / D, d = idx % D;
    dq[(((long long)b * M + q0 + i) * G + g) * D + d] = Qs[i][d];
  }
}

// ---------------------------------------------------------------------------
// 2. dk / dv partials: grid (chunks · key tiles, G, B), one key per thread,
//    its k / v rows in (padded) shared memory and its dk / dv accumulators
//    in registers; the chunk's queries stream through shared memory in
//    tiles of FBQ with their lse and Δ, two d-outer passes per tile
//    (common.cuh key_thread_*).  part [chunks, 2, B, N, G, D].
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(FKB)
mha_bwd_dkdv_kernel(Strided q, Strided k, Strided v, Strided dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ part, int B, int G, int M, int N, int D,
                    int per_chunk, int ktiles, float scale) {
  __shared__ float Ks[FKB][DH + 1];  // +1: thread t reads row t, bank-free
  __shared__ float Vs[FKB][DH + 1];
  __shared__ float Qs[FBQ][DH];
  __shared__ float dOs[FBQ][DH];
  __shared__ float Ls[FBQ], Ds[FBQ];
  const int c = blockIdx.x / ktiles, k0 = (blockIdx.x % ktiles) * FKB;
  const int g = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int nk = min(FKB, N - k0);
  load_tile<DH, FKB, 1, FKB>(Ks, k, b, g, k0, nk, D);
  load_tile<DH, FKB, 1, FKB>(Vs, v, b, g, k0, nk, D);
  const float* lbase = lse + ((long long)b * G + g) * M;
  const float* dbase = delta + ((long long)b * G + g) * M;
  float dk[DH], dv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) dk[d] = dv[d] = 0.f;

  const int q_end = min(M, (c + 1) * per_chunk);
  for (int q0 = c * per_chunk; q0 < q_end; q0 += FBQ) {
    const int nq = min(FBQ, q_end - q0);
    __syncthreads();  // Ks / Vs written, or the last query tile fully read
    load_tile<DH, FBQ, 0, FKB>(Qs, q, b, g, q0, nq, D);
    load_tile<DH, FBQ, 0, FKB>(dOs, dout, b, g, q0, nq, D);
    if (t < FBQ) {
      Ls[t] = t < nq ? lbase[q0 + t] : INFINITY;  // p = exp(−inf) = 0 for padding
      Ds[t] = t < nq ? dbase[q0 + t] : 0.f;
    }
    __syncthreads();
    float p[FBQ], ds[FBQ];  // the scores and do·v, then p and dS
    key_thread_dots<DH, FBQ>(Qs, dOs, Ks[t], Vs[t], p, ds);
#pragma unroll
    for (int i = 0; i < FBQ; ++i) {
      p[i] = expf(p[i] * scale - Ls[i]);
      ds[i] = p[i] * (ds[i] - Ds[i]);
    }
    key_thread_accumulate<DH, FBQ>(Qs, dOs, p, ds, dk, dv);
  }

  // every block writes its partial, an empty chunk's zeros too
  if (t < nk) {
    const long long slab = (long long)B * N * G * D;
    float* row = part + 2 * c * slab + (((long long)b * N + k0 + t) * G + g) * D;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if (d < D) {
        row[d] = dk[d] * scale;
        row[slab + d] = dv[d];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch sequences
// ---------------------------------------------------------------------------

cudaError_t check_dims(int B, int G, int M, int N, int D) {
  if (B < 1 || G < 1 || M < 1 || N < 1 || D < 1 || D > DMAX || B > 65535 ||
      G > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int DH>
cudaError_t mha_fwd(const Strided& q, const Strided& k, const Strided& v, float* out,
                    float* lse, int B, int G, int M, int N, int D, float scale,
                    cudaStream_t s) {
  const dim3 grid(cdiv(M, FQ), G, B);
  if (lse)
    mha_fwd_kernel<DH, true><<<grid, FQ, 0, s>>>(q, k, v, out, lse, G, M, N, D, scale);
  else
    mha_fwd_kernel<DH, false><<<grid, FQ, 0, s>>>(q, k, v, out, nullptr, G, M, N, D,
                                                  scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t mha_bwd(const Strided& q, const Strided& k, const Strided& v,
                    const float* out, const float* lse, const Strided& dout,
                    float* delta, float* part, int chunks, float* dq, float* dkv, int B,
                    int G, int M, int N, int D, float scale, cudaStream_t s) {
  mha_bwd_dq_kernel<DH><<<dim3(cdiv(M, FQ), G, B), FQ, 0, s>>>(
      q, k, v, out, dout, lse, delta, dq, G, M, N, D, scale);
  VTX_CHECK(cudaGetLastError());
  const int ktiles = cdiv(N, FKB);
  if ((long long)chunks * ktiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  mha_bwd_dkdv_kernel<DH><<<dim3(chunks * ktiles, G, B), FKB, 0, s>>>(
      q, k, v, dout, lse, delta, part, B, G, M, N, D, cdiv(M, chunks), ktiles, scale);
  VTX_CHECK(cudaGetLastError());
  return launch_splitk_reduce(part, chunks, 1, (int)(2LL * B * N * G * D), dkv, 0, 1,
                              s);
}

}  // namespace

// The C entry points return the first cudaError_t met (0 = success).  q, k,
// v (and do) are given by their base pointer and their (b, g, row) strides
// in elements, unit stride along D; D ≤ 64 (heads up to 32 wide take the
// narrower instantiation).

// out [B, M, G, D]; lse [B, G, M] or null (no saves)
extern "C" int vtx_fused_attention_fwd(
    const float* q, long long q_sb, long long q_sg, long long q_sm,
    const float* k, long long k_sb, long long k_sg, long long k_sn,
    const float* v, long long v_sb, long long v_sg, long long v_sn,
    float* out, float* lse, int B, int G, int M, int N, int D, float scale,
    void* stream) {
  VTX_CHECK(check_dims(B, G, M, N, D));
  const Strided qs{q, q_sb, q_sg, q_sm}, ks{k, k_sb, k_sg, k_sn}, vs{v, v_sb, v_sg, v_sn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D <= EXTRA_DMAX ? mha_fwd<EXTRA_DMAX>(qs, ks, vs, out, lse, B, G, M, N, D, scale, s)
                      : mha_fwd<DMAX>(qs, ks, vs, out, lse, B, G, M, N, D, scale, s));
}

// out and lse: the training forward's; workspace delta [B·G·M] and part
// [chunks·2·B·N·G·D] (1 ≤ chunks ≤ M); dq [B, M, G, D], dkv [2, B, N, G, D]
// (dk, then dv)
extern "C" int vtx_fused_attention_bwd(
    const float* q, long long q_sb, long long q_sg, long long q_sm,
    const float* k, long long k_sb, long long k_sg, long long k_sn,
    const float* v, long long v_sb, long long v_sg, long long v_sn,
    const float* out, const float* lse,
    const float* dout, long long do_sb, long long do_sg, long long do_sm,
    float* delta, float* part, int chunks, float* dq, float* dkv,
    int B, int G, int M, int N, int D, float scale, void* stream) {
  VTX_CHECK(check_dims(B, G, M, N, D));
  if (chunks < 1 || chunks > M || 2LL * B * N * G * D > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Strided qs{q, q_sb, q_sg, q_sm}, ks{k, k_sb, k_sg, k_sn}, vs{v, v_sb, v_sg, v_sn};
  const Strided ds{dout, do_sb, do_sg, do_sm};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D <= EXTRA_DMAX
          ? mha_bwd<EXTRA_DMAX>(qs, ks, vs, out, lse, ds, delta, part, chunks, dq, dkv,
                                B, G, M, N, D, scale, s)
          : mha_bwd<DMAX>(qs, ks, vs, out, lse, ds, delta, part, chunks, dq, dkv, B, G,
                          M, N, D, scale, s));
}
