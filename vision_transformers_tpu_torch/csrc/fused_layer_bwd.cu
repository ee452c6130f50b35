// Backward of the pre-LN attention residual branch, float32, for Hopper
// (sm_90a):
//
//   z = x + r ⊙ OutProj(MHSA(QkvProj(LN(x))))
//
// Replaces the TPU (Pallas) kernels
//   vision_transformers_tpu/ops/fused_layer.py:183   _attn_layer_bwd_kernel
//   vision_transformers_tpu/ops/fused_attention.py:342   _qkv_bwd_kernel
//       (B3's backward: step 3 below alone, vtx_fused_attention_qkv_bwd)
//   vision_transformers_tpu/ops/fused_block.py:100   _blk_bwd_kernel
//       (B8's backward: steps 1-5 without the row scale and the LN,
//       vtx_fused_attention_block_bwd)
// and computes what it computes: dx, dln_scale, dln_bias, dwqkv, dbqkv,
// dwout, dbout and, when r needs a gradient, dr.  It reads the residuals the
// training forward (fused_layer.cu) saved: qkv [M, 3HD], the attention
// output acc [M, HD], the LN statistics mu / rstd [M] and the softmax
// log-sum-exp lse [B, H, N] (M = B·N rows).  One C entry,
// vtx_fused_attention_layer_bwd, is a fixed sequence of launches on the
// caller's stream, vtx::attention_half_bwd, which the whole layer's
// backward (fused_layer1_bwd.cu) runs as its second half:
//
//   1. da = r ⊙ dz;  dwout = accᵀ·da;  dbout = Σ_rows da
//   2. dacc₀ = dz·woutᵀ;  dr[b] = Σ_{n∈b}(Σ_k dacc₀⊙acc + Σ_c dz⊙bout)
//      (the reassociation of fused_layer.py:276-288);  dacc = r ⊙ dacc₀
//   3. attention backward, FlashAttention-2 style, no N×N matrix in device
//      memory: Δ = rowsum(dacc_h ⊙ acc_h); a key-tile pass recomputes
//      p = exp(q·kᵀ·s − lse) and accumulates dv += pᵀ·do, dk += dsᵀ·q·s with
//      ds = p ⊙ (do·vᵀ − Δ); a query-tile pass accumulates dq += ds·k·s.
//      Both write dqkv [M, 3HD] (q-heads | k-heads | v-heads).  With the
//      grouped additive bias extra [G, H, N, N] (Swin's in the whole
//      layer's backward, fused_layer1_bwd.cu; Twins' pair mask in this
//      entry's), p = exp(q·kᵀ·s + extra[g] − lse), and where the bias needs
//      a gradient the key-tile pass also stores ds [B, H, N, N] and
//      dextra[g] is the sum of ds over the group's rows in row order (3d):
//      the Pallas kernel's `dextra_ref[0, h] += ds` over its sequential
//      grid.
//   4. u = LN(x) recomputed from x, mu, rstd;  dwqkv = uᵀ·dqkv;
//      dbqkv = Σ_rows dqkv
//   5. dln = dqkv·wqkvᵀ
//   6. LN backward as _ln_bwd (fused_layer.py:79-87):
//      dx = dz + rstd·(dx̂ − mean(dx̂) − x̂·mean(dx̂⊙x̂)), dx̂ = dln ⊙ g;
//      dg = Σ_rows dln ⊙ x̂;  db = Σ_rows dln
//
// Determinism: every reduction over rows (the weight GEMMs' K = M sums, the
// bias / LN-parameter column sums, dr) is a fixed-order two-pass sum (split-K
// slabs or row chunks, then an ordered sum over them) or one block's fixed
// tree; there are no float atomics, so the gradients are bit-identical from
// run to run.
//
// What bounds it on this card.  The four projection GEMMs do 16·M·C·HD
// operations — about 2x the forward's projection work — and attention does
// 5 products of 2·B·H·N²·D (recomputed scores, dv, dp, dk, dq) — about 2.5x
// the forward's attention work; at ViT-S/16 (C = HD = 384, N = 197) the
// GEMMs are ~75% of it.  All of it runs as plain f32 FMAs (no tensor cores):
// the bound is the f32 FMA rate, 67 TFLOP/s at 700 W.  The attention
// kernels hold a head zero-padded to 64 in registers (ViT: D = 64); with the
// bias (Swin: D = 32) a 32-wide instantiation runs, and wider heads are
// refused.  The GEMMs reuse the
// forward's tiled FMA GEMM, reading accᵀ, uᵀ, woutᵀ and wqkvᵀ through
// strides; the attention kernels hold one key (or query) per thread with its
// accumulators in registers and stream the other side through shared memory,
// in d-outer passes that keep nothing else live across a tile.
//
// What later work changes: wgmma on bf16 operands with TMA-fed shared-memory
// rings, bf16 storage of the saved residuals, and fusing the launches (the
// LN backward into the dln GEMM's epilogue, Δ into the attention passes, the
// column sums into the weight GEMMs).

#include "common.cuh"

namespace {

// 3a. Δ[b, h, n] = rowsum(dacc_h ⊙ acc_h): common.cuh's attn_delta_kernel

// ---------------------------------------------------------------------------
// 3b. key-tile pass: dk, dv.  Grid (key tiles, H, B); one key per thread,
//     its dk / dv accumulators in registers, its k / v rows in (padded)
//     shared memory; query tiles of q, do, lse, Δ streamed through shared
//     memory and read by every thread (broadcast).  Per query tile, two
//     d-outer passes: the scores and do·v of all BQ queries (k[d], v[d]
//     read once per d), then the dk / dv updates — so no row but the
//     accumulators stays in registers.
//     DH: the register width of a head (32 or 64 ≥ D, zero-padded).
//     HAS_EXTRA: the scores carry the additive bias extra[g, h] of the
//     row's group g = b / rows_per_group (read straight from device memory:
//     neighbouring threads are neighbouring keys), and, when ds_out is
//     non-null, dS = p ⊙ (dP − Δ) of every (query, key) pair is stored to
//     ds_out [B, H, N, N] for the ordered sum over the group's rows (3d).
//     CYCLIC: B9's sample-major pairs, row b in group b mod rows_per_group
//     (the argument is then the group count), as in fused_layer.cu.
// ---------------------------------------------------------------------------

constexpr int BK = 64;   // keys per block = threads per block
constexpr int BQ = 16;   // queries per shared-memory tile

template <int DH, bool HAS_EXTRA, bool CYCLIC>
__global__ void __launch_bounds__(BK)
attn_bwd_dkdv_kernel(const float* __restrict__ qkv, const float* __restrict__ dacc,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ extra, int rows_per_group,
                     float* __restrict__ ds_out, float* __restrict__ dqkv, int N,
                     int H, int D, float scale) {
  __shared__ float Ks[BK][DH + 1];  // +1: thread t reads row t, bank-free
  __shared__ float Vs[BK][DH + 1];
  __shared__ float Qs[BQ][DH];
  __shared__ float dOs[BQ][DH];
  __shared__ float Ls[BQ], Ds[BQ];
  const int b = blockIdx.z, h = blockIdx.y, t = threadIdx.x;
  const int HD = H * D;
  const long long row_stride = 3LL * HD;
  const float* base = qkv + (long long)b * N * row_stride;
  const float* dbase = dacc + (long long)b * N * HD;
  const float* lbase = lse + ((long long)b * H + h) * N;
  const float* delbase = delta + ((long long)b * H + h) * N;
  const int k0 = blockIdx.x * BK;
  const int kj = k0 + t;
  const long long NN = (long long)N * N;
  const int group = CYCLIC ? b % rows_per_group : b / rows_per_group;
  const float* ebase = HAS_EXTRA ? extra + ((long long)group * H + h) * NN : nullptr;
  float* dsbase = (HAS_EXTRA && ds_out) ? ds_out + ((long long)b * H + h) * NN : nullptr;

  for (int idx = t; idx < BK * DH; idx += BK) {
    const int j = idx / DH, d = idx % DH;
    const bool ok = k0 + j < N && d < D;
    const float* rowp = base + (long long)(k0 + j) * row_stride + h * D + d;
    Ks[j][d] = ok ? rowp[HD] : 0.f;
    Vs[j][d] = ok ? rowp[2 * HD] : 0.f;
  }

  float dk[DH], dv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) dk[d] = dv[d] = 0.f;

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // Ks / Vs written, or the last tile fully read
    for (int idx = t; idx < BQ * DH; idx += BK) {
      const int i = idx / DH, d = idx % DH;
      const bool ok = q0 + i < N && d < D;
      Qs[i][d] = ok ? base[(long long)(q0 + i) * row_stride + h * D + d] : 0.f;
      dOs[i][d] = ok ? dbase[(long long)(q0 + i) * HD + h * D + d] : 0.f;
    }
    if (t < BQ) {
      const bool ok = q0 + t < N;
      Ls[t] = ok ? lbase[q0 + t] : INFINITY;  // p = exp(-inf) = 0 for padding
      Ds[t] = ok ? delbase[q0 + t] : 0.f;
    }
    __syncthreads();
    float p[BQ], ds[BQ];  // the scores and do·v, then p and dS
    key_thread_dots<DH, BQ>(Qs, dOs, Ks[t], Vs[t], p, ds);
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      if (HAS_EXTRA) {
        const bool ok = q0 + i < N && kj < N;
        const float e = ok ? ebase[(long long)(q0 + i) * N + kj] : 0.f;
        p[i] = expf(p[i] * scale + e - Ls[i]);
        ds[i] = p[i] * (ds[i] - Ds[i]);
        if (dsbase && ok) dsbase[(long long)(q0 + i) * N + kj] = ds[i];
      } else {
        p[i] = expf(p[i] * scale - Ls[i]);
        ds[i] = p[i] * (ds[i] - Ds[i]);
      }
    }
    key_thread_accumulate<DH, BQ>(Qs, dOs, p, ds, dk, dv);
  }

  if (kj < N) {
    float* row = dqkv + ((long long)b * N + kj) * row_stride + h * D;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if (d < D) {
        row[HD + d] = dk[d] * scale;
        row[2 * HD + d] = dv[d];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3c. query-tile pass: dq.  Grid (query tiles, H, B); one query per thread,
//     its dq accumulator in registers, its q and do rows in (padded) shared
//     memory; key tiles of k and v streamed through shared memory
//     (broadcast).  Per key tile, two d-outer passes as in 3b: the scores
//     and do·v of all BKV keys, then the dq update.  With HAS_EXTRA the
//     bias tile [BQQ, BKV] is staged in shared memory (loaded along keys).
// ---------------------------------------------------------------------------

constexpr int BQQ = 64;  // queries per block = threads per block
constexpr int BKV = 16;  // keys per shared-memory tile

template <int DH, bool HAS_EXTRA, bool CYCLIC>
__global__ void __launch_bounds__(BQQ)
attn_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dacc,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const float* __restrict__ extra, int rows_per_group,
                   float* __restrict__ dqkv, int N, int H, int D, float scale) {
  __shared__ float Qs[BQQ][DH + 1];   // +1: thread t reads row t, bank-free
  __shared__ float dOs[BQQ][DH + 1];
  __shared__ float Ks[BKV][DH];
  __shared__ float Vs[BKV][DH];
  __shared__ float Es[HAS_EXTRA ? BQQ : 1][BKV + 1];
  const int b = blockIdx.z, h = blockIdx.y, t = threadIdx.x;
  const int HD = H * D;
  const long long row_stride = 3LL * HD;
  const float* base = qkv + (long long)b * N * row_stride;
  const float* dbase = dacc + (long long)b * N * HD;
  const int q0 = blockIdx.x * BQQ;
  const int qi = q0 + t;
  const int group = CYCLIC ? b % rows_per_group : b / rows_per_group;
  const float* ebase = HAS_EXTRA ? extra + ((long long)group * H + h) * N * N : nullptr;

  for (int idx = t; idx < BQQ * DH; idx += BQQ) {
    const int i = idx / DH, d = idx % DH;
    const bool ok = q0 + i < N && d < D;
    Qs[i][d] = ok ? base[(long long)(q0 + i) * row_stride + h * D + d] : 0.f;
    dOs[i][d] = ok ? dbase[(long long)(q0 + i) * HD + h * D + d] : 0.f;
  }
  float dq[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) dq[d] = 0.f;
  const long long lrow = ((long long)b * H + h) * N + qi;
  const float l = qi < N ? lse[lrow] : 0.f;
  const float dl = qi < N ? delta[lrow] : 0.f;

  for (int k0 = 0; k0 < N; k0 += BKV) {
    __syncthreads();  // Qs / dOs written, or the last tile fully read
    for (int idx = t; idx < BKV * DH; idx += BQQ) {
      const int j = idx / DH, d = idx % DH;
      const bool ok = k0 + j < N && d < D;
      const float* rowp = base + (long long)(k0 + j) * row_stride + h * D + d;
      Ks[j][d] = ok ? rowp[HD] : 0.f;
      Vs[j][d] = ok ? rowp[2 * HD] : 0.f;
    }
    if (HAS_EXTRA) {
      for (int idx = t; idx < BQQ * BKV; idx += BQQ) {
        const int i = idx / BKV, j = idx % BKV;
        const bool ok = q0 + i < N && k0 + j < N;
        Es[i][j] = ok ? ebase[(long long)(q0 + i) * N + k0 + j] : 0.f;
      }
    }
    __syncthreads();
    float p[BKV], ds[BKV];  // the scores and do·v, then p and dS
    query_thread_dots<DH, BKV>(Qs[t], dOs[t], Ks, Vs, p, ds);
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      if (HAS_EXTRA)
        p[j] = (k0 + j < N) ? expf(p[j] * scale + Es[t][j] - l) : 0.f;
      else
        p[j] = (k0 + j < N) ? expf(p[j] * scale - l) : 0.f;
      ds[j] = p[j] * (ds[j] - dl);
    }
    query_thread_accumulate<DH, BKV>(Ks, ds, dq);
  }

  if (qi < N) {
    float* row = dqkv + ((long long)b * N + qi) * row_stride + h * D;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < D) row[d] = dq[d] * scale;
  }
}

// ---------------------------------------------------------------------------
// 3d. dextra[g, h, q, k] = Σ_{r < R} ds[g·R + r, h, q, k], R = B / G rows
//     per group, summed in r order (one thread per output element); CYCLIC
//     (B9): Σ_{r < R} ds[r·G + g, h, q, k] over the R = B / G samples, in
//     sample order.
// ---------------------------------------------------------------------------

template <bool CYCLIC>
__global__ void __launch_bounds__(EW_THREADS)
group_sum_kernel(const float* __restrict__ ds, int R, long long per_row,
                 long long total, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (e >= total) return;
  const long long g = e / per_row, rem = e % per_row;
  // total = G·per_row: the stride from one sample's pair g to the next's
  const float* src = ds + (CYCLIC ? g : g * R) * per_row + rem;
  const long long step = CYCLIC ? total : per_row;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += src[(long long)r * step];
  out[e] = s;
}

template <int DH, bool HAS_EXTRA, bool CYCLIC = false>
cudaError_t launch_attn_bwd(const float* qkv, const float* dacc, const float* lse,
                            const float* delta, const float* extra,
                            int rows_per_group, float* dsbuf, float* dqkv, int B,
                            int N, int H, int D, float scale, cudaStream_t s) {
  attn_bwd_dkdv_kernel<DH, HAS_EXTRA, CYCLIC><<<dim3(cdiv(N, BK), H, B), BK, 0, s>>>(
      qkv, dacc, lse, delta, extra, rows_per_group, dsbuf, dqkv, N, H, D, scale);
  VTX_CHECK(cudaGetLastError());
  attn_bwd_dq_kernel<DH, HAS_EXTRA, CYCLIC><<<dim3(cdiv(N, BQQ), H, B), BQQ, 0, s>>>(
      qkv, dacc, lse, delta, extra, rows_per_group, dqkv, N, H, D, scale);
  return cudaGetLastError();
}

// 3a-3d: Δ, the key-tile and query-tile passes and, when dextra is
// non-null (with extra), dS into dsbuf [B, H, N, N] and its ordered sum over
// each group's rows into dextra [G, H, N, N].  The forward's instantiations
// (fused_layer.cu::launch_attention): heads up to 64 wide, up to 32 with
// the bias.
cudaError_t attention_core_bwd(const float* qkv, const float* dacc,
                               const float* acc, const float* lse,
                               const float* extra, int groups, float* delta,
                               float* dsbuf, float* dqkv, float* dextra, int B,
                               int N, int H, int D, float scale, cudaStream_t s) {
  if (D < 1 || D > DMAX || N < 1 || B < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (extra && (D > EXTRA_DMAX || groups < 1 || B % groups)) return cudaErrorInvalidValue;
  const int rows_per_group = extra ? B / groups : 1;
  float* ds_out = (extra && dextra) ? dsbuf : nullptr;
  attn_delta_kernel<<<ew_blocks((long long)B * H * N), EW_THREADS, 0, s>>>(
      dacc, acc, delta, B, N, H, D);
  VTX_CHECK(cudaGetLastError());
  const cudaError_t attn_err =
      extra ? launch_attn_bwd<EXTRA_DMAX, true>(qkv, dacc, lse, delta, extra,
                                                rows_per_group, ds_out, dqkv, B, N,
                                                H, D, scale, s)
            : launch_attn_bwd<DMAX, false>(qkv, dacc, lse, delta, nullptr, 1,
                                           nullptr, dqkv, B, N, H, D, scale, s);
  VTX_CHECK(attn_err);
  if (ds_out) {
    const long long per_row = (long long)H * N * N;
    const long long total = (long long)groups * per_row;
    group_sum_kernel<false><<<ew_blocks(total), EW_THREADS, 0, s>>>(
        ds_out, rows_per_group, per_row, total, dextra);
    VTX_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

// Steps 4-5 on the projection's input a [M, C]: dwqkv = aᵀ·dqkv (split-K
// slabs summed in order); dbqkv = Σ_rows dqkv (when non-null); da =
// dqkv·wqkvᵀ
cudaError_t qkv_in_bwd(const float* a, const float* wqkv, long long wqkv_s0,
                       long long wqkv_s1, const float* dqkv, float* wpart, int splits_qkv,
                       float* cpart, float* dwqkv, long long dwqkv_s0, long long dwqkv_s1,
                       float* dbqkv, float* da, int M, int C, int HD, cudaStream_t s) {
  VTX_CHECK(launch_gemm_splitk(a, C, dqkv, 3 * HD, 1, wpart, splits_qkv, dwqkv,
                               dwqkv_s0, dwqkv_s1, C, 3 * HD, M, s));
  if (dbqkv)
    VTX_CHECK(launch_colsum(dqkv, nullptr, nullptr, nullptr, cpart, dbqkv, M,
                            3 * HD, s));
  return launch_gemm(dqkv, wqkv, wqkv_s1, wqkv_s0, nullptr, nullptr, 1, nullptr, da, M,
                     C, 3 * HD, 0, s);
}

}  // namespace

// B9's attention backward (common.cuh): 3a-3d on the P = B·G sample-major
// pairs, pair p taking extra[p mod groups], dextra[g] summed over the
// samples in order
cudaError_t vtx::window_attention_bwd(const float* qkv, const float* dacc,
                                      const float* acc, const float* lse,
                                      const float* extra, int groups, float* delta,
                                      float* dsbuf, float* dqkv, float* dextra, int P,
                                      int N, int H, int D, float scale, cudaStream_t s) {
  if (!extra || D < 1 || D > EXTRA_DMAX || N < 1 || P < 1 || P > 65535 || H > 65535 ||
      groups < 1 || P % groups)
    return cudaErrorInvalidValue;
  float* ds_out = dextra ? dsbuf : nullptr;
  attn_delta_kernel<<<ew_blocks((long long)P * H * N), EW_THREADS, 0, s>>>(
      dacc, acc, delta, P, N, H, D);
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK((launch_attn_bwd<EXTRA_DMAX, true, true>(qkv, dacc, lse, delta, extra, groups,
                                                     ds_out, dqkv, P, N, H, D, scale, s)));
  if (ds_out) {
    const long long per_row = (long long)H * N * N;
    const long long total = (long long)groups * per_row;
    group_sum_kernel<true><<<ew_blocks(total), EW_THREADS, 0, s>>>(
        ds_out, P / groups, per_row, total, dextra);
    VTX_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

// Steps 1-2: da = rs ⊙ dz; dwout = accᵀ·da; dbout = Σ_rows da; dacc₀ =
// dz·woutᵀ; dr; dacc = rs ⊙ dacc₀ (rows_per_scale rows per sample)
cudaError_t vtx::out_proj_bwd(
    const float* acc, const float* wout, long long wout_s0, long long wout_s1,
    const float* bout, const float* rs, int rows_per_scale, const float* dz,
    float* da, float* dacc, float* wpart, int splits_out, float* cpart,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, int B, int M, int C, int HD, cudaStream_t s) {
  if (B > 65535) return cudaErrorInvalidValue;
  const float* dA = dz;
  if (rs) {
    scale_rows_kernel<<<ew_blocks((long long)M * C), EW_THREADS, 0, s>>>(
        dz, rs, rows_per_scale, C, (long long)M * C, da);
    VTX_CHECK(cudaGetLastError());
    dA = da;
  }
  VTX_CHECK(launch_gemm_splitk(acc, HD, dA, C, 1, wpart, splits_out, dwout,
                               dwout_s0, dwout_s1, HD, C, M, s));
  if (dbout) VTX_CHECK(launch_colsum(dA, nullptr, nullptr, nullptr, cpart, dbout, M, C, s));
  VTX_CHECK(launch_gemm(dz, wout, wout_s1, wout_s0, nullptr, nullptr, 1, nullptr,
                        dacc, M, HD, C, 0, s));
  if (rs) {
    row_scale_grad_kernel<<<B, DRS_THREADS, 0, s>>>(dacc, acc, dz, bout, rs, drs,
                                                    rows_per_scale, HD, C);
    VTX_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

// Steps 4-6: u from the saved statistics; dwqkv = uᵀ·dqkv; dbqkv = Σ_rows
// dqkv; dln = dqkv·wqkvᵀ; the LN backward with the residual dz; dg = Σ_rows
// dln ⊙ x̂; db = Σ_rows dln
cudaError_t vtx::qkv_proj_bwd(
    const float* x, const float* ln_g, const float* ln_b, const float* mu,
    const float* rstd, const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* dqkv, const float* dz, float* u, float* dln, float* wpart,
    int splits_qkv, float* cpart, float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv, int M,
    int C, int HD, cudaStream_t s) {
  ln_apply_kernel<false><<<ew_blocks((long long)M * C), EW_THREADS, 0, s>>>(
      x, mu, rstd, ln_g, ln_b, u, C, (long long)M * C, MapRows{nullptr, 1});
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK(qkv_in_bwd(u, wqkv, wqkv_s0, wqkv_s1, dqkv, wpart, splits_qkv, cpart, dwqkv,
                       dwqkv_s0, dwqkv_s1, dbqkv, dln, M, C, HD, s));
  ln_bwd_rows_kernel<false><<<cdiv(M, LN_THREADS / 32), LN_THREADS, 0, s>>>(
      dln, x, mu, rstd, ln_g, dz, dx, M, C, MapRows{nullptr, 1});
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK(launch_colsum(dln, x, mu, rstd, cpart, dg, M, C, s));
  VTX_CHECK(launch_colsum(dln, nullptr, nullptr, nullptr, cpart, db, M, C, s));
  return cudaSuccess;
}

// z = x + r ⊙ OutProj(MHSA(QkvProj(LN(x)) + extra)) backward, steps 1-6
// above.  extra [G, H, N, N] (row b in group b / (B/G)) may be null; with
// it and a non-null dextra, dsbuf [B, H, N, N] takes dS and dextra
// [G, H, N, N] its ordered sum over each group's rows.
cudaError_t vtx::attention_half_bwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* rs, const float* extra, int groups, const float* qkv,
    const float* acc, const float* mu, const float* rstd, const float* lse,
    const float* dz, float* da, float* dacc, float* delta, float* dqkv, float* u,
    float* dln, float* dsbuf, float* wpart, int splits_out, int splits_qkv,
    float* cpart, float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, float* dextra, int B, int N, int C, int H, int D, float scale,
    cudaStream_t s) {
  const int M = B * N, HD = H * D;
  if (D > DMAX || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  if (extra && (D > EXTRA_DMAX || groups < 1 || B % groups)) return cudaErrorInvalidValue;

  // 1-2. the out projection
  VTX_CHECK(vtx::out_proj_bwd(acc, wout, wout_s0, wout_s1, bout, rs, N, dz, da,
                              dacc, wpart, splits_out, cpart, dwout, dwout_s0,
                              dwout_s1, dbout, drs, B, M, C, HD, s));

  // 3. attention backward → dqkv (and dS → dextra)
  VTX_CHECK(attention_core_bwd(qkv, dacc, acc, lse, extra, groups, delta, dsbuf, dqkv,
                               dextra, B, N, H, D, scale, s));

  // 4-6. the qkv projection and LN
  return vtx::qkv_proj_bwd(x, ln_g, ln_b, mu, rstd, wqkv, wqkv_s0, wqkv_s1, dqkv,
                           dz, u, dln, wpart, splits_qkv, cpart, dx, dg, db,
                           dwqkv, dwqkv_s0, dwqkv_s1, dbqkv, M, C, HD, s);
}

// Returns the first cudaError_t met (0 = success).  Workspace, all
// allocated by the caller: da [M, C] (used only with rs), dacc [M, HD],
// delta [B·H·N], dqkv [M, 3HD], u [M, C], dln [M, C], dsbuf [B, H, N, N]
// (used only with dextra), wpart [max(splits_out·HD·C, splits_qkv·C·3HD)],
// cpart [ceil(M / 128) · max(C, 3HD)].  dwqkv / dwout are written through
// their (row, col) strides, so they may share the layout of the weight view
// the forward read; bqkv / bout / rs / dbqkv / dbout / drs may be null, and
// so may extra [G, H, N, N] (groups = G; heads up to 32 wide) and its
// gradient dextra [G, H, N, N] (null when the bias needs none).
extern "C" int vtx_fused_attention_layer_bwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* extra, int groups,
    const float* rs, const float* qkv, const float* acc, const float* mu,
    const float* rstd, const float* lse, const float* dz,
    float* da, float* dacc, float* delta, float* dqkv, float* u, float* dln,
    float* dsbuf, float* wpart, int splits_out, int splits_qkv, float* cpart,
    float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, float* dextra, int B, int N, int C, int H, int D, float scale,
    void* stream) {
  return static_cast<int>(vtx::attention_half_bwd(
      x, ln_g, ln_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout,
      rs, extra, groups, qkv, acc, mu, rstd, lse, dz, da, dacc, delta, dqkv, u, dln,
      dsbuf, wpart, splits_out, splits_qkv, cpart, dx, dg, db, dwqkv, dwqkv_s0,
      dwqkv_s1, dbqkv, dwout, dwout_s0, dwout_s1, dbout, drs, dextra, B, N, C, H,
      D, scale, static_cast<cudaStream_t>(stream)));
}

// B3's backward (vision_transformers_tpu/ops/fused_attention.py:342,
// _qkv_bwd_kernel): steps 3a-3d alone on the packed projection.  qkv
// [B, N, 3·H·D], the forward's out [B, N, H·D] and lse [B, H, N], dout
// [B, N, H·D]; writes dqkv [B, N, 3·H·D] (q-heads | k-heads | v-heads) in
// the layout of qkv.  Workspace delta [B·H·N] and, with extra and a
// non-null dextra [G, H, N, N], dsbuf [B, H, N, N]: dextra[g] is the sum
// of dS over the group's rows in row order (no float atomics, so it is
// bit-identical from run to run).  extra / dsbuf / dextra may be null.
extern "C" int vtx_fused_attention_qkv_bwd(
    const float* qkv, const float* extra, int groups, const float* out,
    const float* lse, const float* dout, float* delta, float* dsbuf, float* dqkv,
    float* dextra, int B, int N, int H, int D, float scale, void* stream) {
  return static_cast<int>(attention_core_bwd(
      qkv, dout, out, lse, extra, groups, delta, dsbuf, dqkv, dextra, B, N, H, D,
      scale, static_cast<cudaStream_t>(stream)));
}

// B8's backward (vision_transformers_tpu/ops/fused_block.py:100,
// _blk_bwd_kernel): out = OutProj(MHSA(x·Wqkv + bqkv + extra)) + bout, x
// [B, N, C], out [B, N, Cout].  Reads the forward's saves qkv [B, N, 3·H·D],
// acc [B, N, H·D] and lse [B, H, N] and dout [B, N, Cout]:
//   1-2. dwout = accᵀ·dout and dbout = Σ_rows dout (split-K slabs and row
//        chunks summed in order); dacc = dout·woutᵀ
//   3.   the attention backward → dqkv, and with extra and a non-null dextra
//        dS into dsbuf [B, H, N, N], summed over each group's rows in row
//        order into dextra [G, H, N, N]
//   4-5. dwqkv = xᵀ·dqkv, dbqkv = Σ_rows dqkv, dx = dqkv·wqkvᵀ
// Workspace, all allocated by the caller: dacc [B·N, H·D], delta [B·H·N],
// dqkv [B·N, 3·H·D], dsbuf (with dextra), wpart [max(splits_out·HD·Cout,
// splits_qkv·C·3HD)], cpart [ceil(B·N / 128) · max(Cout, 3HD)].  The weight
// gradients are written through their (row, col) strides; dbqkv, dbout
// (null where the bias is absent), extra, dsbuf and dextra may be null.  No
// float atomics, so the gradients are bit-identical from run to run.
extern "C" int vtx_fused_attention_block_bwd(
    const float* x, const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* wout, long long wout_s0, long long wout_s1, const float* extra,
    int groups, const float* qkv, const float* acc, const float* lse,
    const float* dout, float* dacc, float* delta, float* dqkv, float* dsbuf,
    float* wpart, int splits_out, int splits_qkv, float* cpart, float* dx,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* dextra, int B, int N, int C, int H, int D, int Cout, float scale,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N, HD = H * D;
  if (B < 1 || N < 1 || (long long)B * N > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  VTX_CHECK(vtx::out_proj_bwd(acc, wout, wout_s0, wout_s1, nullptr, nullptr, N, dout,
                              nullptr, dacc, wpart, splits_out, cpart, dwout, dwout_s0,
                              dwout_s1, dbout, nullptr, B, M, Cout, HD, s));
  VTX_CHECK(attention_core_bwd(qkv, dacc, acc, lse, extra, groups, delta, dsbuf, dqkv,
                               dextra, B, N, H, D, scale, s));
  return static_cast<int>(qkv_in_bwd(x, wqkv, wqkv_s0, wqkv_s1, dqkv, wpart, splits_qkv,
                                     cpart, dwqkv, dwqkv_s0, dwqkv_s1, dbqkv, dx, M, C,
                                     HD, s));
}
