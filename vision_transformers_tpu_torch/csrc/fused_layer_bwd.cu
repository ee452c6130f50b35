// Backward of the pre-LN attention residual branch, float32, for Hopper
// (sm_90a):
//
//   z = x + r ⊙ OutProj(MHSA(QkvProj(LN(x))))
//
// Replaces the TPU (Pallas) kernels
//   vision_transformers_tpu/ops/fused_layer.py:183   _attn_layer_bwd_kernel
// (B8's backward, fused_attention_qkv.cu, runs steps 1-2 and 4-5 below
// around the tensor-core attention's backward)
// and computes what it computes: dx, dln_scale, dln_bias, dwqkv, dbqkv,
// dwout, dbout and, when r needs a gradient, dr.  It reads the residuals the
// training forward (fused_layer.cu) saved: qkv [M, 3HD], the attention
// output acc [M, HD], the LN statistics mu / rstd [M] and the softmax
// log-sum-exp lse [B, H, N] (M = B·N rows).  One C entry,
// vtx_fused_attention_layer_bwd, is a fixed sequence of launches on the
// caller's stream, vtx::attention_half_bwd, which the whole layer's
// backward (fused_layer1_bwd.cu) runs as its second half:
//
//   1. dwout = accᵀ·(r ⊙ dz) (r applied as the GEMM stages dz);
//      dbout = Σ_rows r ⊙ dz
//   2. dacc₀ = dz·woutᵀ;  dr[b] = Σ_{n∈b}(Σ_k dacc₀⊙acc + Σ_c dz⊙bout)
//      (the reassociation of fused_layer.py:276-288);  dacc = r ⊙ dacc₀
//   3. attention backward, FlashAttention-2 style, no N×N matrix in device
//      memory: Δ = rowsum(dacc_h ⊙ acc_h); a key-tile pass recomputes
//      p = exp(q·kᵀ·s − lse) and accumulates dv += pᵀ·do, dk += dsᵀ·q·s with
//      ds = p ⊙ (do·vᵀ − Δ); a query-tile pass accumulates dq += ds·k·s.
//      Both write dqkv [M, 3HD] (q-heads | k-heads | v-heads).  With the
//      grouped additive bias extra [G, H, N, N] (Swin's in the whole
//      layer's backward, fused_layer1_bwd.cu; Twins' pair mask in this
//      entry's), p = exp(q·kᵀ·s + extra[g] − lse) on the window attention
//      (window_attention_tc.cuh), and where the bias needs a gradient
//      dextra[g] is the sum of ds over the group's rows: per block over a
//      chunk of them in row order, then over the chunks in order — the
//      Pallas kernel's `dextra_ref[0, h] += ds` over its sequential grid,
//      regrouped.
//   4. dwqkv = LN(x)ᵀ·dqkv, the LN applied from x, mu, rstd as the GEMM
//      stages x (never written);  dbqkv = Σ_rows dqkv
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
// GEMMs are ~75% of it.  The GEMMs run on the GEMM core (gemm_tc.cu, 3xTF32
// on wgmma, bound at 165 TFLOP/s f32-accurate at 700 W), reading accᵀ, uᵀ,
// woutᵀ and wqkvᵀ through strides.  With the bias (Twins' pair mask, Swin's
// grouped bias: N ≤ 128, heads up to 32 wide) the attention backward is the
// tensor-core window attention's (window_attention_tc.cuh, 3xTF32 on
// mma.sync, bound at the same 165 TFLOP/s): one pass per window computing
// Δ, dq, dk and dv straight into dqkv, and dextra as per-block register
// sums over a chunk of each group's windows, summed over the chunks in
// order — no [B, H, N, N] dS buffer.  Without one (ViT: D = 64) it stays on
// plain f32 FMAs (67 TFLOP/s): the kernels hold a head zero-padded to 64
// in registers, one key (or query) per thread with its accumulators, and
// stream the other side through shared memory, in d-outer passes that keep
// nothing else live across a tile.
//
// What later work changes: ViT's attention onto the tensor cores, bf16
// storage of the saved residuals, and fusing the launches (the LN backward
// into the dln GEMM's epilogue, Δ into the attention passes, the column
// sums into the weight GEMMs).

#include "window_attention_tc.cuh"

namespace {

// ViT's attention backward (no bias), 3a-3c below; with a bias the
// attention backward is window_attention_tc.cuh's (wta::attention_bwd).
//
// 3a. Δ[b, h, n] = rowsum(dacc_h ⊙ acc_h): common.cuh's attn_delta_kernel

// ---------------------------------------------------------------------------
// 3b. key-tile pass: dk, dv.  Grid (key tiles, H, B); one key per thread,
//     its dk / dv accumulators in registers, its k / v rows in (padded)
//     shared memory; query tiles of q, do, lse, Δ streamed through shared
//     memory and read by every thread (broadcast).  Per query tile, two
//     d-outer passes: the scores and do·v of all BQ queries (k[d], v[d]
//     read once per d), then the dk / dv updates — so no row but the
//     accumulators stays in registers.
//     DH: the register width of a head (≥ D, zero-padded).
// ---------------------------------------------------------------------------

constexpr int BK = 64;   // keys per block = threads per block
constexpr int BQ = 16;   // queries per shared-memory tile

template <int DH>
__global__ void __launch_bounds__(BK)
attn_bwd_dkdv_kernel(const float* __restrict__ qkv, const float* __restrict__ dacc,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dqkv, int N, int H, int D, float scale) {
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
      p[i] = expf(p[i] * scale - Ls[i]);
      ds[i] = p[i] * (ds[i] - Ds[i]);
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
//     and do·v of all BKV keys, then the dq update.
// ---------------------------------------------------------------------------

constexpr int BQQ = 64;  // queries per block = threads per block
constexpr int BKV = 16;  // keys per shared-memory tile

template <int DH>
__global__ void __launch_bounds__(BQQ)
attn_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dacc,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dqkv, int N, int H, int D, float scale) {
  __shared__ float Qs[BQQ][DH + 1];   // +1: thread t reads row t, bank-free
  __shared__ float dOs[BQQ][DH + 1];
  __shared__ float Ks[BKV][DH];
  __shared__ float Vs[BKV][DH];
  const int b = blockIdx.z, h = blockIdx.y, t = threadIdx.x;
  const int HD = H * D;
  const long long row_stride = 3LL * HD;
  const float* base = qkv + (long long)b * N * row_stride;
  const float* dbase = dacc + (long long)b * N * HD;
  const int q0 = blockIdx.x * BQQ;
  const int qi = q0 + t;

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
    __syncthreads();
    float p[BKV], ds[BKV];  // the scores and do·v, then p and dS
    query_thread_dots<DH, BKV>(Qs[t], dOs[t], Ks, Vs, p, ds);
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
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

// Step 3 → dqkv.  With the bias extra [G, H, N, N] (row b in group b /
// (B/G)): the window attention's backward (N ≤ 128, heads up to 32 wide),
// which computes Δ itself and, when dextra is non-null, sums dS per block
// into dbpart [wta::bwd_chunks(B, G, H), G, H, N, N] and those partials in
// order into dextra [G, H, N, N].  Without: Δ into delta [B, H, N], then the
// key-tile and query-tile passes (heads up to 64 wide).
cudaError_t attention_core_bwd(const float* qkv, const float* dacc,
                               const float* acc, const float* lse,
                               const float* extra, int groups, float* delta,
                               float* dbpart, float* dqkv, float* dextra, int B,
                               int N, int H, int D, float scale, cudaStream_t s) {
  if (extra)
    return wta::attention_bwd(qkv, acc, dacc, lse, extra, groups, false, dqkv, dbpart,
                              dextra, B, N, H, D, scale, s);
  if (D < 1 || D > DMAX || N < 1 || B < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  attn_delta_kernel<<<ew_blocks((long long)B * H * N), EW_THREADS, 0, s>>>(
      dacc, acc, delta, B, N, H, D);
  VTX_CHECK(cudaGetLastError());
  attn_bwd_dkdv_kernel<DMAX><<<dim3(cdiv(N, BK), H, B), BK, 0, s>>>(
      qkv, dacc, lse, delta, dqkv, N, H, D, scale);
  VTX_CHECK(cudaGetLastError());
  attn_bwd_dq_kernel<DMAX><<<dim3(cdiv(N, BQQ), H, B), BQQ, 0, s>>>(
      qkv, dacc, lse, delta, dqkv, N, H, D, scale);
  return cudaGetLastError();
}

}  // namespace

// B9's attention backward (common.cuh): the window attention's on the
// P = B·G sample-major pairs, pair p taking extra[p mod groups]
cudaError_t vtx::window_attention_bwd(const float* qkv, const float* dacc,
                                      const float* acc, const float* lse,
                                      const float* extra, int groups, float* dbpart,
                                      float* dqkv, float* dextra, int P, int N, int H,
                                      int D, float scale, cudaStream_t s) {
  return wta::attention_bwd(qkv, acc, dacc, lse, extra, groups, true, dqkv, dbpart, dextra,
                            P, N, H, D, scale, s);
}

// The window attention's backward alone (ops/window_attention.py): dqkv
// [P·N, 3·H·D] from qkv, the forward's out and lse and dout [P·N, H·D]; with
// dbias [G, H, N, N] non-null, the blocks' dS sums in dbpart
// [wta::bwd_chunks(P, G, H), G, H, N, N] and their ordered sum in dbias
extern "C" int vtx_window_attention_bwd(const float* qkv, const float* out,
                                        const float* dout, const float* lse,
                                        const float* bias, int groups, int cyclic,
                                        float* dqkv, float* dbpart, float* dbias, int P,
                                        int N, int H, int D, float scale, void* stream) {
  return static_cast<int>(wta::attention_bwd(qkv, out, dout, lse, bias, groups,
                                             cyclic != 0, dqkv, dbpart, dbias, P, N, H, D,
                                             scale, static_cast<cudaStream_t>(stream)));
}

// Steps 1-2: dwout = accᵀ·(rs ⊙ dz); dbout = Σ_rows rs ⊙ dz; dacc₀ =
// dz·woutᵀ; dr; dacc = rs ⊙ dacc₀ (rows_per_scale rows per sample)
cudaError_t vtx::out_proj_bwd(
    const float* acc, const float* wout, long long wout_s0, long long wout_s1,
    const float* bout, const float* rs, int rows_per_scale, const float* dz,
    float* dacc, float* wpart, int splits_out, float* cpart,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, int B, int M, int C, int HD, cudaStream_t s) {
  if (B > 65535) return cudaErrorInvalidValue;
  // rs staged on dz where dz's tiles meet few output tiles, else rs ⊙ dz
  // into dacc (written below; [M, HD], so where HD ≥ C)
  GemmExtra x;
  const float* b = dz;
  if (rs && (gemm_row_tiles(HD) <= STAGE_TILES || HD < C)) {
    x.b_rs = rs;
    x.b_rs_rows = rows_per_scale;
  } else if (rs) {
    const long long MC = (long long)M * C;
    scale_rows_kernel<<<ew_blocks(MC), EW_THREADS, 0, s>>>(dz, rs, rows_per_scale, C, MC,
                                                           dacc);
    VTX_CHECK(cudaGetLastError());
    b = dacc;
  }
  VTX_CHECK(launch_gemm_splitk_x(acc, HD, b, C, 1, wpart, splits_out, dwout, dwout_s0,
                                 dwout_s1, HD, C, M, x, s));
  if (dbout)
    VTX_CHECK(launch_colsum(dz, nullptr, nullptr, nullptr, cpart, dbout, M, C, s,
                            MapRows{nullptr, 1}, rs, rows_per_scale));
  VTX_CHECK(launch_gemm(dz, wout, wout_s1, wout_s0, nullptr, nullptr, 1, nullptr,
                        dacc, M, HD, C, 0, s));
  if (rs) {
    row_scale_grad_kernel<<<B, DRS_THREADS, 0, s>>>(dacc, acc, dz, bout, rs, drs,
                                                    rows_per_scale, HD, C);
    VTX_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

// Steps 4-5 on the projection's input a [M, C]: dwqkv = xa(a)ᵀ·dqkv
// (split-K slabs summed in order); dbqkv = Σ_rows dqkv (when non-null); da =
// dqkv·wqkvᵀ
cudaError_t vtx::qkv_in_bwd(const float* a, const GemmExtra& xa, const float* wqkv,
                            long long wqkv_s0, long long wqkv_s1, const float* dqkv,
                            float* wpart, int splits_qkv, float* cpart, float* dwqkv,
                            long long dwqkv_s0, long long dwqkv_s1, float* dbqkv, float* da,
                            int M, int C, int HD, cudaStream_t s) {
  VTX_CHECK(launch_gemm_splitk_x(a, C, dqkv, 3 * HD, 1, wpart, splits_qkv, dwqkv, dwqkv_s0,
                                 dwqkv_s1, C, 3 * HD, M, xa, s));
  if (dbqkv)
    VTX_CHECK(launch_colsum(dqkv, nullptr, nullptr, nullptr, cpart, dbqkv, M,
                            3 * HD, s));
  return launch_gemm(dqkv, wqkv, wqkv_s1, wqkv_s0, nullptr, nullptr, 1, nullptr, da, M,
                     C, 3 * HD, 0, s);
}

// Steps 4-6: dwqkv = LN(x)ᵀ·dqkv (the LN applied from the saved statistics
// as the GEMM stages x); dbqkv = Σ_rows dqkv; dln = dqkv·wqkvᵀ; the LN
// backward with the residual dz; dg = Σ_rows dln ⊙ x̂; db = Σ_rows dln
cudaError_t vtx::qkv_proj_bwd(
    const float* x, const float* ln_g, const float* ln_b, const float* mu,
    const float* rstd, const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* dqkv, const float* dz, float* dln, float* wpart,
    int splits_qkv, float* cpart, float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv, int M,
    int C, int HD, cudaStream_t s) {
  // LN staged where x's tiles meet few output tiles, else LN(x) into dln
  // (written by the data gradient's GEMM after dwqkv's)
  GemmExtra ln;
  const float* a = x;
  if (gemm_col_tiles(3 * HD) <= STAGE_TILES) {
    ln.ln_mu = mu;
    ln.ln_rstd = rstd;
    ln.ln_g = ln_g;
    ln.ln_b = ln_b;
  } else {
    const long long MC = (long long)M * C;
    ln_apply_kernel<false><<<ew_blocks(MC), EW_THREADS, 0, s>>>(x, mu, rstd, ln_g, ln_b, dln,
                                                                C, MC, MapRows{nullptr, 1});
    VTX_CHECK(cudaGetLastError());
    a = dln;
  }
  VTX_CHECK(qkv_in_bwd(a, ln, wqkv, wqkv_s0, wqkv_s1, dqkv, wpart, splits_qkv, cpart, dwqkv,
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
// it and a non-null dextra, dbpart [wta::bwd_chunks(B, G, H), G, H, N, N]
// takes the window attention's per-block dS sums and dextra [G, H, N, N]
// their ordered sum.
cudaError_t vtx::attention_half_bwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* rs, const float* extra, int groups, const float* qkv,
    const float* acc, const float* mu, const float* rstd, const float* lse,
    const float* dz, float* dacc, float* delta, float* dqkv,
    float* dln, float* dbpart, float* wpart, int splits_out, int splits_qkv,
    float* cpart, float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, float* dextra, int B, int N, int C, int H, int D, float scale,
    cudaStream_t s) {
  const int M = B * N, HD = H * D;
  if (D > DMAX || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  if (extra && (D > EXTRA_DMAX || N > wta::NMAX || groups < 1 || B % groups))
    return cudaErrorInvalidValue;

  // 1-2. the out projection
  VTX_CHECK(vtx::out_proj_bwd(acc, wout, wout_s0, wout_s1, bout, rs, N, dz,
                              dacc, wpart, splits_out, cpart, dwout, dwout_s0,
                              dwout_s1, dbout, drs, B, M, C, HD, s));

  // 3. attention backward → dqkv (and dextra)
  VTX_CHECK(attention_core_bwd(qkv, dacc, acc, lse, extra, groups, delta, dbpart, dqkv,
                               dextra, B, N, H, D, scale, s));

  // 4-6. the qkv projection and LN
  return vtx::qkv_proj_bwd(x, ln_g, ln_b, mu, rstd, wqkv, wqkv_s0, wqkv_s1, dqkv,
                           dz, dln, wpart, splits_qkv, cpart, dx, dg, db,
                           dwqkv, dwqkv_s0, dwqkv_s1, dbqkv, M, C, HD, s);
}

// Returns the first cudaError_t met (0 = success).  Workspace, all
// allocated by the caller: da, u [M, C] (no longer read), dacc [M, HD],
// delta [B·H·N] (used only without extra), dqkv [M, 3HD], dln [M, C],
// dbpart [wta::bwd_chunks(B, G, H)·G·H·N·N] (used only with dextra;
// ops/fused_layer.py window_chunks), wpart [max(splits_out·HD·C,
// splits_qkv·C·3HD)], cpart [ceil(M / 128) · max(C, 3HD)].  dwqkv / dwout are written through
// their (row, col) strides, so they may share the layout of the weight view
// the forward read; bqkv / bout / rs / dbqkv / dbout / drs may be null, and
// so may extra [G, H, N, N] (groups = G; N ≤ 128, heads up to 32 wide) and its
// gradient dextra [G, H, N, N] (null when the bias needs none).
extern "C" int vtx_fused_attention_layer_bwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* extra, int groups,
    const float* rs, const float* qkv, const float* acc, const float* mu,
    const float* rstd, const float* lse, const float* dz,
    float* da, float* dacc, float* delta, float* dqkv, float* u, float* dln,
    float* dbpart, float* wpart, int splits_out, int splits_qkv, float* cpart,
    float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, float* dextra, int B, int N, int C, int H, int D, float scale,
    void* stream) {
  return static_cast<int>(vtx::attention_half_bwd(
      x, ln_g, ln_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout,
      rs, extra, groups, qkv, acc, mu, rstd, lse, dz, dacc, delta, dqkv, dln,
      dbpart, wpart, splits_out, splits_qkv, cpart, dx, dg, db, dwqkv, dwqkv_s0,
      dwqkv_s1, dbqkv, dwout, dwout_s0, dwout_s1, dbout, drs, dextra, B, N, C, H,
      D, scale, static_cast<cudaStream_t>(stream)));
}
