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
//      memory: Δ = rowsum(dacc_h ⊙ acc_h); one pass of key-tile blocks
//      recomputes p = exp(q·kᵀ·s − lse) and accumulates dv += pᵀ·do,
//      dk += dsᵀ·q·s with ds = p ⊙ (do·vᵀ − Δ), and dq = ds·k·s as one
//      partial per key tile (dq_part), summed in key-tile order: the
//      packed-row core of B3 (attention_tc.cuh through
//      vtx::packed_attention_bwd, fused_attention_qkv.cu).  It writes dqkv
//      [M, 3HD] (q-heads | k-heads | v-heads).  With the grouped additive
//      bias extra [G, H, N, N] (Swin's in the whole
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
// on wgmma, bound at 165 TFLOP/s f32-accurate at 700 W), reading accᵀ, xᵀ
// (its LN staged), woutᵀ and wqkvᵀ through strides.  With the bias (Twins' pair mask, Swin's
// grouped bias: N ≤ 128, heads up to 32 wide) the attention backward is the
// tensor-core window attention's (window_attention_tc.cuh, 3xTF32 on
// mma.sync, bound at the same 165 TFLOP/s): one pass per window computing
// Δ, dq, dk and dv straight into dqkv, and dextra as per-block register
// sums over a chunk of each group's windows, summed over the chunks in
// order — no [B, H, N, N] dS buffer.  Every other call (ViT: N = 197, D =
// 64; Twins' last stage: N = 49, D = 32, both without a bias; DINO's packed
// local crops: N = 111, D = 64 with the block mask) takes the packed-row core's one-pass
// backward (3xTF32 on mma.sync, the same bound): a block owns one key tile
// of one (b, h), its K and V split into hi / lo once and resident, and
// walks the query tiles, Δ in its prologue, dS to the next product through
// registers; dk and dv leave once, dq as ceil(N / 64) partials (155 MB at
// ViT-S/16, B = 128) summed in order, so no float atomics.
//
// bf16 (vtx_fused_attention_layer_bwd_bf16: ViT-S/16's training at the JAX
// package's default precision, DINO's with the block mask as the bias,
// which takes no gradient, and, through vtx::attention_half_bwd_bf16, the
// attention half of the whole layer's bf16 backward, Swin-S's with the
// grouped bias and its gradient) runs the same six steps on the bf16 forms,
// rounding where the JAX kernel (fused_layer.py:183-339) rounds:
//   1. da = round(dz·round(r)) by a pass (into dln's memory, free until
//      step 4); dwout = accᵀ·da and dbout = Σ da in f32
//   2. dacc₀ = dz·woutᵀ in f32 (into dq_part, free until step 3); dr from
//      dacc₀ and acc; dacc = round(r·dacc₀) (without r the GEMM's epilogue
//      rounds dz·woutᵀ)
//   3. the packed-row core's bf16 backward (P recomputed in f32 with the
//      bias, dS·scale rounded before dq and dk, dq summed on chip) → dqkv
//      bf16; with dextra the bias's gradient, dS summed in f32 per chunk of
//      each group's images on chip, then over the chunks in order
//   4. u = round(LN(x)) into dln's memory; dwqkv = uᵀ·dqkv, dbqkv in f32
//   5. dln = dqkv·wqkvᵀ in f32
//   6. dx = round(dz + round(LNᵀ(dln))); dg, db in f32
// The weight and bias gradients leave in f32 (the wrapper rounds them to the
// weights' bf16 once, as the JAX custom_vjp returns them).
//
// What later work changes: fusing the launches (the LN backward into the
// dln GEMM's epilogue, the column sums into the weight GEMMs).

#include "window_attention_tc.cuh"

namespace {

// Step 3 → dqkv, on the tensor cores, on the forward's route
// (window_on_bias).  A bias call the window attention takes (extra [G, H, N,
// N], row b in group b / (B/G); N ≤ 128, heads up to 32 wide): its backward,
// which computes Δ itself and, when dextra is non-null, sums dS per block
// into dbpart [bias_chunks(B, G, H), G, H, N, N] and those partials in
// order into dextra [G, H, N, N].  Every other call (ViT's and Twins' last
// stage without a bias; DINO's block mask at heads 64 wide): the packed-row
// core's one-pass backward (vtx::packed_attention_bwd, fused_attention_qkv.cu;
// heads up to 64 wide, any N), Δ in its prologue, dq through the key-tile
// partials dq_part [ceil(N / 64), B·N, H·D] (null where N ≤ 64) summed in
// key-tile order, and with a bias that needs a gradient (dextra non-null)
// dS into dbpart [B, H, N, N] and its ordered sum over each group's rows
// into dextra.  DINO's mask needs none: dextra and dbpart stay null.
cudaError_t attention_core_bwd(const float* qkv, const float* dacc,
                               const float* acc, const float* lse,
                               const float* extra, int groups, float* dq_part,
                               float* dbpart, float* dqkv, float* dextra, int B,
                               int N, int H, int D, float scale, cudaStream_t s) {
  if (window_on_bias(extra, N, D))
    return wta::attention_bwd(qkv, acc, dacc, lse, extra, groups, false, dqkv, dbpart,
                              dextra, B, N, H, D, scale, s);
  return vtx::packed_attention_bwd(qkv, extra, groups, acc, lse, dacc, dq_part, dbpart,
                                   dqkv, dextra, B, N, H, D, scale, s);
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
// [bias_chunks(P, G, H), G, H, N, N] and their ordered sum in dbias
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
    row_scale_grad_kernel<float><<<B, DRS_THREADS, 0, s>>>(dacc, dacc, acc, dz, bout, rs,
                                                           drs, rows_per_scale, HD, C);
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
// above.  extra [G, H, N, N] (row b in group b / (B/G)) may be null.  On
// the window attention (window_on_bias) a non-null dextra takes the ordered
// sum of the per-block dS sums in dbpart [bias_chunks(B, G, H), G, H, N,
// N]; on the packed-row core dq_part [ceil(N / 64), B·N, H·D] (null where N
// ≤ 64) takes the dq partials, and a non-null dextra the ordered sum of dS
// in dbpart [B, H, N, N].
cudaError_t vtx::attention_half_bwd(
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
    cudaStream_t s) {
  const int M = B * N, HD = H * D;
  if (D > DMAX || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  if (extra && (groups < 1 || B % groups)) return cudaErrorInvalidValue;

  // 1-2. the out projection
  VTX_CHECK(vtx::out_proj_bwd(acc, wout, wout_s0, wout_s1, bout, rs, N, dz,
                              dacc, wpart, splits_out, cpart, dwout, dwout_s0,
                              dwout_s1, dbout, drs, B, M, C, HD, s));

  // 3. attention backward → dqkv (and dextra)
  VTX_CHECK(attention_core_bwd(qkv, dacc, acc, lse, extra, groups, dq_part, dbpart, dqkv,
                               dextra, B, N, H, D, scale, s));

  // 4-6. the qkv projection and LN
  return vtx::qkv_proj_bwd(x, ln_g, ln_b, mu, rstd, wqkv, wqkv_s0, wqkv_s1, dqkv,
                           dz, dln, wpart, splits_qkv, cpart, dx, dg, db,
                           dwqkv, dwqkv_s0, dwqkv_s1, dbqkv, M, C, HD, s);
}

// Returns the first cudaError_t met (0 = success).  Workspace, all
// allocated by the caller: dacc [M, HD], dq_part [ceil(N / 64)·M·HD]
// (used only on the packed-row core and where N > 64, else null), dqkv
// [M, 3HD], dln [M, C], dbpart (used only with dextra: on the window
// attention [bias_chunks(B, G, H)·G·H·N·N], ops/fused_layer.py
// window_chunks; on the packed-row core [B·H·N·N]), wpart [max(splits_out·HD·C,
// splits_qkv·C·3HD)], cpart [ceil(M / 128) · max(C, 3HD)].  dwqkv / dwout are written through
// their (row, col) strides, so they may share the layout of the weight view
// the forward read; bqkv / bout / rs / dbqkv / dbout / drs may be null, and
// so may extra [G, H, N, N] (groups = G) and its gradient dextra [G, H, N,
// N] (null when the bias needs none).
extern "C" int vtx_fused_attention_layer_bwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* extra, int groups,
    const float* rs, const float* qkv, const float* acc, const float* mu,
    const float* rstd, const float* lse, const float* dz,
    float* dacc, float* dq_part, float* dqkv, float* dln,
    float* dbpart, float* wpart, int splits_out, int splits_qkv, float* cpart,
    float* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, float* dextra, int B, int N, int C, int H, int D, float scale,
    void* stream) {
  return static_cast<int>(vtx::attention_half_bwd(
      x, ln_g, ln_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout,
      rs, extra, groups, qkv, acc, mu, rstd, lse, dz, dacc, dq_part, dqkv, dln,
      dbpart, wpart, splits_out, splits_qkv, cpart, dx, dg, db, dwqkv, dwqkv_s0,
      dwqkv_s1, dbqkv, dwout, dwout_s0, dwout_s1, dbout, drs, dextra, B, N, C, H,
      D, scale, static_cast<cudaStream_t>(stream)));
}

// The bf16 steps 1-2: the out projection's backward, given dz → dacc (and
// dwout, dbout, dr); the scaled branch da in dln's memory, dacc₀ f32 in
// rows (with rs) — also the Halo layer's (fused_halo.cu)
cudaError_t vtx::out_proj_bwd_bf16(
    const bf16* acc, const bf16* wout, long long wout_s0, long long wout_s1, const bf16* bout,
    const float* rs, int rows_per_scale, const bf16* dz, bf16* dacc, float* rows, float* dln,
    float* wpart, int splits_out, float* cpart, float* dwout, long long dwout_s0,
    long long dwout_s1, float* dbout, float* drs, int B, int M, int C, int HD,
    cudaStream_t s) {
  if (rs && !rows) return cudaErrorInvalidValue;
  // 1. da = round(dz·round(r)) into dln's memory (free until step 4);
  // dwout = accᵀ·da; dbout = Σ_rows da
  const long long MC = (long long)M * C;
  const bf16* da = dz;
  if (rs) {
    bf16* scaled = reinterpret_cast<bf16*>(dln);
    scale_rows_kernel<<<ew_blocks(MC), EW_THREADS, 0, s>>>(dz, rs, rows_per_scale, C, MC,
                                                           scaled);
    VTX_CHECK(cudaGetLastError());
    da = scaled;
  }
  VTX_CHECK(launch_gemm_splitk_bf16(acc, HD, da, C, 1, wpart, splits_out, dwout, dwout_s0,
                                    dwout_s1, HD, C, M, s));
  if (dbout) VTX_CHECK(launch_colsum(da, nullptr, nullptr, nullptr, cpart, dbout, M, C, s));
  // 2. dacc (and dr)
  if (rs) {
    VTX_CHECK(launch_gemm_bf16(dz, wout, wout_s1, wout_s0, nullptr, nullptr, 1, nullptr,
                               rows, 1, M, HD, C, 0, s));
    row_scale_grad_kernel<bf16><<<B, DRS_THREADS, 0, s>>>(rows, dacc, acc, dz, bout, rs,
                                                          drs, rows_per_scale, HD, C);
    return cudaGetLastError();
  }
  return launch_gemm_bf16(dz, wout, wout_s1, wout_s0, nullptr, nullptr, 1, nullptr, dacc, 0,
                          M, HD, C, 0, s);
}

// The bf16 steps 4-6: the qkv projection's and the LayerNorm's backward,
// given dqkv and the residual's dz → dx (and dwqkv, dbqkv, dg, db); u in
// dln's memory first — also the Halo layer's (fused_halo.cu)
cudaError_t vtx::qkv_proj_bwd_bf16(
    const bf16* x, const float* ln_g, const float* ln_b, const float* mu, const float* rstd,
    const bf16* wqkv, long long wqkv_s0, long long wqkv_s1, const bf16* dqkv, const bf16* dz,
    float* dln, float* wpart, int splits_qkv, float* cpart, bf16* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv, int M, int C, int HD,
    cudaStream_t s) {
  const long long MC = (long long)M * C;
  // 4. u = round(LN(x)) in dln's memory; dwqkv = uᵀ·dqkv; dbqkv
  bf16* u = reinterpret_cast<bf16*>(dln);
  ln_apply_kernel<false, bf16><<<ew_blocks(MC), EW_THREADS, 0, s>>>(x, mu, rstd, ln_g, ln_b,
                                                                    u, C, MC,
                                                                    MapRows{nullptr, 1});
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK(launch_gemm_splitk_bf16(u, C, dqkv, 3 * HD, 1, wpart, splits_qkv, dwqkv, dwqkv_s0,
                                    dwqkv_s1, C, 3 * HD, M, s));
  if (dbqkv)
    VTX_CHECK(launch_colsum(dqkv, nullptr, nullptr, nullptr, cpart, dbqkv, M, 3 * HD, s));
  // 5. dln = dqkv·wqkvᵀ (f32)
  VTX_CHECK(launch_gemm_bf16(dqkv, wqkv, wqkv_s1, wqkv_s0, nullptr, nullptr, 1, nullptr, dln,
                             1, M, C, 3 * HD, 0, s));
  // 6. the LN backward; dg, db
  ln_bwd_rows_kernel<false, bf16><<<cdiv(M, LN_THREADS / 32), LN_THREADS, 0, s>>>(
      dln, x, mu, rstd, ln_g, dz, dx, M, C, MapRows{nullptr, 1});
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK((launch_colsum<float, bf16>(dln, x, mu, rstd, cpart, dg, M, C, s)));
  return launch_colsum(dln, nullptr, nullptr, nullptr, cpart, db, M, C, s);
}

// The bf16 steps (vtx_fused_attention_layer_bwd_bf16 below, and the whole
// layer's bf16 backward after its FF half, fused_layer1_bwd.cu)
cudaError_t vtx::attention_half_bwd_bf16(
    const bf16* x, const float* ln_g, const float* ln_b,
    const bf16* wqkv, long long wqkv_s0, long long wqkv_s1, const bf16* bqkv,
    const bf16* wout, long long wout_s0, long long wout_s1, const bf16* bout,
    const float* extra, int groups, const float* rs, const bf16* qkv, const bf16* acc,
    const float* mu, const float* rstd, const float* lse, const bf16* dz,
    bf16* dacc, float* dq_part, bf16* dqkv, float* dln, float* wpart, int splits_out,
    int splits_qkv, float* cpart, bf16* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, float* dextra, int B, int N, int C, int H, int D, float scale,
    cudaStream_t s) {
  const int M = B * N, HD = H * D;
  if ((extra && (groups < 1 || B % groups)) || (dextra && !extra) || !dq_part || D > DMAX ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  // 1-2. the out projection → dacc (dacc₀ in dq_part with rs)
  VTX_CHECK(vtx::out_proj_bwd_bf16(acc, wout, wout_s0, wout_s1, bout, rs, N, dz, dacc, dq_part,
                                   dln, wpart, splits_out, cpart, dwout, dwout_s0, dwout_s1,
                                   dbout, drs, B, M, C, HD, s));
  // 3. attention backward → dqkv (and dextra)
  VTX_CHECK(vtx::packed_attention_bwd_bf16(qkv, extra, groups, acc, lse, dacc, dq_part, dqkv,
                                           dextra, B, N, H, D, scale, s));
  // 4-6. the qkv projection and the LN
  return vtx::qkv_proj_bwd_bf16(x, ln_g, ln_b, mu, rstd, wqkv, wqkv_s0, wqkv_s1, dqkv, dz, dln,
                                wpart, splits_qkv, cpart, dx, dg, db, dwqkv, dwqkv_s0, dwqkv_s1,
                                dbqkv, M, C, HD, s);
}

// The bf16 form: the same parameter list; x, the weights and biases, qkv,
// acc, dz, dx, and the workspaces dacc [M, HD] and dqkv [M, 3HD] bf16;
// dq_part f32 and never null, the workspace of the bf16 attention's
// backward (vtx::packed_attention_bwd_bf16_floats floats, with the dbias
// chunks' sums when dextra is asked for), or [M, HD] where that is larger
// and a row scale makes it first hold dacc₀; dln [M, C] f32 (first holding
// u bf16); every gradient of a weight or bias f32; extra [G, H, N, N] f32
// or null (groups = G, dividing B; any N, on the packed-row core); dextra
// [G, H, N, N] f32 or null (N ≤ 128); dbpart null (the dbias partials live
// in dq_part).
extern "C" int vtx_fused_attention_layer_bwd_bf16(
    const bf16* x, const float* ln_g, const float* ln_b,
    const bf16* wqkv, long long wqkv_s0, long long wqkv_s1, const bf16* bqkv,
    const bf16* wout, long long wout_s0, long long wout_s1, const bf16* bout,
    const float* extra, int groups,
    const float* rs, const bf16* qkv, const bf16* acc, const float* mu,
    const float* rstd, const float* lse, const bf16* dz,
    bf16* dacc, float* dq_part, bf16* dqkv, float* dln,
    float* dbpart, float* wpart, int splits_out, int splits_qkv, float* cpart,
    bf16* dx, float* dg, float* db,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* drs, float* dextra, int B, int N, int C, int H, int D, float scale,
    void* stream) {
  if (dbpart) return cudaErrorInvalidValue;
  return static_cast<int>(vtx::attention_half_bwd_bf16(
      x, ln_g, ln_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout, extra, groups,
      rs, qkv, acc, mu, rstd, lse, dz, dacc, dq_part, dqkv, dln, wpart, splits_out, splits_qkv,
      cpart, dx, dg, db, dwqkv, dwqkv_s0, dwqkv_s1, dbqkv, dwout, dwout_s0, dwout_s1, dbout, drs,
      dextra, B, N, C, H, D, scale, static_cast<cudaStream_t>(stream)));
}
