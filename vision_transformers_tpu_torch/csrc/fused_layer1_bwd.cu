// Backward of the whole pre-LN transformer layer, float32, for Hopper
// (sm_90a):
//
//   z = x + r₁ ⊙ OutProj(MHSA(QkvProj(LN₁(x)) + extra))
//   o = z + r₂ ⊙ (silu(LN₂(z)·W₁ + b₁)·W₂ + b₂)
//
// Replaces the TPU (Pallas) kernels
//   vision_transformers_tpu/ops/fused_layer1.py:181   _l1_bwd_kernel
//   vision_transformers_tpu/ops/fused_layer.py:743    _ff_bwd_kernel
//       (B7's backward: the FF half alone, steps 1-5, with silu or
//       tanh-gelu, vtx_fused_ff_layer_bwd; its 8·M·C·F GEMM operations
//       bound it, as the FF half bounds the whole layer's)
// and computes what it computes: dx, the gradients of both LayerNorms, of
// the four weights and their biases, of the grouped additive attention bias
// extra [G, H, N, N] (Swin's relative-position bias and shift mask; row b is
// in group b / (B/G)) and, when they are asked for, of both per-sample
// DropPath scales r₁, r₂ [B].  It reads what the whole layer's training
// forward (fused_layer.cu) saved: qkv, acc, z, the FF pre-activation hid,
// the LN₁ / LN₂ statistics and the softmax log-sum-exp — so nothing of the
// forward is recomputed but the two LayerNorm outputs and silu(hid), which
// are elementwise, and those are applied in the GEMM core's producer and
// epilogue (GemmExtra, common.cuh), never written.  One C entry,
// vtx_fused_transformer_layer_bwd, is a fixed sequence of launches on the
// caller's stream:
//
//   FF half, given do (vtx::ff_half_bwd):
//   1. dW₂ = silu(hid)ᵀ·(r₂ ⊙ do): split-K, silu applied to hid and r₂ to
//      do as the producer stages them;  db₂ = Σ_rows r₂ ⊙ do
//   2. da₀ = do·W₂ᵀ, its epilogue writing the row partials of da₀ ⊙
//      silu(hid), dh = r₂ · da₀ ⊙ silu'(hid) and dh's column partials per
//      16-row slice;  dr₂[b] = Σ_{rows of b}(the partials + do⊙b₂) (the
//      reassociation of fused_layer1.py:232-246);  db₁ = the column
//      partials summed in order (128 slices at a time, then the chunks)
//   3. dW₁ = LN₂(z)ᵀ·dh: split-K, LN₂ applied to z from the saved
//      statistics as the producer stages it
//   4. dln₂ = dh·W₁ᵀ;  dz = do + LN₂ᵀ(dln₂);  dg₂, db₂ⁿ = column sums
//   Attention half, given dz: fused_layer_bwd.cu's attention_half_bwd; with
//   the bias the window attention's backward (window_attention_tc.cuh)
//   sums dS over each group's rows into dextra (per chunk of rows in row
//   order, then over the chunks in order), without it (a layer with no
//   bias, as ViT's: N = 197, D = 64) the packed-row core's backward
//   (attention_tc.cuh, fused_attention_qkv.cu) sums dq's key-tile partials
//   in order.
//
// Determinism: as in fused_layer_bwd.cu, every reduction over rows is a
// fixed-order two-pass sum (split-K slabs, row chunks, the chunked group
// sum of dS)
// or one block's fixed tree; no float atomics, so the gradients are
// bit-identical from run to run.
//
// What bounds it on this card.  The FF half's four GEMMs do 8·M·C·F
// operations (2x the FF forward), the attention half 16·M·C·HD plus five
// attention products of 2·B·H·N²·D; at Swin-S (F = 4C, HD = C, N = 98) the
// GEMMs are ~93% of it, on the GEMM core (gemm_tc.cu, 3xTF32 on wgmma,
// 165 TFLOP/s f32-accurate at 700 W), and the attention is on the tensor
// cores too (window_attention_tc.cuh, or attention_tc.cuh without a bias;
// 3xTF32 on mma.sync, the same bound).
// Besides the GEMMs, the FF half writes dh [M, F] once and reads it twice
// (the dW₁ and dln₂ GEMMs) — Swin-S stage 1 at 64 images is M = 200,704
// rows, F = 384.  dS stays in
// the attention's registers: its per-group sum leaves a block as one
// partial [G, H, N, N] per chunk of windows (≈ 11 MB at that shape).
//
// bf16 (vtx_fused_transformer_layer_bwd_bf16: Swin-S's training at the JAX
// package's default precision, with the grouped bias and its gradient and
// both row scales) runs the same steps on the bf16 forms, rounding where
// the JAX kernel (fused_layer1.py:221-276) rounds; the GEMM core's bf16
// TMA producer stages no transform, so each staged operand is a pass:
//   1. af = round(silu(hid)); dout' = round(do·round(r₂)) (into dz's
//      memory, free until step 5); dW₂ = afᵀ·dout', db₂ = Σ dout' in f32
//   2. da₀ = do·W₂ᵀ in f32 (into dq_part, free until the attention half);
//      dr₂ = Σ_rows of b (da₀ ⊙ af + do ⊙ b₂); da = round(r₂·da₀) (without
//      r₂ the GEMM's epilogue rounds do·W₂ᵀ) into dh's memory
//   3. dh = round(da ⊙ silu'(hid)) in place; db₁ = Σ dh in f32
//   4. u₂ = round(LN₂(z)) into dz's memory; dW₁ = u₂ᵀ·dh
//   5. dln₂ = dh·W₁ᵀ in f32; dz = round(do + round(LN₂ᵀ(dln₂))); dg₂, db₂ⁿ
//   then the attention half's bf16 steps (fused_layer_bwd.cu,
//   vtx::attention_half_bwd_bf16), the bias's gradient from the packed-row
//   core's bf16 backward (dS summed in f32 per chunk of each group's
//   windows on chip, then over the chunks in order: no [B, H, N, N] dS).
//
// What later work changes: the LN backward and its column sums into the dln
// GEMM's epilogue, and the same launch fusion as the attention layer's
// backward.

#include "common.cuh"

namespace {

cudaError_t transformer_layer_bwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* extra, int groups, const float* rs_attn, const float* rs_ff,
    const float* qkv, const float* acc, const float* z, const float* hid,
    const float* mu1, const float* rstd1, const float* lse, const float* mu2,
    const float* rstd2, const float* dout,
    float* af, float* dh, float* dz, float* dacc, float* dq_part,
    float* dqkv, float* dln, float* dbpart, float* wpart,
    int splits_out, int splits_qkv, int splits_w1, int splits_w2, float* cpart,
    float* dx, float* dg1, float* db1, float* dwqkv, long long dwqkv_s0,
    long long dwqkv_s1, float* dbqkv, float* dwout, long long dwout_s0,
    long long dwout_s1, float* dbout, float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f,
    float* dextra, float* drs_attn, float* drs_ff,
    int B, int N, int C, int H, int D, int F, float scale, cudaStream_t s) {
  // FF half, steps 1-4, given do (af: the row partials' workspace)
  VTX_CHECK(vtx::ff_half_bwd(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0,
                             w2_s1, b2, rs_ff, N, hid, mu2, rstd2, dout, dh, dln, af,
                             wpart, splits_w1, splits_w2, cpart, dz,
                             dg2, db2, dw1, dw1_s0, dw1_s1, db1f, dw2, dw2_s0,
                             dw2_s1, db2f, drs_ff, B, B * N, C, F, ACT_SILU, s));

  // attention half, driven by dz
  return vtx::attention_half_bwd(
      x, ln1_g, ln1_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1,
      bout, rs_attn, extra, groups, qkv, acc, mu1, rstd1, lse, dz, dacc,
      dq_part, dqkv, dln, dbpart, wpart, splits_out, splits_qkv, cpart, dx, dg1,
      db1, dwqkv, dwqkv_s0, dwqkv_s1, dbqkv, dwout, dwout_s0, dwout_s1, dbout,
      drs_attn, dextra, B, N, C, H, D, scale, s);
}

}  // namespace

// Steps 1-4 above (rows_per_scale rows per sample).  Workspace: dh [M, F],
// dln [M, C], rpart [ff_rpart_floats(M, F, B, rows_per_scale)] (used with
// rs_ff and drs_ff, or db1f), wpart, cpart [ceil(M / 128) · max(C, F)].
cudaError_t vtx::ff_half_bwd(
    const float* z, const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs_ff, int rows_per_scale, const float* hid, const float* mu2,
    const float* rstd2, const float* dout, float* dh, float* dln, float* rpart,
    float* wpart, int splits_w1, int splits_w2,
    float* cpart, float* dz, float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f, float* drs_ff,
    int B, int M, int C, int F, int act, cudaStream_t s) {
  if (B > 65535 || (act != ACT_SILU && act != ACT_GELU)) return cudaErrorInvalidValue;
  const bool drs = rs_ff && drs_ff;
  const long long MC = (long long)M * C, MF = (long long)M * F;

  // 1. dW₂ = act(hid)ᵀ·(r₂ ⊙ do); db₂ = Σ r₂ ⊙ do.  act staged where
  // hid's tiles meet few output tiles, else act(hid) into dh (written in
  // step 2); likewise r₂ ⊙ do, else into dln (written in step 4)
  GemmExtra x1;
  const float* a1 = hid;
  const float* b1s = dout;
  if (gemm_col_tiles(C) <= STAGE_ACT_TILES) {
    x1.a_act = act;
  } else {
    if (act == ACT_SILU)
      act_kernel<ACT_SILU><<<ew_blocks(MF), EW_THREADS, 0, s>>>(hid, dh, MF);
    else
      act_kernel<ACT_GELU><<<ew_blocks(MF), EW_THREADS, 0, s>>>(hid, dh, MF);
    VTX_CHECK(cudaGetLastError());
    a1 = dh;
  }
  if (rs_ff && gemm_row_tiles(F) <= STAGE_TILES) {
    x1.b_rs = rs_ff;
    x1.b_rs_rows = rows_per_scale;
  } else if (rs_ff) {
    scale_rows_kernel<<<ew_blocks(MC), EW_THREADS, 0, s>>>(dout, rs_ff, rows_per_scale, C,
                                                           MC, dln);
    VTX_CHECK(cudaGetLastError());
    b1s = dln;
  }
  VTX_CHECK(launch_gemm_splitk_x(a1, F, b1s, C, 1, wpart, splits_w2, dw2, dw2_s0, dw2_s1, F,
                                 C, M, x1, s));
  if (db2f)
    VTX_CHECK(launch_colsum(dout, nullptr, nullptr, nullptr, cpart, db2f, M, C, s,
                            MapRows{nullptr, 1}, rs_ff, rows_per_scale));

  // 2. da₀ = do·W₂ᵀ → the dr₂ partials, dh = r₂ · da₀ ⊙ act'(hid), db₁'s
  // column partials
  // rpart: the row partials, the dr pass's chunk sums, the column partials
  float* dpart = rpart + (long long)M * cdiv(F, RPART_COLS);
  float* colpart = dpart + (long long)B * cdiv(rows_per_scale, DRS_ROWS);
  GemmExtra x2;
  x2.hid = hid;
  x2.hid_act = act;
  x2.rpart = drs ? rpart : nullptr;
  x2.cpart = db1f ? colpart : nullptr;
  VTX_CHECK(launch_gemm_x(dout, w2, w2_s1, w2_s0, nullptr, rs_ff, rows_per_scale, nullptr,
                          dh, M, F, C, 0, x2, s));
  if (drs) VTX_CHECK(launch_drs(rpart, F, dout, b2, C, rows_per_scale, B, dpart, drs_ff, s));
  // db₁: the slices' partials in order, 128 at a time, then the chunks
  if (db1f)
    VTX_CHECK(launch_colsum(colpart, nullptr, nullptr, nullptr, cpart, db1f,
                            cdiv(M, CPART_ROWS), F, s));

  // 3. dW₁ = LN₂(z)ᵀ·dh, LN₂ staged where z's tiles meet few output tiles,
  // else LN₂(z) into dln (written in step 4)
  GemmExtra x3;
  const float* a3 = z;
  if (gemm_col_tiles(F) <= STAGE_TILES) {
    x3.ln_mu = mu2;
    x3.ln_rstd = rstd2;
    x3.ln_g = ln2_g;
    x3.ln_b = ln2_b;
  } else {
    ln_apply_kernel<false><<<ew_blocks(MC), EW_THREADS, 0, s>>>(
        z, mu2, rstd2, ln2_g, ln2_b, dln, C, MC, MapRows{nullptr, 1});
    VTX_CHECK(cudaGetLastError());
    a3 = dln;
  }
  VTX_CHECK(launch_gemm_splitk_x(a3, C, dh, F, 1, wpart, splits_w1, dw1, dw1_s0, dw1_s1, C,
                                 F, M, x3, s));

  // 4. dln₂ = dh·W₁ᵀ; dz = do + LN₂ᵀ(dln₂); dg₂ = Σ dln₂ ⊙ x̂₂; db₂ⁿ = Σ dln₂
  VTX_CHECK(launch_gemm(dh, w1, w1_s1, w1_s0, nullptr, nullptr, 1, nullptr, dln,
                        M, C, F, 0, s));
  ln_bwd_rows_kernel<false><<<cdiv(M, LN_THREADS / 32), LN_THREADS, 0, s>>>(
      dln, z, mu2, rstd2, ln2_g, dout, dz, M, C, MapRows{nullptr, 1});
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK(launch_colsum(dln, z, mu2, rstd2, cpart, dg2, M, C, s));
  VTX_CHECK(launch_colsum(dln, nullptr, nullptr, nullptr, cpart, db2, M, C, s));
  return cudaSuccess;
}

// The FF half's bf16 backward, steps 1-5 above (rows_per_scale rows per
// sample).  Workspace: af, dh [M, F] bf16, dz [M, C] bf16 (also the
// output), dln [M, C] f32, da0 [M, F] f32 (used only with rs_ff), wpart,
// cpart.
cudaError_t vtx::ff_half_bwd_bf16(
    const bf16* z, const float* ln2_g, const float* ln2_b,
    const bf16* w1, long long w1_s0, long long w1_s1,
    const bf16* w2, long long w2_s0, long long w2_s1, const bf16* b2,
    const float* rs_ff, int rows_per_scale, const bf16* hid, const float* mu2,
    const float* rstd2, const bf16* dout, bf16* af, bf16* dh, float* da0, float* dln,
    float* wpart, int splits_w1, int splits_w2, float* cpart, bf16* dz, float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f, float* drs_ff,
    int B, int M, int C, int F, cudaStream_t s) {
  if (B > 65535 || (rs_ff && !da0)) return cudaErrorInvalidValue;
  const long long MC = (long long)M * C, MF = (long long)M * F;
  // 1. af; dout' = round(do·round(r₂)); dW₂ = afᵀ·dout'; db₂
  act_bf16_kernel<ACT_SILU><<<ew_blocks(MF), EW_THREADS, 0, s>>>(hid, af, MF);
  VTX_CHECK(cudaGetLastError());
  const bf16* dff = dout;
  if (rs_ff) {
    scale_rows_kernel<<<ew_blocks(MC), EW_THREADS, 0, s>>>(dout, rs_ff, rows_per_scale, C, MC,
                                                           dz);
    VTX_CHECK(cudaGetLastError());
    dff = dz;
  }
  VTX_CHECK(launch_gemm_splitk_bf16(af, F, dff, C, 1, wpart, splits_w2, dw2, dw2_s0, dw2_s1, F,
                                    C, M, s));
  if (db2f) VTX_CHECK(launch_colsum(dff, nullptr, nullptr, nullptr, cpart, db2f, M, C, s));
  // 2. da (and dr₂) into dh's memory
  if (rs_ff) {
    VTX_CHECK(launch_gemm_bf16(dout, w2, w2_s1, w2_s0, nullptr, nullptr, 1, nullptr, da0, 1, M,
                               F, C, 0, s));
    row_scale_grad_kernel<bf16><<<B, DRS_THREADS, 0, s>>>(da0, dh, af, dout, b2, rs_ff,
                                                          drs_ff, rows_per_scale, F, C);
    VTX_CHECK(cudaGetLastError());
  } else {
    VTX_CHECK(launch_gemm_bf16(dout, w2, w2_s1, w2_s0, nullptr, nullptr, 1, nullptr, dh, 0, M,
                               F, C, 0, s));
  }
  // 3. dh = round(da ⊙ silu'(hid)) in place; db₁
  act_grad_bf16_kernel<ACT_SILU><<<ew_blocks(MF), EW_THREADS, 0, s>>>(dh, hid, dh, MF);
  VTX_CHECK(cudaGetLastError());
  if (db1f) VTX_CHECK(launch_colsum(dh, nullptr, nullptr, nullptr, cpart, db1f, M, F, s));
  // 4. u₂ = round(LN₂(z)) into dz's memory; dW₁ = u₂ᵀ·dh
  ln_apply_kernel<false, bf16><<<ew_blocks(MC), EW_THREADS, 0, s>>>(
      z, mu2, rstd2, ln2_g, ln2_b, dz, C, MC, MapRows{nullptr, 1});
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK(launch_gemm_splitk_bf16(dz, C, dh, F, 1, wpart, splits_w1, dw1, dw1_s0, dw1_s1, C,
                                    F, M, s));
  // 5. dln₂ = dh·W₁ᵀ (f32); dz = round(do + round(LN₂ᵀ(dln₂))); dg₂, db₂ⁿ
  VTX_CHECK(launch_gemm_bf16(dh, w1, w1_s1, w1_s0, nullptr, nullptr, 1, nullptr, dln, 1, M, C,
                             F, 0, s));
  ln_bwd_rows_kernel<false, bf16><<<cdiv(M, LN_THREADS / 32), LN_THREADS, 0, s>>>(
      dln, z, mu2, rstd2, ln2_g, dout, dz, M, C, MapRows{nullptr, 1});
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK((launch_colsum<float, bf16>(dln, z, mu2, rstd2, cpart, dg2, M, C, s)));
  return launch_colsum(dln, nullptr, nullptr, nullptr, cpart, db2, M, C, s);
}

// Returns the first cudaError_t met (0 = success).  Workspace, all
// allocated by the caller (M = B·N): af [M, F] (the row partials of the dr₂
// pass, used only with rs_ff and drs_ff), dh [M, F], dz [M, C], dacc
// [M, HD], dq_part [ceil(N / 64)·M·HD] (the packed-row attention's dq
// partials, used only without extra and where N > 64, else null), dqkv
// [M, 3HD], dln [M, C], dbpart
// [bias_chunks(B, G, H)·G·H·N·N] (used only with extra and dextra;
// ops/fused_layer.py window_chunks), wpart [max over the four weight
// gradients of splits·rows·cols], cpart [ceil(M / 128) · max(C, 3HD, F)].  The weight
// gradients are written through their (row, col) strides, so they may share
// the layout of the weight views the forward read.  The biases, extra, the
// row scales and their gradients (dbqkv … db2f, dextra, drs_attn, drs_ff)
// may be null.
extern "C" int vtx_fused_transformer_layer_bwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* extra, int groups, const float* rs_attn, const float* rs_ff,
    const float* qkv, const float* acc, const float* z, const float* hid,
    const float* mu1, const float* rstd1, const float* lse, const float* mu2,
    const float* rstd2, const float* dout,
    float* af, float* dh, float* dz, float* dacc, float* dq_part,
    float* dqkv, float* dln, float* dbpart, float* wpart,
    int splits_out, int splits_qkv, int splits_w1, int splits_w2, float* cpart,
    float* dx, float* dg1, float* db1, float* dwqkv, long long dwqkv_s0,
    long long dwqkv_s1, float* dbqkv, float* dwout, long long dwout_s0,
    long long dwout_s1, float* dbout, float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f,
    float* dextra, float* drs_attn, float* drs_ff,
    int B, int N, int C, int H, int D, int F, float scale, void* stream) {
  return static_cast<int>(transformer_layer_bwd(
      x, ln1_g, ln1_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1,
      bout, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1, b2, extra,
      groups, rs_attn, rs_ff, qkv, acc, z, hid, mu1, rstd1, lse, mu2, rstd2,
      dout, af, dh, dz, dacc, dq_part, dqkv, dln, dbpart, wpart, splits_out,
      splits_qkv, splits_w1, splits_w2, cpart, dx, dg1, db1, dwqkv, dwqkv_s0,
      dwqkv_s1, dbqkv, dwout, dwout_s0, dwout_s1, dbout, dg2, db2, dw1, dw1_s0,
      dw1_s1, db1f, dw2, dw2_s0, dw2_s1, db2f, dextra, drs_attn, drs_ff, B, N,
      C, H, D, F, scale, static_cast<cudaStream_t>(stream)));
}

// The bf16 form: the same parameter list; x, the weights and biases, qkv,
// acc, z, hid, dout, dx and the workspaces af, dh [M, F], dz [M, C], dacc
// [M, HD] and dqkv [M, 3HD] bf16; dq_part f32 and never null: first da₀
// [M, F] (with rs_ff), then the bf16 attention's workspace (with the dbias
// chunks' sums when dextra is asked for) or dacc₀ [M, HD] (with rs_attn),
// so the largest of the three; dln [M, C] f32; every gradient of a weight,
// a bias or a LayerNorm f32; extra [G, H, N, N] f32 or null, dextra [G, H,
// N, N] f32 or null (N ≤ 128); dbpart null.
extern "C" int vtx_fused_transformer_layer_bwd_bf16(
    const bf16* x, const float* ln1_g, const float* ln1_b,
    const bf16* wqkv, long long wqkv_s0, long long wqkv_s1, const bf16* bqkv,
    const bf16* wout, long long wout_s0, long long wout_s1, const bf16* bout,
    const float* ln2_g, const float* ln2_b,
    const bf16* w1, long long w1_s0, long long w1_s1, const bf16* b1,
    const bf16* w2, long long w2_s0, long long w2_s1, const bf16* b2,
    const float* extra, int groups, const float* rs_attn, const float* rs_ff,
    const bf16* qkv, const bf16* acc, const bf16* z, const bf16* hid,
    const float* mu1, const float* rstd1, const float* lse, const float* mu2,
    const float* rstd2, const bf16* dout,
    bf16* af, bf16* dh, bf16* dz, bf16* dacc, float* dq_part,
    bf16* dqkv, float* dln, float* dbpart, float* wpart,
    int splits_out, int splits_qkv, int splits_w1, int splits_w2, float* cpart,
    bf16* dx, float* dg1, float* db1, float* dwqkv, long long dwqkv_s0,
    long long dwqkv_s1, float* dbqkv, float* dwout, long long dwout_s0,
    long long dwout_s1, float* dbout, float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f,
    float* dextra, float* drs_attn, float* drs_ff,
    int B, int N, int C, int H, int D, int F, float scale, void* stream) {
  (void)b1;  // its gradient is the column sum of dh
  if (dbpart || !dq_part || B < 1 || N < 1 || (long long)B * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VTX_CHECK(vtx::ff_half_bwd_bf16(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, w2, w2_s0, w2_s1, b2, rs_ff, N,
                             hid, mu2, rstd2, dout, af, dh, dq_part, dln, wpart, splits_w1,
                             splits_w2, cpart, dz, dg2, db2, dw1, dw1_s0, dw1_s1, db1f, dw2,
                             dw2_s0, dw2_s1, db2f, drs_ff, B, B * N, C, F, s));
  return static_cast<int>(vtx::attention_half_bwd_bf16(
      x, ln1_g, ln1_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout, extra, groups,
      rs_attn, qkv, acc, mu1, rstd1, lse, dz, dacc, dq_part, dqkv, dln, wpart, splits_out,
      splits_qkv, cpart, dx, dg1, db1, dwqkv, dwqkv_s0, dwqkv_s1, dbqkv, dwout, dwout_s0,
      dwout_s1, dbout, drs_attn, dextra, B, N, C, H, D, scale, s));
}

// B7's backward (vision_transformers_tpu/ops/fused_layer.py:743,
// _ff_bwd_kernel): steps 1-4 above with dz = dx, on the saves of
// vtx_fused_ff_layer_fwd (hid — the pre-activation —, mu, rstd [M]) over
// M = B·N rows, rs [B] per sample (N rows each), act 0 = silu, 1 =
// tanh-gelu.  Returns the first cudaError_t met.  Workspace: da, u [M, C]
// (no longer read), af [M, F] (the dr pass's row partials, used only with
// rs and drs), dh [M, F], dln [M, C], wpart [max(splits_w1·C·F,
// splits_w2·F·C)], cpart [ceil(M / 128) · max(C, F)].  dw1 / dw2 are
// written through their (row, col) strides; b1, b2, rs, db1, db2 and drs
// may be null.
extern "C" int vtx_fused_ff_layer_bwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs, const float* hid, const float* mu, const float* rstd,
    const float* dout, float* da, float* af, float* dh, float* u, float* dln,
    float* wpart, int splits_w1, int splits_w2, float* cpart,
    float* dx, float* dg, float* db,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2, float* drs,
    int B, int N, int C, int F, int act, void* stream) {
  if (B < 1 || N < 1 || (long long)B * N > 0x7fffffffLL) return cudaErrorInvalidValue;
  return static_cast<int>(vtx::ff_half_bwd(
      x, ln_g, ln_b, w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1, b2, rs, N, hid, mu,
      rstd, dout, dh, dln, af, wpart, splits_w1, splits_w2, cpart, dx, dg, db,
      dw1, dw1_s0, dw1_s1, db1, dw2, dw2_s0, dw2_s1, db2, drs, B, B * N, C, F, act,
      static_cast<cudaStream_t>(stream)));
}
