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
// What later work changes: the LN backward and its column sums into the dln
// GEMM's epilogue, bf16 operands, and the same launch fusion as the
// attention layer's backward.

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

// Returns the first cudaError_t met (0 = success).  Workspace, all
// allocated by the caller (M = B·N): af [M, F] (the row partials of the dr₂
// pass, used only with rs_ff and drs_ff), dh [M, F], dz [M, C], dacc
// [M, HD], dq_part [ceil(N / 64)·M·HD] (the packed-row attention's dq
// partials, used only without extra and where N > 64, else null), dqkv
// [M, 3HD], dln [M, C], dbpart
// [wta::bwd_chunks(B, G, H)·G·H·N·N] (used only with extra and dextra;
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
