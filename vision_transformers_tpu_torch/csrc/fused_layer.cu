// Forward kernels of the pre-LN transformer layer, float32, for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels
//   vision_transformers_tpu/ops/fused_layer.py:116   _attn_layer_fwd_kernel
//       z = x + r ⊙ OutProj(MHSA(QkvProj(LN1(x))))
//   vision_transformers_tpu/ops/fused_layer1.py:91   _l1_fwd_kernel
//       o = z + (silu(LN2(z)·W1 + b1)·W2 + b2)
//   vision_transformers_tpu/ops/fused_layer.py:701   _ff_fwd_kernel
//       o = x + r ⊙ (act(LN(x)·W1 + b1)·W2 + b2), act silu or tanh-gelu
// with one C entry point per op, each a short sequence of hand-written
// launches on the caller's stream:
//   vtx_fused_attention_layer_fwd   = ln_rows → gemm(+bqkv) → attention → gemm(+bout, ×r, +x)
//   vtx_fused_transformer_layer_fwd = the above → ln_stats → gemm(LN₂ staged, +b1[, silu])
//                                     → gemm(act staged, +b2, ×r₂, +z)
//   vtx_fused_ff_layer_fwd          = ln_stats → gemm(LN staged, +b1[, silu])
//                                     → gemm(act staged, +b2, ×r, +x)
// (gemm: the GEMM core, gemm_tc.cu; "staged": applied by its producer, so
// LN₂(z) and act(hid) are never written)
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
// AV about 0.7, so the layer is bound by the GEMMs' arithmetic.  The
// projections run on the GEMM core (gemm_tc.cu: 3xTF32 on wgmma, f32
// accurate, bound at 165 TFLOP/s).  With a bias over windows of up to 128
// tokens and heads up to 32 wide (Twins' pair mask in B1, Swin's grouped
// bias in B2 and B9) the attention runs on the tensor-core window attention
// (window_attention_tc.cuh: 3xTF32 on mma.sync, the same 165 TFLOP/s bound):
// a block owns one (group, head) and a chunk of its windows with the bias
// resident, and a window's softmax is exact in one pass.  Every other call
// (ViT's B1 and B2, N = 197, D = 64; Twins' last stage, N = 49, D = 32; and
// DINO's packed local crops, N = 111, D = 64, with the block-diagonal −1e9
// mask as the bias, added in f32 after the product) runs on B3's packed-row
// core (attention_tc.cuh, compiled into fused_attention_qkv.cu and called
// through vtx::packed_attention_fwd: 3xTF32 on mma.sync, the same bound):
// 8-warp blocks of 128 queries, K / V tiles of 64 keys double-buffered
// through 16-byte cp.async and split into hi / lo once, the online softmax
// on the accumulator fragments, P to the next product through registers;
// it never stores an N x N matrix, so any N works.  No attention of the
// layer runs on f32 FMAs.
//
// bf16 (vtx_fused_attention_layer_fwd_bf16, vtx_fused_transformer_layer_
// fwd_bf16: the JAX package's default precision — ViT-S/16's training
// forward and its eval's whole layer, bias-free; DINO's student, B1 with
// the block mask as the bias on its packed local crops; Swin-S's whole
// layer with the grouped bias, training and eval).  The same sequences on the
// bf16 forms of the passes and cores: x, the weights and biases, u, qkv,
// acc, z, hid and out bf16; the LN parameters, statistics, row scales and
// lse f32.  Each step rounds where the JAX kernels round (fused_layer.py:
// 116-166, fused_layer1.py:91-171): u = LN(x) rounded by the LN pass; qkv,
// the out projection's branch and the residual by the GEMM core's bf16
// epilogue (round(round(acc) + b), × round(rs) rounded, + x rounded); the
// attention's out on the packed-row core's bf16 form
// (attention_bf16_tma.cuh, the bias added to the scores in f32 before the
// max, as the JAX kernel adds it; at bf16 every bias call takes this core:
// the window attention has no bf16 form);
// LN₂(z) by the LN pass; hid = round(silu(round(round(acc) + b₁))) in FF1's
// epilogue when serving, and FF2's as the out projection's.  The bf16 whole
// layer's training forward (Swin-S at bf16, with the grouped bias and both
// row scales) keeps hid = round(round(acc) + b₁), the pre-activation, and
// af = round(silu(hid)) comes from a pass (the JAX kernel's _act_fwd(hid)
// .astype(bf16), fused_layer1.py:148); it saves qkv, acc, z, hid, the
// LN₁ / LN₂ statistics and lse as its f32 form does.
//
// What later work changes: fusing each op's launch sequence into fewer
// launches so intermediates stay on chip.
//
// B7 (the FF residual branch alone, under the FF-kernel switch) is the
// whole layer's FF half: the LN statistics, a GEMM that applies the LN as
// it stages its input, with b₁ (and silu in its epilogue when nothing is
// saved), and a GEMM that applies the activation as it stages hid, with b₂,
// the row scale and the residual; at
// ViT-S/16's 25,216 rows its 4·M·C·F = 59.5 GFLOP of GEMM bound it (~0.36
// ms at the GEMM core's 165 TFLOP/s).  B3 (the packed-qkv attention alone)
// and B8 (the attention block) have their own tensor-core attention in
// fused_attention_qkv.cu.
//
// Numerics follow the JAX kernels: LN statistics in f32 in the fast-variance
// form E[x²]−μ² (fused_layer.py:69-76), f32 accumulation, softmax in f32.
// Weights are read through (row, col) strides, so a transposed view
// (torch's Linear.weight.t()) is consumed in place, without a copy.

#include "window_attention_tc.cuh"

namespace {

// The attention of qkv [B·N, 3·H·D] → out [B·N, H·D] (and lse [B, H, N]
// when non-null), both on the tensor cores.  extra [G, H, N, N] or null; row
// (window) b in group b / (B / G).  A bias call the window attention takes
// (window_on_bias: N ≤ 128, heads up to 32 wide — Twins' pair mask, Swin's
// grouped bias) runs there; every other call (ViT's without a bias, Twins'
// last stage, DINO's packed local crops with their block mask at heads 64
// wide) on the packed-row attention core (vtx::packed_attention_fwd,
// fused_attention_qkv.cu: any N, heads up to DMAX = 64 wide, the bias added
// in f32 after the 3xTF32 product).
cudaError_t launch_attention(const float* qkv, const float* extra, int groups,
                             float* out, float* lse, int B, int N, int H, int D,
                             float scale, cudaStream_t stream) {
  if (window_on_bias(extra, N, D))
    return wta::attention_fwd(qkv, extra, groups, false, out, lse, B, N, H, D, scale,
                              stream);
  return vtx::packed_attention_fwd(qkv, extra, groups, out, lse, B, N, H, D, scale,
                                   stream);
}

// z = x + rs ⊙ OutProj(MHSA(QkvProj(LN(x)) + extra)), writing u, qkv, acc
// on the way (and mu, rstd, lse when non-null); rs (per sample, N rows
// each) may be null
cudaError_t attention_half(
    const float* x, const float* ln_g, const float* ln_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* extra, int groups, const float* rs, float* u, float* qkv,
    float* acc, float* mu, float* rstd, float* lse, float* z, int B, int N,
    int C, int H, int D, float scale, float eps, cudaStream_t stream) {
  const int M = B * N, HD = H * D;
  VTX_CHECK(launch_ln(x, ln_g, ln_b, u, mu, rstd, M, C, eps, stream));
  VTX_CHECK(launch_gemm(u, wqkv, wqkv_s0, wqkv_s1, bqkv, nullptr, 1, nullptr, qkv, M,
                        3 * HD, C, 0, stream));
  VTX_CHECK(launch_attention(qkv, extra, groups, acc, lse, B, N, H, D, scale, stream));
  return launch_gemm(acc, wout, wout_s0, wout_s1, bout, rs, N, x, z, M, C, HD, 0, stream);
}

// The bf16 attention half: LN pass → GEMM(+bqkv) → the packed-row core
// (with the bias extra [G, H, N, N] or null) → GEMM(+bout, ×r, +x), every
// activation bf16
cudaError_t attention_half_bf16(
    const bf16* x, const float* ln_g, const float* ln_b,
    const bf16* wqkv, long long wqkv_s0, long long wqkv_s1, const bf16* bqkv,
    const bf16* wout, long long wout_s0, long long wout_s1, const bf16* bout,
    const float* extra, int groups,
    const float* rs, bf16* u, bf16* qkv, bf16* acc, float* mu, float* rstd, float* lse,
    bf16* z, int B, int N, int C, int H, int D, float scale, float eps, cudaStream_t stream) {
  const int M = B * N, HD = H * D;
  VTX_CHECK(launch_ln(x, ln_g, ln_b, u, mu, rstd, M, C, eps, stream));
  VTX_CHECK(launch_gemm_bf16(u, wqkv, wqkv_s0, wqkv_s1, bqkv, nullptr, 1, nullptr, qkv, 0, M,
                             3 * HD, C, 0, stream));
  VTX_CHECK(vtx::packed_attention_fwd_bf16(qkv, extra, groups, acc, lse, B, N, H, D, scale,
                                           stream));
  return launch_gemm_bf16(acc, wout, wout_s0, wout_s1, bout, rs, N, x, z, 0, M, C, HD, 0,
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
  // serving (no saves): the LN₂ statistics in u, free once the qkv GEMM
  // has read it
  const int M = B * N;
  return vtx::ff_half_fwd(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1, b2,
                          rs_ff, N, hid, af, mu2 ? mu2 : u, mu2 ? rstd2 : u + M, out, M, C,
                          F, eps, ACT_SILU, af != nullptr, s);
}

}  // namespace

// The statistics pass, FF1 with LN₂ applied as its producer stages z (where
// z's tiles meet few output tiles; else LN₂(z) into out, written last), FF2
// with act applied as its producer stages hid (training, or gelu); serving
// with silu keeps it in FF1's epilogue
cudaError_t vtx::ff_half_fwd(
    const float* z, const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs_ff, int rows_per_scale, float* hid, float* af, float* mu2,
    float* rstd2, float* out, int M, int C, int F, float eps, int act, int save,
    cudaStream_t s) {
  if ((act != ACT_SILU && act != ACT_GELU) || !mu2 || !rstd2) return cudaErrorInvalidValue;
  const bool epilogue_silu = act == ACT_SILU && !save;
  GemmExtra ln;
  const float* u = z;
  if (gemm_col_tiles(F) <= STAGE_TILES) {
    VTX_CHECK(launch_ln_stats(z, mu2, rstd2, M, C, eps, s));
    ln.ln_mu = mu2;
    ln.ln_rstd = rstd2;
    ln.ln_g = ln2_g;
    ln.ln_b = ln2_b;
  } else {
    VTX_CHECK(launch_ln(z, ln2_g, ln2_b, out, mu2, rstd2, M, C, eps, s));
    u = out;
  }
  VTX_CHECK(launch_gemm_x(u, w1, w1_s0, w1_s1, b1, nullptr, 1, nullptr, hid, M, F, C,
                          epilogue_silu ? 1 : 0, ln, s));
  GemmExtra a;
  const float* h = hid;
  if (!epilogue_silu && af && gemm_col_tiles(C) > STAGE_ACT_TILES) {
    const long long MF = (long long)M * F;
    if (act == ACT_SILU)
      act_kernel<ACT_SILU><<<ew_blocks(MF), EW_THREADS, 0, s>>>(hid, af, MF);
    else
      act_kernel<ACT_GELU><<<ew_blocks(MF), EW_THREADS, 0, s>>>(hid, af, MF);
    VTX_CHECK(cudaGetLastError());
    h = af;
  } else if (!epilogue_silu) {
    a.a_act = act;
  }
  return launch_gemm_x(h, w2, w2_s0, w2_s1, b2, rs_ff, rows_per_scale, z, out, M, C, F, 0, a,
                       s);
}

// The bf16 FF half, serving with silu: LN₂(z) into out (written last), FF1
// with silu in its epilogue into hid, FF2 with the residual
cudaError_t vtx::ff_half_fwd_bf16(const bf16* z, const float* ln2_g, const float* ln2_b,
                                  const bf16* w1, long long w1_s0, long long w1_s1,
                                  const bf16* b1, const bf16* w2, long long w2_s0,
                                  long long w2_s1, const bf16* b2, const float* rs_ff,
                                  int rows_per_scale, bf16* hid, bf16* out, int M, int C,
                                  int F, float eps, cudaStream_t s) {
  VTX_CHECK(launch_ln(z, ln2_g, ln2_b, out, static_cast<float*>(nullptr),
                      static_cast<float*>(nullptr), M, C, eps, s));
  VTX_CHECK(launch_gemm_bf16(out, w1, w1_s0, w1_s1, b1, nullptr, 1, nullptr, hid, 0, M, F, C,
                             1, s));
  return launch_gemm_bf16(hid, w2, w2_s0, w2_s1, b2, rs_ff, rows_per_scale, z, out, 0, M, C,
                          F, 0, s);
}

// B9's attention (common.cuh): pair p of the P = B·G sample-major pairs
// takes extra[p mod groups]
cudaError_t vtx::window_attention_fwd(const float* qkv, const float* extra, int groups,
                                      float* out, float* lse, int P, int N, int H,
                                      int D, float scale, cudaStream_t s) {
  return wta::attention_fwd(qkv, extra, groups, true, out, lse, P, N, H, D, scale, s);
}

// The bf16 FF half in training (B2's bf16 training forward): LN₂(z) rounded
// into out (written last) with its statistics saved; FF1 writes hid, the
// pre-activation round(round(acc) + b₁); af = round(silu(hid)) by a pass
// (the bf16 GEMM core's TMA producer stages no transform); FF2 with the
// residual
cudaError_t vtx::ff_half_train_bf16(const bf16* z, const float* ln2_g, const float* ln2_b,
                                    const bf16* w1, long long w1_s0, long long w1_s1,
                                    const bf16* b1, const bf16* w2, long long w2_s0,
                                    long long w2_s1, const bf16* b2, const float* rs_ff,
                                    int rows_per_scale, bf16* hid, bf16* af, float* mu2,
                                    float* rstd2, bf16* out, int M, int C, int F, float eps,
                                    cudaStream_t s) {
  VTX_CHECK(launch_ln(z, ln2_g, ln2_b, out, mu2, rstd2, M, C, eps, s));
  VTX_CHECK(launch_gemm_bf16(out, w1, w1_s0, w1_s1, b1, nullptr, 1, nullptr, hid, 0, M, F, C,
                             0, s));
  const long long MF = (long long)M * F;
  act_bf16_kernel<ACT_SILU><<<ew_blocks(MF), EW_THREADS, 0, s>>>(hid, af, MF);
  VTX_CHECK(cudaGetLastError());
  return launch_gemm_bf16(af, w2, w2_s0, w2_s1, b2, rs_ff, rows_per_scale, z, out, 0, M, C, F,
                          0, s);
}

// The C entry points return the first cudaError_t met (0 = success).
// extra [G, H, N, N] (groups = G; heads up to 64 wide, window_on_bias), rs, mu,
// rstd and lse may be null: the serving forward passes none of the last four.

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
// mu1, rstd1 [M], lse [B, H, N], mu2, rstd2 [M] may be null; af [M, F]
// non-null asks for the training saves (and is the act pass's workspace
// where FF2 would stage it over many tiles); u, qkv, acc, z, hid are
// workspace the training forward keeps (hid then holds the FF
// pre-activation; serving puts the LN₂ statistics in u).
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

// The window attention alone (window_attention_tc.cuh), the thin door that
// ops/window_attention.py gives chip_smoke.py and the card's tests: out
// [P·N, H·D] and, when lse is non-null, lse [P, H, N] from qkv [P·N, 3·H·D]
// and the bias [G, H, N, N]; window p in group p / (P/G), or p mod G when
// ``cyclic``.
extern "C" int vtx_window_attention_fwd(const float* qkv, const float* bias, int groups,
                                        int cyclic, float* out, float* lse, int P, int N,
                                        int H, int D, float scale, void* stream) {
  return static_cast<int>(wta::attention_fwd(qkv, bias, groups, cyclic != 0, out, lse, P,
                                             N, H, D, scale,
                                             static_cast<cudaStream_t>(stream)));
}

// B7: the pre-LN FF residual branch out = x + rs ⊙ (act(LN(x)·W₁ + b₁)·W₂ + b₂)
// over M = B·N rows, rs [B] per sample (N rows each), act 0 = silu, 1 =
// tanh-gelu.  u [M, C] (serving: the statistics' workspace) and hid [M, F]
// are workspace; in training (af [M, F] non-null: the act pass's workspace
// where FF2 would stage it over many tiles) hid keeps the pre-activation
// and mu / rstd [M] are saved for the backward (fused_layer1_bwd.cu).  b1,
// b2, rs, af, mu and rstd may be null.
extern "C" int vtx_fused_ff_layer_fwd(
    const float* x, const float* ln_g, const float* ln_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* rs, float* u, float* hid, float* af, float* mu, float* rstd,
    float* out, int B, int N, int C, int F, int act, float eps, void* stream) {
  if (B < 1 || N < 1 || (long long)B * N > 0x7fffffffLL || C < 2)
    return cudaErrorInvalidValue;
  const int M = B * N;
  // serving (no saves): the statistics in u
  return static_cast<int>(vtx::ff_half_fwd(
      x, ln_g, ln_b, w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1, b2, rs, N, hid, af,
      mu ? mu : u, mu ? rstd : u + M, out, M, C, F, eps, act, af != nullptr,
      static_cast<cudaStream_t>(stream)));
}

// The bf16 forms (the JAX package's default precision): the same parameter
// lists, the activations, weights and biases bf16 (the LN parameters, rs,
// mu, rstd and lse f32).  Each takes the bias extra [G, H, N, N] f32
// (groups = G, dividing B) or null, and the training saves as its f32 form
// does: B1 mu, rstd, lse; the whole layer, with af [M, F] bf16 non-null
// (the workspace of round(silu(hid))), all five statistics, hid keeping the
// pre-activation; serving passes none of them.
extern "C" int vtx_fused_attention_layer_fwd_bf16(
    const bf16* x, const float* ln_g, const float* ln_b,
    const bf16* wqkv, long long wqkv_s0, long long wqkv_s1, const bf16* bqkv,
    const bf16* wout, long long wout_s0, long long wout_s1, const bf16* bout,
    const float* extra, int groups, const float* rs, bf16* u, bf16* qkv,
    bf16* acc, float* mu, float* rstd, float* lse, bf16* out, int B, int N, int C,
    int H, int D, float scale, float eps, void* stream) {
  if (extra && (groups < 1 || B % groups)) return cudaErrorInvalidValue;
  return static_cast<int>(attention_half_bf16(
      x, ln_g, ln_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout, extra, groups,
      rs, u, qkv, acc, mu, rstd, lse, out, B, N, C, H, D, scale, eps,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int vtx_fused_transformer_layer_fwd_bf16(
    const bf16* x, const float* ln1_g, const float* ln1_b,
    const bf16* wqkv, long long wqkv_s0, long long wqkv_s1, const bf16* bqkv,
    const bf16* wout, long long wout_s0, long long wout_s1, const bf16* bout,
    const float* ln2_g, const float* ln2_b,
    const bf16* w1, long long w1_s0, long long w1_s1, const bf16* b1,
    const bf16* w2, long long w2_s0, long long w2_s1, const bf16* b2,
    const float* extra, int groups, const float* rs_attn, const float* rs_ff,
    bf16* u, bf16* qkv, bf16* acc, bf16* z, bf16* hid, bf16* af,
    float* mu1, float* rstd1, float* lse, float* mu2, float* rstd2, bf16* out,
    int B, int N, int C, int H, int D, int F, float scale, float eps,
    void* stream) {
  const bool save = af != nullptr;
  if ((extra && (groups < 1 || B % groups)) ||
      (save ? !(mu1 && rstd1 && lse && mu2 && rstd2) : (mu1 || rstd1 || lse || mu2 || rstd2)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VTX_CHECK(attention_half_bf16(x, ln1_g, ln1_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0,
                                wout_s1, bout, extra, groups, rs_attn, u, qkv, acc, mu1, rstd1,
                                lse, z, B, N, C, H, D, scale, eps, s));
  if (save)
    return static_cast<int>(vtx::ff_half_train_bf16(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0,
                                               w2_s1, b2, rs_ff, N, hid, af, mu2, rstd2, out,
                                               B * N, C, F, eps, s));
  return static_cast<int>(vtx::ff_half_fwd_bf16(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0,
                                           w2_s1, b2, rs_ff, N, hid, out, B * N, C, F, eps, s));
}
