// Halo windowed attention and the whole Halo layer, float32, for Hopper
// (sm_90a).
//
// Replaces the TPU (Pallas) kernels
//   vision_transformers_tpu/ops/fused_halo_layer.py:92   _hl_fwd_kernel
//   vision_transformers_tpu/ops/fused_halo_layer.py:179  _hl_bwd_kernel
//       the whole Halo layer off the feature map x [B, H, W, C]:
//       z = x + r₁ ⊙ OutProj(HaloAttn(QkvProj(LN₁(x)) + bias))   (qkv: no bias)
//       o = z + r₂ ⊙ (silu(LN₂(z)·W₁ + b₁)·W₂ + b₂)
//   vision_transformers_tpu/ops/fused_halo.py:252  _direct_fwd_kernel
//   vision_transformers_tpu/ops/fused_halo.py:282  _direct_bwd_kernel
//       the attention alone, straight off q [B, H, W, C] and kv [B, H, W, 2C]
//       (k lanes, then v lanes)
//   vision_transformers_tpu/ops/fused_halo.py:44   _fwd_kernel
//   vision_transformers_tpu/ops/fused_halo.py:72   _bwd_kernel
//       the attention on gathered neighbourhoods: q [B', M, C] (a window's
//       queries), kv [B', N, 2C] (its neighbourhood, zero rows outside the
//       map), bias [heads, M, N]
// with six C entry points, each a short sequence of launches on the
// caller's stream:
//   vtx_fused_halo_layer_fwd      ln_rows → gemm (qkv) → halo attention (+ lse)
//                                 → gemm (+bout, ×r₁, +x) → ln_rows →
//                                 gemm (+b₁, silu) → gemm (+b₂, ×r₂, +z)
//   vtx_fused_halo_layer_bwd      the FF half and the out projection's
//                                 backward as the whole transformer layer's
//                                 (fused_layer1_bwd.cu, fused_layer_bwd.cu),
//                                 then the halo attention backward (dq, dk /
//                                 dv per window, the dbias partials), the
//                                 dkv fold, the ordered dbias sum, the qkv
//                                 projection's and LN₁'s backward
//   vtx_halo_attention_direct_fwd the halo attention (+ lse)
//   vtx_halo_attention_direct_bwd the halo attention backward, the fold and
//                                 the dbias sum
//   vtx_halo_attention_fwd        the gathered halo attention (+ lse)
//   vtx_halo_attention_bwd        the gathered backward (dk / dv straight
//                                 into dkv [B', N, 2C], no fold) and the
//                                 dbias sum
//
// Halo attention.  Windows are w x w tiles of the map; the w² queries of a
// window attend to the k² keys of its neighbourhood, the k x k square
// (k = w + 2·halo) centred on the window, and every score carries the
// relative-position bias [heads, w², k²].  Neighbourhood positions outside
// the map are ZERO keys and values, not masked ones: the reference
// zero-pads the projected kv (halo_transformer.py; fused_halo_layer.py:81-89),
// so such a position scores 0·scale + bias and takes softmax mass.  The
// attention reads q / k / v straight from the maps by (image, y, x) with a
// row stride, so the whole layer's packed qkv [M, 3HD] and the direct op's
// two maps go through the same kernels.  The Pallas layer kernel LNs the
// zero-padded band and masks kv afterwards; here LN₁ and the qkv GEMM run
// once over the unpadded map and out-of-map positions read as zeros: the
// same values, without LN(0).
//
// The attention itself, forward and backward, is halo_attention_tc.cuh's:
// two tensor-core kernels (3xTF32 mma.sync), a block per head and chunk of
// windows with the head's bias tile resident in shared memory, one pass per
// window in each direction, Δ = rowsum(do ⊙ out) in the backward's
// prologue.  The backward writes dk / dv of each window to the per-window
// buffer dkvw [B·S, k², 2HD] (S windows per image); then
//   fold      each token's dk / dv are the sum over the ≤ 2 x 2 windows
//             whose neighbourhood holds it (2·halo ≤ w), gathered from dkvw
//             in window order; out-of-map positions are dropped (their k and
//             v were zeros, not functions of x), their dS still feeds dbias.
//   dbias     the blocks' partials summed in block order.
// No float atomics anywhere, so the backward is bit-identical from run to
// run.
//
// What bounds it on this card.  At Halo-S (window 8, halo 2, D = 32,
// k² = 144) the layer's four projection GEMMs are 24·M·C² operations
// forward (116 GFLOP per layer at 128 images, the same at each stage), on
// the GEMM core (gemm_tc.cu, 3xTF32 on wgmma), and the halo attention
// (4·M·k²·HD, 28.9 GFLOP at stage 1) on the tensor cores too: all of it is
// bound at 165 TFLOP/s f32-accurate at 700 W.  The
// per-window dkvw buffer costs B·S·k²·2HD floats written and read once
// (0.9 GB at stage 1 for 128 images) instead of atomics.
//
// The gathered entries run the same two attention kernels with GATHER =
// true, a template parameter that changes only the addressing: window j's
// queries are rows j·M … j·M+M−1 of q and its keys and values rows j·N …
// of kv, every position is read (out-of-map positions are the zero rows
// the gather wrote), and the backward writes each window's rows of dkv in
// place, so the fold (the gather's adjoint) stays outside the kernel, in
// torch, as in the JAX package.  M ≤ 64 queries per window, any N (more
// than one resident tile of keys streams).  The gathered kv at Halo-S stage
// 1 (B' = 8192 windows, M 64, N 144, C 96) is 906 MB against the map's 201
// MB of q.
//
// What later work changes: wgmma tiles for the attention products, the
// attention fused into the qkv GEMM's consumer, bf16 operands.

#include "halo_attention_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// fold: out[token·os + lane] = Σ dkvw[(b·S + win)·k² + j(token, win), lane]
// over the windows whose neighbourhood holds the token, in window order
// (lanes: 2HD, dk then dv)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__global__ void __launch_bounds__(EW_THREADS)
halo_fold_kernel(const float* __restrict__ dkvw, HaloGeom g, int lanes,
                 long long total, float* __restrict__ out, int os) {
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= total) return;
  const int lane = i % lanes;
  const long long m = i / lanes;
  const long long HW = (long long)g.H * g.W;
  const long long b = m / HW;
  const int tok = m % HW, y = tok / g.W, x = tok % g.W;
  const int nk = g.k * g.k, S = g.hs * g.ws;
  // window wy holds row y iff 0 ≤ y + halo − wy·w < k
  const int wy0 = max(0, floor_div(y + g.halo - g.k, g.w) + 1);
  const int wy1 = min(g.hs - 1, (y + g.halo) / g.w);
  const int wx0 = max(0, floor_div(x + g.halo - g.k, g.w) + 1);
  const int wx1 = min(g.ws - 1, (x + g.halo) / g.w);
  float s = 0.f;
  for (int wy = wy0; wy <= wy1; ++wy)
    for (int wx = wx0; wx <= wx1; ++wx) {
      const int j = (y + g.halo - wy * g.w) * g.k + (x + g.halo - wx * g.w);
      s += dkvw[((b * S + wy * g.ws + wx) * nk + j) * lanes + lane];
    }
  out[m * os + lane] = s;
}

// ---------------------------------------------------------------------------
// launch sequences
// ---------------------------------------------------------------------------

// the map problem: 2·halo ≤ w (each token in ≤ 2 x 2 neighbourhoods), w² ≤ 64
cudaError_t check_geom(const HaloGeom& g, int B, int nh, int D) {
  if (D < 1 || D > 64 || g.w < 1 || g.w * g.w > 64 || g.halo < 0 || 2 * g.halo > g.w ||
      g.H % g.w || g.W % g.w || B < 1 || nh < 1 ||
      (long long)B * g.hs * g.ws > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// q [row·qs + h·D + d], k / v [row·kvs + h·D + d], out [row·HD + h·D + d],
// lse [B, heads, qn] (may be null); GATHER: B is the number of windows B'
template <bool GATHER = false>
cudaError_t halo_attention_fwd(const float* q, int qs, const float* k, const float* v,
                               int kvs, const float* bias, float* out, float* lse,
                               int B, const HaloGeom& g, int nh, int D, float scale,
                               cudaStream_t s) {
  if (!GATHER) VTX_CHECK(check_geom(g, B, nh, D));
  hta::FwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.qs = qs;
  a.kvs = kvs;
  a.bias = bias;
  a.out = out;
  a.lse = lse;
  a.g = g;
  a.nh = nh;
  a.D = D;
  a.pairs = B * g.hs * g.ws;
  a.scale = scale;
  return hta::attention_fwd<GATHER>(a, s);
}

// out, dout [row·HD + h·D + d] and lse: the training forward's and its
// gradient; dq [row·dqs + h·D + d], dkv [token·dkvs + lane] (2HD lanes),
// dbias [heads, w², k²]; workspace dkvw [B·S·k²·2HD], part
// [chunks·heads·w²·k²], dq_part [key tiles·rows·HD] (null with one key
// tile).  GATHER: dkvw is dkv itself [B', N, 2HD], and nothing is folded.
template <bool GATHER = false>
cudaError_t halo_attention_bwd(const float* q, int qs, const float* k, const float* v,
                               int kvs, const float* bias, const float* out,
                               const float* dout, const float* lse, float* dkvw,
                               float* part, int chunks, float* dq_part, float* dq,
                               int dqs, float* dkv, int dkvs, float* dbias, int B,
                               const HaloGeom& g, int nh, int D, float scale,
                               cudaStream_t s) {
  if (!GATHER) VTX_CHECK(check_geom(g, B, nh, D));
  const int pairs = B * g.hs * g.ws, HD = nh * D;
  hta::BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.qs = qs;
  a.kvs = kvs;
  a.bias = bias;
  a.out = out;
  a.dout = dout;
  a.lse = lse;
  a.dq = dq;
  a.dqs = dqs;
  a.dkv = dkvw;
  a.part = part;
  a.g = g;
  a.nh = nh;
  a.D = D;
  a.pairs = pairs;
  a.scale = scale;
  VTX_CHECK(hta::attention_bwd<GATHER>(a, chunks, dq_part, (long long)B * g.qn, s));
  if (!GATHER) {
    const long long total = (long long)B * g.H * g.W * 2 * HD;
    halo_fold_kernel<<<ew_blocks(total), EW_THREADS, 0, s>>>(dkvw, g, 2 * HD, total,
                                                            dkv, dkvs);
    VTX_CHECK(cudaGetLastError());
  }
  return launch_splitk_reduce(part, chunks, 1, nh * g.nq * g.nk, dbias, 0, 1, s);
}

}  // namespace

// The C entry points return the first cudaError_t met (0 = success).  Maps
// are NHWC, M = B·H·W tokens, HD = heads·D; lse is [B, heads, H·W].  The
// whole layer takes heads up to 32 wide (its GEMM tiles), the attention
// alone up to 64.

// x [M, C]; qkv has no bias; rs_attn / rs_ff [B] and the saves af [M, F],
// mu1, rstd1, lse, mu2, rstd2 may be null (serving); u, qkv, acc, z, hid are
// workspace the training forward keeps (hid then holds the FF
// pre-activation).
extern "C" int vtx_fused_halo_layer_fwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* bias, const float* rs_attn, const float* rs_ff,
    float* u, float* qkv, float* acc, float* z, float* hid, float* af,
    float* mu1, float* rstd1, float* lse, float* mu2, float* rstd2, float* out,
    int B, int H, int W, int C, int nh, int D, int F, int window, int halo,
    float scale, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HaloGeom g = halo_geom(H, W, window, halo);
  const int N = H * W, M = B * N, HD = nh * D;
  if (D > 32) return static_cast<int>(cudaErrorInvalidValue);
  VTX_CHECK(launch_ln(x, ln1_g, ln1_b, u, mu1, rstd1, M, C, eps, s));
  VTX_CHECK(launch_gemm(u, wqkv, wqkv_s0, wqkv_s1, nullptr, nullptr, 1, nullptr,
                        qkv, M, 3 * HD, C, 0, s));
  VTX_CHECK(halo_attention_fwd(qkv, 3 * HD, qkv + HD, qkv + 2 * HD, 3 * HD, bias,
                               acc, lse, B, g, nh, D, scale, s));
  VTX_CHECK(launch_gemm(acc, wout, wout_s0, wout_s1, bout, rs_attn, N, x, z, M, C,
                        HD, 0, s));
  return static_cast<int>(vtx::ff_half_fwd(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2,
                                           w2_s0, w2_s1, b2, rs_ff, N, u, hid, af,
                                           mu2, rstd2, out, M, C, F, eps, ACT_SILU,
                                           s));
}

// Workspace, all allocated by the caller: da [M, C] (used only with a row
// scale), af [M, F], dh [M, F], dz [M, C], dacc [M, HD], dq_part [key
// tiles·M·HD] (null with one key tile of the attention's backward), dqkv
// [M, 3HD], u [M, C], dln [M, C], dkvw [B·S·k²·2HD], part
// [chunks·heads·w²·k²], wpart [max over the four weight gradients of
// splits·rows·cols], cpart [ceil(M / 128) · max(C, 3HD, F)].  The weight
// gradients are written through their (row, col) strides; bout, b1, b2,
// the row scales and their gradients may be null.
extern "C" int vtx_fused_halo_layer_bwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* bias, const float* rs_attn, const float* rs_ff,
    const float* qkv, const float* acc, const float* z, const float* hid,
    const float* mu1, const float* rstd1, const float* lse, const float* mu2,
    const float* rstd2, const float* dout,
    float* da, float* af, float* dh, float* dz, float* dacc, float* dq_part,
    float* dqkv, float* u, float* dln, float* dkvw, float* part, int chunks,
    float* wpart, int splits_out, int splits_qkv, int splits_w1, int splits_w2,
    float* cpart,
    float* dx, float* dg1, float* db1,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f,
    float* dbias, float* drs_attn, float* drs_ff,
    int B, int H, int W, int C, int nh, int D, int F, int window, int halo,
    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HaloGeom g = halo_geom(H, W, window, halo);
  const int N = H * W, M = B * N, HD = nh * D;
  if (D > 32) return static_cast<int>(cudaErrorInvalidValue);
  // FF half, given do → dz
  VTX_CHECK(vtx::ff_half_bwd(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0,
                             w2_s1, b2, rs_ff, N, hid, mu2, rstd2, dout, da, af,
                             dh, u, dln, wpart, splits_w1, splits_w2, cpart, dz,
                             dg2, db2, dw1, dw1_s0, dw1_s1, db1f, dw2, dw2_s0,
                             dw2_s1, db2f, drs_ff, B, M, C, F, ACT_SILU, s));
  // the out projection → dacc
  VTX_CHECK(vtx::out_proj_bwd(acc, wout, wout_s0, wout_s1, bout, rs_attn, N, dz, da,
                              dacc, wpart, splits_out, cpart, dwout, dwout_s0,
                              dwout_s1, dbout, drs_attn, B, M, C, HD, s));
  // halo attention → dqkv, dbias
  VTX_CHECK(halo_attention_bwd(qkv, 3 * HD, qkv + HD, qkv + 2 * HD, 3 * HD, bias, acc,
                               dacc, lse, dkvw, part, chunks, dq_part, dqkv, 3 * HD,
                               dqkv + HD, 3 * HD, dbias, B, g, nh, D, scale, s));
  // the qkv projection (no bias) and LN₁, with the residual dz
  return static_cast<int>(vtx::qkv_proj_bwd(
      x, ln1_g, ln1_b, mu1, rstd1, wqkv, wqkv_s0, wqkv_s1, dqkv, dz, u, dln, wpart,
      splits_qkv, cpart, dx, dg1, db1, dwqkv, dwqkv_s0, dwqkv_s1, nullptr, M, C, HD,
      s));
}

// q [M, HD], kv [M, 2HD] (k lanes, then v lanes), bias [heads, w², k²];
// out [M, HD]; lse may be null (no saves)
extern "C" int vtx_halo_attention_direct_fwd(
    const float* q, const float* kv, const float* bias, float* out, float* lse,
    int B, int H, int W, int nh, int D, int window, int halo, float scale,
    void* stream) {
  const int HD = nh * D;
  return static_cast<int>(halo_attention_fwd(
      q, HD, kv, kv + HD, 2 * HD, bias, out, lse, B, halo_geom(H, W, window, halo),
      nh, D, scale, static_cast<cudaStream_t>(stream)));
}

// out and lse: the training forward's; workspace dkvw [B·S·k²·2HD], part
// [chunks·heads·w²·k²], dq_part [key tiles·M·HD] (null with one key tile);
// dq [M, HD], dkv [M, 2HD], dbias [heads, w², k²]
extern "C" int vtx_halo_attention_direct_bwd(
    const float* q, const float* kv, const float* bias, const float* out,
    const float* lse, const float* dout, float* dkvw, float* part, int chunks,
    float* dq_part, float* dq, float* dkv, float* dbias, int B, int H, int W, int nh,
    int D, int window, int halo, float scale, void* stream) {
  const int HD = nh * D;
  return static_cast<int>(halo_attention_bwd(
      q, HD, kv, kv + HD, 2 * HD, bias, out, dout, lse, dkvw, part, chunks, dq_part, dq,
      HD, dkv, 2 * HD, dbias, B, halo_geom(H, W, window, halo), nh, D, scale,
      static_cast<cudaStream_t>(stream)));
}

// The gathered halo attention (B5b): q [B', M, HD] (a window's queries), kv
// [B', N, 2HD] (its neighbourhood, k lanes then v lanes, zero rows outside
// the map), bias [heads, M, N]; out [B', M, HD]; lse [B', heads, M] may be
// null (no saves)
extern "C" int vtx_halo_attention_fwd(
    const float* q, const float* kv, const float* bias, float* out, float* lse,
    int B, int M, int N, int nh, int D, float scale, void* stream) {
  const int HD = nh * D;
  return static_cast<int>(halo_attention_fwd<true>(
      q, HD, kv, kv + HD, 2 * HD, bias, out, lse, B, gather_geom(M, N), nh, D, scale,
      static_cast<cudaStream_t>(stream)));
}

// out and lse: the training forward's; workspace part [chunks·heads·M·N],
// dq_part [key tiles·B'·M·HD] (null with one key tile); dq [B', M, HD], dkv
// [B', N, 2HD] (every row written), dbias [heads, M, N] (the blocks'
// partials summed in block order)
extern "C" int vtx_halo_attention_bwd(
    const float* q, const float* kv, const float* bias, const float* out,
    const float* lse, const float* dout, float* part, int chunks, float* dq_part,
    float* dq, float* dkv, float* dbias, int B, int M, int N, int nh, int D,
    float scale, void* stream) {
  const int HD = nh * D;
  if (B < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(halo_attention_bwd<true>(
      q, HD, kv, kv + HD, 2 * HD, bias, out, dout, lse, dkv, part, chunks, dq_part, dq,
      HD, dkv, 2 * HD, dbias, B, gather_geom(M, N), nh, D, scale,
      static_cast<cudaStream_t>(stream)));
}
