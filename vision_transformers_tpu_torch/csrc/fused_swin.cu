// The whole Swin layer on the feature map, forward and backward, float32,
// for Hopper (sm_90a):
//
//   o = roll(SwinLayer(roll(x, −s)), +s),   x, o [B, H, W, C]
//   SwinLayer: z = x + r₁ ⊙ OutProj(MHSA(QkvProj(LN₁(x)) + extra))
//              o = z + r₂ ⊙ (silu(LN₂(z)·W₁ + b₁)·W₂ + b₂)
//
// on window pairs, s = w/2 on shifted layers and 0 on the others.  Replaces
// the TPU (Pallas) kernels
//   vision_transformers_tpu/ops/fused_swin.py:99    _sw_fwd_kernel
//   vision_transformers_tpu/ops/fused_swin.py:200   _sw_bwd_kernel
// and computes what they compute: the output map and, backward, dx on the
// map, the gradients of both LayerNorms, of the four weights and their
// biases, of the bias extra [1 | G, H, m, m] and of both per-sample DropPath
// scales r₁, r₂ [B] (ops/fused_swin.py's docstring).
//
// Rows.  Pair (b, g = wy·wspp + p) is the p-th group of `pack` windows in
// window-row band wy: m = pack·w² tokens in the layout-native order
// t = r·(pack·w) + c (the JAX kernel's, fused_swin.py:30-35).  The rows
// are sample-major, row (b·G + g)·m + t, which is the JAX kernel's save
// layout [B, G, m, ·]; so a sample's rows are H·W consecutive rows, and the
// per-sample row scales ride in the GEMM epilogue (rs[m / (H·W)]) untiled.
// Pair b·G + g takes the bias extra[g] (extra[0] when it is one slab): the
// tensor-core window attention's cyclic layout (window_attention_tc.cuh,
// through vtx::window_attention_fwd / _bwd), whose dS sums over each group
// run over the samples in sample order.
//
// Map addressing instead of copies.  Token t of pair (b, g) lives at map
// pixel b·H·W + ((wy·w + r + s) mod H)·W + (p·pack·w + c + s) mod W: the
// roll by −s on the way in, and the roll by +s on the way out lands on the
// same pixel.  The wrapper hands the kernels that row → pixel table
// (ops/fused_swin.py::map_rows, int32 [H·W], one sample's), and the
// kernels that touch the map read or write it through the table (common.cuh
// MapRows, the MAP instantiations): in the forward, LN₁ reads x, the out
// projection's epilogue reads the residual x and the FF-out epilogue writes
// o — no roll, partition, unpartition or unroll pass remains.  In the
// backward do is gathered once into row order (gather_rows_kernel: the FF
// half's passes read it several times), LN₁'s recompute, its backward and
// its scale's gradient read x through the table, and dx = dz + LN₁ᵀ(dln₁)
// is written through it.
//
// The launch sequences are the whole layer's (fused_layer.cu
// transformer_layer; fused_layer1_bwd.cu transformer_layer_bwd) with the
// map as input and output:
//   forward   ln(map) → gemm(+bqkv) → attention(cyclic) → gemm(+bout, ×r₁,
//             +x(map)) → ln → gemm(+b₁, silu) → gemm(+b₂, ×r₂, +z) → o(map)
//             (training: hid keeps the pre-activation, af = silu(hid), and
//             the statistics and lse are saved)
//   backward  gather do → the FF half's steps 1-5 (vtx::ff_half_bwd) → the
//             out projection's (vtx::out_proj_bwd) → the attention's
//             (vtx::window_attention_bwd) → u₁ = LN₁(x(map)) from the saved
//             statistics, dW_qkv = u₁ᵀ·dqkv, db_qkv, dln₁ = dqkv·W_qkvᵀ →
//             LN₁'s backward writing dx(map), dg₁, db₁
//
// Determinism: as in fused_layer1_bwd.cu, every reduction over rows is a
// fixed-order two-pass sum (split-K slabs, row chunks, the per-sample dr
// sums, the per-group dS sums over chunks of samples, then over the chunks
// in order); no float atomics, so two runs of the backward are
// bit-identical.
//
// What bounds it on this card.  The arithmetic is the whole layer's: at
// Swin-S (F = 4C, HD = C, m = 98) the projection and FF GEMMs are ~93% of it,
// on the GEMM core (gemm_tc.cu, 3xTF32 on wgmma, 165 TFLOP/s f32-accurate at
// 700 W), and so is the attention (window_attention_tc.cuh, 3xTF32 on
// mma.sync, the same 165 TFLOP/s bound).  What this design removes is data
// movement around the layer: the torch roll, partition, unpartition and
// unroll passes over the map and their adjoints, ~4-8 map passes a layer each
// way.  What it adds is one table load and an integer division per row in the
// map-reading and map-writing passes.
//
// What later work changes: bf16 operands, and fewer launches.

#include "common.cuh"

namespace {

// dst[r, :] = src[map pixel of r, :] over M rows of C (the gather of do)
__global__ void __launch_bounds__(EW_THREADS)
gather_rows_kernel(const float* __restrict__ src, float* __restrict__ dst, int C,
                   long long total, MapRows rows_map) {
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= total) return;
  const int r = (int)(i / C), c = (int)(i % C);
  dst[i] = src[map_pixel(rows_map, r) * C + c];
}

// The map geometry's checks; returns the pairs P = B·G and the tokens m of
// a pair, or 0 when the map does not split into the window pairs
inline int swin_pairs(int B, int H, int W, int window, int pack, int* m_out) {
  if (B < 1 || window < 1 || pack < 1 || H % window || W % (pack * window)) return 0;
  if ((long long)B * H * W > 0x7fffffffLL) return 0;
  *m_out = pack * window * window;
  return B * (H / window) * (W / (pack * window));
}

cudaError_t swin_layer_fwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* extra, int groups, const float* rs_attn, const float* rs_ff,
    const int* pix, float* u, float* qkv, float* acc, float* z, float* hid,
    float* af, float* mu1, float* rstd1, float* lse, float* mu2, float* rstd2,
    float* out, int B, int H, int W, int C, int nh, int D, int F, int window,
    int pack, float scale, float eps, cudaStream_t s) {
  int m = 0;
  const int P = swin_pairs(B, H, W, window, pack, &m);
  if (!P || !pix || D > EXTRA_DMAX) return cudaErrorInvalidValue;
  const int hw = H * W, M = B * hw, HD = nh * D;
  const long long MF = (long long)M * F;
  const MapRows rows_map{pix, hw};
  // attention half: LN₁ off the map, the qkv projection, the attention over
  // the pairs, the out projection with r₁ and the residual read off the map
  VTX_CHECK(launch_ln_map(x, ln1_g, ln1_b, u, mu1, rstd1, M, C, eps, rows_map, s));
  VTX_CHECK(launch_gemm(u, wqkv, wqkv_s0, wqkv_s1, bqkv, nullptr, 1, nullptr, qkv, M,
                        3 * HD, C, 0, s));
  VTX_CHECK(vtx::window_attention_fwd(qkv, extra, groups, acc, lse, P, m, nh, D, scale,
                                      s));
  VTX_CHECK(launch_gemm_map<MAP_RES>(acc, wout, wout_s0, wout_s1, bout, rs_attn, hw, x,
                                     z, M, C, HD, 0, rows_map, s));
  // FF half: silu in the first GEMM's epilogue when nothing is saved; the
  // last GEMM writes o onto the map
  VTX_CHECK(launch_ln(z, ln2_g, ln2_b, u, mu2, rstd2, M, C, eps, s));
  VTX_CHECK(launch_gemm(u, w1, w1_s0, w1_s1, b1, nullptr, 1, nullptr, hid, M, F, C,
                        af ? 0 : 1, s));
  if (af) {
    act_kernel<ACT_SILU><<<ew_blocks(MF), EW_THREADS, 0, s>>>(hid, af, MF);
    VTX_CHECK(cudaGetLastError());
  }
  return launch_gemm_map<MAP_OUT>(af ? af : hid, w2, w2_s0, w2_s1, b2, rs_ff, hw, z, out,
                                  M, C, F, 0, rows_map, s);
}

cudaError_t swin_layer_bwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* extra, int groups, const float* rs_attn, const float* rs_ff,
    const int* pix, const float* qkv, const float* acc, const float* z,
    const float* hid, const float* mu1, const float* rstd1, const float* lse,
    const float* mu2, const float* rstd2, const float* dout,
    float* dor, float* da, float* af, float* dh, float* dz, float* dacc, float* dqkv,
    float* u, float* dln, float* dbpart, float* wpart,
    int splits_out, int splits_qkv, int splits_w1, int splits_w2, float* cpart,
    float* dx, float* dg1, float* db1, float* dwqkv, long long dwqkv_s0,
    long long dwqkv_s1, float* dbqkv, float* dwout, long long dwout_s0,
    long long dwout_s1, float* dbout, float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f,
    float* dextra, float* drs_attn, float* drs_ff,
    int B, int H, int W, int C, int nh, int D, int F, int window, int pack,
    float scale, cudaStream_t s) {
  int m = 0;
  const int P = swin_pairs(B, H, W, window, pack, &m);
  if (!P || !pix || D > EXTRA_DMAX || B > 65535) return cudaErrorInvalidValue;
  const int hw = H * W, M = B * hw, HD = nh * D;
  const long long MC = (long long)M * C;
  const MapRows rows_map{pix, hw};

  // do into row order, once
  gather_rows_kernel<<<ew_blocks(MC), EW_THREADS, 0, s>>>(dout, dor, C, MC, rows_map);
  VTX_CHECK(cudaGetLastError());

  // FF half, steps 1-5 of fused_layer1_bwd.cu, given do: → dz and the FF
  // parameters' gradients, dr₂ per sample (H·W rows each)
  VTX_CHECK(vtx::ff_half_bwd(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1,
                             b2, rs_ff, hw, hid, mu2, rstd2, dor, da, af, dh, u, dln,
                             wpart, splits_w1, splits_w2, cpart, dz, dg2, db2, dw1,
                             dw1_s0, dw1_s1, db1f, dw2, dw2_s0, dw2_s1, db2f, drs_ff, B,
                             M, C, F, ACT_SILU, s));

  // attention half, driven by dz: the out projection (dr₁ per sample), the
  // attention over the pairs (dS summed per group over the samples)
  VTX_CHECK(vtx::out_proj_bwd(acc, wout, wout_s0, wout_s1, bout, rs_attn, hw, dz, da,
                              dacc, wpart, splits_out, cpart, dwout, dwout_s0, dwout_s1,
                              dbout, drs_attn, B, M, C, HD, s));
  VTX_CHECK(vtx::window_attention_bwd(qkv, dacc, acc, lse, extra, groups, dbpart,
                                      dqkv, dextra, P, m, nh, D, scale, s));

  // the qkv projection and LN₁, x read off the map, dx written onto it
  ln_apply_kernel<true><<<ew_blocks(MC), EW_THREADS, 0, s>>>(x, mu1, rstd1, ln1_g, ln1_b,
                                                             u, C, MC, rows_map);
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK(launch_gemm_splitk(u, C, dqkv, 3 * HD, 1, wpart, splits_qkv, dwqkv, dwqkv_s0,
                               dwqkv_s1, C, 3 * HD, M, s));
  if (dbqkv)
    VTX_CHECK(launch_colsum(dqkv, nullptr, nullptr, nullptr, cpart, dbqkv, M, 3 * HD, s));
  VTX_CHECK(launch_gemm(dqkv, wqkv, wqkv_s1, wqkv_s0, nullptr, nullptr, 1, nullptr, dln,
                        M, C, 3 * HD, 0, s));
  ln_bwd_rows_kernel<true><<<cdiv(M, LN_THREADS / 32), LN_THREADS, 0, s>>>(
      dln, x, mu1, rstd1, ln1_g, dz, dx, M, C, rows_map);
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK(launch_colsum(dln, x, mu1, rstd1, cpart, dg1, M, C, s, rows_map));
  return launch_colsum(dln, nullptr, nullptr, nullptr, cpart, db1, M, C, s);
}

}  // namespace

// Returns the first cudaError_t met (0 = success).  x, out [B, H, W, C];
// extra [groups, nh, m, m] with groups = G = (H/w)·(W/(pack·w)) or 1, m =
// pack·w², heads up to 32 wide; pix the row → pixel table [H·W]; rs_attn /
// rs_ff [B] may be null.  u, qkv, acc, z [B·H·W, ·] and hid [B·H·W, F] are
// workspace the training forward keeps (rows sample-major, hid then the FF
// pre-activation); af [B·H·W, F], mu1, rstd1, mu2, rstd2 [B·H·W] and lse
// [B·G, nh, m] may be null (serving).
extern "C" int vtx_fused_swin_layer_fwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* extra, int groups, const float* rs_attn, const float* rs_ff,
    const int* pix, float* u, float* qkv, float* acc, float* z, float* hid, float* af,
    float* mu1, float* rstd1, float* lse, float* mu2, float* rstd2, float* out,
    int B, int H, int W, int C, int nh, int D, int F, int window, int pack, float scale,
    float eps, void* stream) {
  return static_cast<int>(swin_layer_fwd(
      x, ln1_g, ln1_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout, ln2_g,
      ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1, b2, extra, groups, rs_attn, rs_ff,
      pix, u, qkv, acc, z, hid, af, mu1, rstd1, lse, mu2, rstd2, out, B, H, W, C, nh, D,
      F, window, pack, scale, eps, static_cast<cudaStream_t>(stream)));
}

// Returns the first cudaError_t met (0 = success).  Reads the training
// forward's saves (qkv, acc, z, hid, mu1, rstd1, lse, mu2, rstd2) and dout
// [B, H, W, C]; writes dx [B, H, W, C].  Workspace, all allocated by the
// caller (M = B·H·W): dor [M, C], da [M, C] (used only with a row scale), af,
// dh [M, F], dz [M, C], dacc [M, HD], dqkv [M, 3HD], u, dln [M, C], dbpart
// [wta::bwd_chunks(B·G, groups, nh), groups, nh, m, m] (used only with dextra;
// ops/fused_layer.py window_chunks), wpart [max over
// the four weight gradients of splits·rows·cols], cpart [ceil(M / 128) ·
// max(C, 3HD, F)].  The weight gradients are written through their (row,
// col) strides; the biases, the row scales and the gradients dbqkv … db2f,
// dextra, drs_attn, drs_ff may be null.
extern "C" int vtx_fused_swin_layer_bwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1, const float* bqkv,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* extra, int groups, const float* rs_attn, const float* rs_ff,
    const int* pix, const float* qkv, const float* acc, const float* z, const float* hid,
    const float* mu1, const float* rstd1, const float* lse, const float* mu2,
    const float* rstd2, const float* dout,
    float* dor, float* da, float* af, float* dh, float* dz, float* dacc, float* dqkv,
    float* u, float* dln, float* dbpart, float* wpart,
    int splits_out, int splits_qkv, int splits_w1, int splits_w2, float* cpart,
    float* dx, float* dg1, float* db1, float* dwqkv, long long dwqkv_s0,
    long long dwqkv_s1, float* dbqkv, float* dwout, long long dwout_s0,
    long long dwout_s1, float* dbout, float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f,
    float* dextra, float* drs_attn, float* drs_ff,
    int B, int H, int W, int C, int nh, int D, int F, int window, int pack, float scale,
    void* stream) {
  return static_cast<int>(swin_layer_bwd(
      x, ln1_g, ln1_b, wqkv, wqkv_s0, wqkv_s1, bqkv, wout, wout_s0, wout_s1, bout, ln2_g,
      ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1, b2, extra, groups, rs_attn, rs_ff,
      pix, qkv, acc, z, hid, mu1, rstd1, lse, mu2, rstd2, dout, dor, da, af, dh, dz, dacc,
      dqkv, u, dln, dbpart, wpart, splits_out, splits_qkv, splits_w1, splits_w2,
      cpart, dx, dg1, db1, dwqkv, dwqkv_s0, dwqkv_s1, dbqkv, dwout, dwout_s0, dwout_s1,
      dbout, dg2, db2, dw1, dw1_s0, dw1_s1, db1f, dw2, dw2_s0, dw2_s1, db2f, dextra,
      drs_attn, drs_ff, B, H, W, C, nh, D, F, window, pack, scale,
      static_cast<cudaStream_t>(stream)));
}
