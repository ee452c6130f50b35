// Packed-qkv self-attention, forward and backward, float32, on Hopper's
// tensor cores (sm_90a):
//
//   out[b, :, h] = softmax(q_h·k_hᵀ·scale + extra[g(b), h])·v_h
//
// straight from the projection's output qkv [B, N, 3·H·D] (q-heads |
// k-heads | v-heads) into out [B, N, H·D], the out projection's input, so
// nothing is transposed on either side.  Replaces the TPU (Pallas) kernels
//   vision_transformers_tpu/ops/fused_attention.py:313   _qkv_fwd_kernel
//   vision_transformers_tpu/ops/fused_attention.py:342   _qkv_bwd_kernel
// at the sites that run them: ViT's training path with dropout (the JAX
// default from 32 rows and 128 tokens; B = 128, N = 197, H = 6, D = 64 at
// ViT-S/16) and Swin's forced 'fused' path (2048 / 512 / 128 / 64 rows of
// 98 / 98 / 98 / 49 tokens, D = 32, the grouped bias).  extra is the
// grouped bias [G, H, N, N], row b in group b / (B / G), heads up to 64
// wide.  The attention block B8 (vision_transformers_tpu/ops/fused_block.py:57
// / :100, ViT's and Swin's 'block' path) runs the same attention between two
// launches of the GEMM core (gemm_tc.cu): vtx_fused_attention_block_fwd /
// _bwd below.
//
// The kernels are attention_tc.cuh's, in 3xTF32 on the tensor cores (f32
// accuracy, mma_tf32.cuh), FlashAttention-2 in layout:
//
//   vtx_fused_attention_qkv_fwd  a block of 4 warps x 16 queries reads q
//                                straight from the packed rows; K / V tiles
//                                of 64 keys (the last padded to a multiple
//                                of 8: 197 → 200) staged with cp.async,
//                                double-buffered, each split into hi / lo
//                                once; S = q·kᵀ + extra, the online
//                                max-subtracted softmax on the accumulator
//                                fragments, O += P·V; lse [B, H, N] in the
//                                training instantiation
//   vtx_fused_attention_qkv_bwd  key-tile blocks walk all query tiles: per
//                                tile Δ = rowsum(do ⊙ out), S and P
//                                recomputed from lse, dv += Pᵀ·do, dP =
//                                do·vᵀ, dS = P ⊙ (dP − Δ), dk += dSᵀ·q·scale
//                                in registers, written once into dqkv; dq =
//                                dS·k·scale as a partial per key tile (4 at
//                                N = 197), summed in key-tile order into
//                                dqkv; with the bias, dS to dsbuf
//                                [B, H, N, N] and its ordered sum over each
//                                group's rows (common.cuh group_sum_kernel)
//
// dq by partials, not by a second query-tile pass: at ViT-S/16 the four
// partials are 155 MB written once and read once (~0.09 ms at 3.35 TB/s),
// where a second pass would recompute S and P (a third of the backward's
// products) and reload k and v for every query tile.  No float atomics, so
// the backward is bit-identical from run to run.
//
// What bounds it on this card.  At ViT-S/16 the forward does 4·B·H·N²·D =
// 7.6 GFLOP over 58 MB of qkv and out and the backward 10·B·H·N²·D = 19.1
// GFLOP: both bound by the f32-accurate tensor-core rate (495 / 3 = 165
// TFLOP/s at 700 W; 0.046 / 0.116 ms), against 0.017 / 0.035 ms of bytes.
// What the design does about it: every product runs on mma.sync in three
// TF32 passes (the f32 FMA kernels it replaces ran at 8-9 TFLOP/s), each
// reused operand is split once, P and dS go from the accumulators to the
// next product through registers, and 16-byte cp.async keeps the next tile
// in flight.
//
// What later work changes: wgmma tiles (V transposed K-major), bf16
// operands.  (B1's bias calls, B2's and B9's attention run on
// window_attention_tc.cuh, which keeps a group's bias resident over a chunk
// of windows instead of one (pair, head) a block.)

#include "attention_tc.cuh"

namespace {

cudaError_t check_dims(const float* extra, int groups, int B, int N, int H, int D) {
  if (B < 1 || N < 1 || H < 1 || D < 1 || D > DMAX || B > 65535 || H > 65535 ||
      (long long)B * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (extra && (groups < 1 || B % groups)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// q, k, v of the packed rows, extra as the grouped [G, H, N, N]
void packed(tca::Rows& q, tca::Rows& k, tca::Rows& v, tca::Bias& bias, const float* qkv,
            const float* extra, int groups, int B, int N, int H, int D) {
  const long long HD = (long long)H * D, rs = 3 * HD;
  q = tca::Rows{qkv, N * rs, D, rs};
  k = tca::Rows{qkv + HD, N * rs, D, rs};
  v = tca::Rows{qkv + 2 * HD, N * rs, D, rs};
  const long long NN = (long long)N * N;
  bias = tca::Bias{extra, extra ? B / groups : 1, H * NN, NN, N};
}

// the forward over the packed rows: out [B, N, H·D], lse or null
cudaError_t packed_fwd(const float* qkv, const float* extra, int groups, float* out,
                       float* lse, int B, int N, int H, int D, float scale, cudaStream_t s) {
  VTX_CHECK(check_dims(extra, groups, B, N, H, D));
  tca::FwdArgs a{};
  packed(a.q, a.k, a.v, a.bias, qkv, extra, groups, B, N, H, D);
  const long long HD = (long long)H * D;
  a.out = tca::WRows{out, N * HD, D, HD};
  a.lse = lse;
  a.M = a.N = N;
  a.D = D;
  a.scale = scale;
  return tca::attention_fwd(a, B, H, s);
}

// the backward: dqkv in the layout of qkv, and with a non-null dextra dS
// into dsbuf and its ordered sum over each group's rows into dextra
cudaError_t packed_bwd(const float* qkv, const float* extra, int groups, const float* out,
                       const float* lse, const float* dout, float* dq_part, float* dsbuf,
                       float* dqkv, float* dextra, int B, int N, int H, int D, float scale,
                       cudaStream_t s) {
  VTX_CHECK(check_dims(extra, groups, B, N, H, D));
  if (dextra && (!extra || !dsbuf)) return cudaErrorInvalidValue;
  const long long HD = (long long)H * D, rs = 3 * HD;
  tca::BwdArgs a{};
  packed(a.q, a.k, a.v, a.bias, qkv, extra, groups, B, N, H, D);
  a.o = tca::Rows{out, N * HD, D, HD};
  a.dout = tca::Rows{dout, N * HD, D, HD};
  a.lse = lse;
  a.dq = tca::WRows{dqkv, N * rs, D, rs};
  a.dk = tca::WRows{dqkv + HD, N * rs, D, rs};
  a.dv = tca::WRows{dqkv + 2 * HD, N * rs, D, rs};
  a.ds = dextra ? dsbuf : nullptr;
  a.M = a.N = N;
  a.D = D;
  a.scale = scale;
  VTX_CHECK(tca::attention_bwd(a, B, H, 1, dq_part, nullptr, s));
  if (dextra) {
    const long long per_row = (long long)H * N * N, total = groups * per_row;
    group_sum_kernel<<<ew_blocks(total), EW_THREADS, 0, s>>>(dsbuf, B / groups,
                                                                    per_row, total, dextra);
    VTX_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace

// The C entry points return the first cudaError_t met (0 = success).  qkv
// [B, N, 3·H·D]; extra [G, H, N, N] (groups = G) may be null; D ≤ 64.

// out [B, N, H·D]; lse [B, H, N] or null (no saves)
extern "C" int vtx_fused_attention_qkv_fwd(
    const float* qkv, const float* extra, int groups, float* out, float* lse,
    int B, int N, int H, int D, float scale, void* stream) {
  return static_cast<int>(packed_fwd(qkv, extra, groups, out, lse, B, N, H, D, scale,
                                     static_cast<cudaStream_t>(stream)));
}

// out and lse: the training forward's; dout [B, N, H·D].  Writes dqkv
// [B, N, 3·H·D] in the layout of qkv.  Workspace: dq_part [KT·B·N·H·D]
// for N > 64 (KT = ceil(N / 64) key tiles), else null; with extra and a
// non-null dextra [G, H, N, N], dsbuf [B, H, N, N]: dextra[g] is the sum of
// dS over the group's rows in row order.
extern "C" int vtx_fused_attention_qkv_bwd(
    const float* qkv, const float* extra, int groups, const float* out,
    const float* lse, const float* dout, float* dq_part, float* dsbuf, float* dqkv,
    float* dextra, int B, int N, int H, int D, float scale, void* stream) {
  return static_cast<int>(packed_bwd(qkv, extra, groups, out, lse, dout, dq_part, dsbuf,
                                     dqkv, dextra, B, N, H, D, scale,
                                     static_cast<cudaStream_t>(stream)));
}

// B8 (vision_transformers_tpu/ops/fused_block.py:57, _blk_fwd_kernel): out =
// OutProj(MHSA(x·Wqkv + bqkv + extra)) + bout, x [B, N, C] → out [B, N, Cout],
// no LN and no residual, as three launches: the GEMM core (gemm_tc.cu) with
// bqkv → qkv, the packed-qkv attention above → acc (and lse in training), the
// GEMM core with bout.  qkv [B, N, 3·H·D] and acc [B, N, H·D] are workspace
// the training forward keeps with lse [B, H, N] for the backward; lse may be
// null (serving).  extra [G, H, N, N] (groups = G), bqkv and bout may be
// null; heads up to 64 wide, with or without the bias.
extern "C" int vtx_fused_attention_block_fwd(
    const float* x, const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* bqkv, const float* wout, long long wout_s0, long long wout_s1,
    const float* bout, const float* extra, int groups, float* qkv, float* acc,
    float* lse, float* out, int B, int N, int C, int H, int D, int Cout, float scale,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VTX_CHECK(check_dims(extra, groups, B, N, H, D));
  const int M = B * N, HD = H * D;
  VTX_CHECK(launch_gemm(x, wqkv, wqkv_s0, wqkv_s1, bqkv, nullptr, 1, nullptr, qkv, M,
                        3 * HD, C, 0, s));
  VTX_CHECK(packed_fwd(qkv, extra, groups, acc, lse, B, N, H, D, scale, s));
  return static_cast<int>(launch_gemm(acc, wout, wout_s0, wout_s1, bout, nullptr, 1,
                                      nullptr, out, M, Cout, HD, 0, s));
}

// B8's backward (fused_block.py:100, _blk_bwd_kernel) on the forward's saves
// qkv, acc, lse and dout [B, N, Cout]:
//   1-2. dwout = accᵀ·dout and dbout = Σ_rows dout (split-K slabs and row
//        chunks summed in order); dacc = dout·woutᵀ  (vtx::out_proj_bwd)
//   3.   the packed-qkv attention's backward above → dqkv (Δ, the key-tile
//        pass with dq partials summed in key-tile order), and with extra and
//        a non-null dextra dS into dsbuf [B, H, N, N], summed over each
//        group's rows in row order into dextra [G, H, N, N]
//   4-5. dwqkv = xᵀ·dqkv, dbqkv = Σ_rows dqkv, dx = dqkv·wqkvᵀ
//        (vtx::qkv_in_bwd)
// Workspace, all allocated by the caller: dacc [B·N, H·D], dq_part
// [KT·B·N·H·D] for N > 64 (KT = ceil(N / 64)) else null, dqkv
// [B·N, 3·H·D], dsbuf (with dextra), wpart [max(splits_out·HD·Cout,
// splits_qkv·C·3HD)], cpart [ceil(B·N / 128) · max(Cout, 3HD)].  The weight
// gradients are written through their (row, col) strides; dbqkv, dbout
// (null where the bias is absent), extra, dsbuf and dextra may be null.  No
// float atomics, so the gradients are bit-identical from run to run.
extern "C" int vtx_fused_attention_block_bwd(
    const float* x, const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* wout, long long wout_s0, long long wout_s1, const float* extra,
    int groups, const float* qkv, const float* acc, const float* lse,
    const float* dout, float* dacc, float* dq_part, float* dqkv, float* dsbuf,
    float* wpart, int splits_out, int splits_qkv, float* cpart, float* dx,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1, float* dbqkv,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* dextra, int B, int N, int C, int H, int D, int Cout, float scale,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VTX_CHECK(check_dims(extra, groups, B, N, H, D));
  const int M = B * N, HD = H * D;
  VTX_CHECK(vtx::out_proj_bwd(acc, wout, wout_s0, wout_s1, nullptr, nullptr, N, dout,
                              dacc, wpart, splits_out, cpart, dwout, dwout_s0,
                              dwout_s1, dbout, nullptr, B, M, Cout, HD, s));
  VTX_CHECK(packed_bwd(qkv, extra, groups, acc, lse, dacc, dq_part, dsbuf, dqkv, dextra,
                       B, N, H, D, scale, s));
  return static_cast<int>(vtx::qkv_in_bwd(x, GemmExtra{}, wqkv, wqkv_s0, wqkv_s1, dqkv, wpart,
                                          splits_qkv, cpart, dwqkv, dwqkv_s0, dwqkv_s1,
                                          dbqkv, dx, M, C, HD, s));
}
