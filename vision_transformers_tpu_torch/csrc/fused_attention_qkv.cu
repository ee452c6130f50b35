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
// wide.
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
// operands, B1 and B8 (D = 64) moved onto this core.

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

}  // namespace

// The C entry points return the first cudaError_t met (0 = success).  qkv
// [B, N, 3·H·D]; extra [G, H, N, N] (groups = G) may be null; D ≤ 64.

// out [B, N, H·D]; lse [B, H, N] or null (no saves)
extern "C" int vtx_fused_attention_qkv_fwd(
    const float* qkv, const float* extra, int groups, float* out, float* lse,
    int B, int N, int H, int D, float scale, void* stream) {
  VTX_CHECK(check_dims(extra, groups, B, N, H, D));
  tca::FwdArgs a{};
  packed(a.q, a.k, a.v, a.bias, qkv, extra, groups, B, N, H, D);
  const long long HD = (long long)H * D;
  a.out = tca::WRows{out, N * HD, D, HD};
  a.lse = lse;
  a.M = a.N = N;
  a.D = D;
  a.scale = scale;
  return static_cast<int>(tca::attention_fwd(a, B, H, static_cast<cudaStream_t>(stream)));
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
  VTX_CHECK(check_dims(extra, groups, B, N, H, D));
  if (dextra && (!extra || !dsbuf)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
    group_sum_kernel<false><<<ew_blocks(total), EW_THREADS, 0, s>>>(dsbuf, B / groups,
                                                                    per_row, total, dextra);
    VTX_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}
