// Attention on Hopper's tensor cores, float32 (sm_90a): the one source that
// compiles the attention core attention_tc.cuh, for the ops below (B3, B8,
// the bias-free attention of B1 and B2 at f32, and B6).
//
// 1. Packed-qkv self-attention, forward and backward:
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
// wide.  The same attention, declared in common.cuh as
// vtx::packed_attention_fwd / _bwd, runs
//   - inside the attention block B8 (ViT's and Swin's 'block' path,
//     vision_transformers_tpu/ops/fused_block.py:57 / :100), between two
//     launches of the GEMM core (gemm_tc.cu): vtx_fused_attention_block_fwd
//     / _bwd below;
//   - as the bias-free attention of B1 (fused_layer.cu, fused_layer_bwd.cu:
//     ViT-S/16's training layers, B = 128, N = 197, H = 6, D = 64, and
//     Twins-SVT-S's last stage, N = 49, D = 32) and of B2 (ViT's eval
//     layers), so that no attention in the port runs on f32 FMAs.
//
// The kernels are attention_tc.cuh's, in 3xTF32 on the tensor cores (f32
// accuracy, mma_tf32.cuh), FlashAttention-2 in layout:
//
//   vtx_fused_attention_qkv_fwd  a block of 8 warps x 16 queries reads q
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
//                                group's rows (group_sum_kernel below)
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
// The bf16 form of this attention (B1's and B2's bias-free attention at
// the JAX package's default precision) is a core of its own on wgmma fed by
// TMA (attention_bf16_tma.cuh, compiled into attention_bf16.cu), not an
// instantiation of this one.  B1's bias calls, B2's and B9's attention with
// a bias run on window_attention_tc.cuh, which keeps a group's bias
// resident over a chunk of windows instead of one (pair, head) a block.
//
// What later work changes: wgmma tiles for the f32 form too (V transposed
// K-major).
//
// 2. Reduced-kv attention (B6), forward and backward:
//
//   out[b, g] = softmax(q[b, g]·k[b, g]ᵀ·scale + extra[g])·v[b, g]
//
// with q [B, G, M, D] and k, v [B, G, N, D], M ≠ N.  Replaces the TPU (Pallas)
// kernels
//   vision_transformers_tpu/ops/fused_attention.py:67   _fwd_kernel
//   vision_transformers_tpu/ops/fused_attention.py:92   _bwd_kernel
// at the sites that run them: PVT's spatial-reduction attention (M = the
// stage's tokens, N = the conv-reduced ones, 49 or 50) and Twins' global
// sub-sampled attention (N = 64 down to 1).  extra, the JAX kernel's
// additive bias broadcastable to [G, M, N], is read in place through its
// (g, m) strides (unit stride along N).
//
// Operands are strided: element (b, g, r, d) of q, k, v and do at
// p[b·sb + g·sg + r·sr + d], so the heads of a projection's [B, rows, G·D]
// output (PVT's linear_q, the two halves of linear_kv) are read in place.
// out and dq are written as [B, M, G, D] (the order the output projection
// reads and the q projection's gradient has), dk / dv as [2, B, N, G, D].
// The kernels are attention_tc.cuh's, in 3xTF32 on the tensor cores (f32
// accuracy, mma_tf32.cuh):
//
//   vtx_fused_attention_fwd   a block owns one (b, g) and a run of 64-query
//                             tiles; K / V (N ≤ 64: every model's call) are
//                             staged once with cp.async and split into hi /
//                             lo halves for the run, the next query tile is
//                             prefetched while one computes; S = q·kᵀ, the
//                             exact softmax on the accumulator fragments,
//                             O = P·V; the training forward writes lse
//                             [B, G, M]
//   vtx_fused_attention_bwd   one pass: a block owns the keys of one (b, g)
//                             and a chunk of query tiles; per tile Δ =
//                             rowsum(do ⊙ out), P from lse, dS, the complete
//                             dq = dS·k·scale straight to [B, M, G, D], and
//                             dk, dv accumulated in registers over the chunk;
//                             the chunks' partials summed in chunk order
//                             (common.cuh splitk_reduce_kernel); with extra,
//                             dS [B, G, M, N] summed over b in b order into
//                             dextra [G, M, N]
// No float atomics anywhere, so the backward is bit-identical from run to run.
//
// What bounds it on this card.  The forward does 4·B·G·M·N·D operations
// against 4·B·G·(2·M + 2·N)·D bytes moved: at PVT-S stage 1 (128 images,
// M = 3136, N = 49, D = 64) 5.0 GFLOP against 0.2 GB, so the memory rate
// (3.35 TB/s, 0.062 ms) bounds it, not the f32-accurate tensor-core rate
// (165 TFLOP/s, 0.030 ms); the backward (10·B·G·M·N·D, q, k, v, out, do
// read, dq, dk, dv written) likewise.  What the design does about it: each
// of q, do and out is read once, k and v once per block, through 16-byte
// cp.async, and S, P, dS never leave the chip.  The trouble spot is the
// parallelism: at PVT-S stage 1 there are only B·G = 128 (image, head)
// pairs for 132 SMs, so the forward gives each pair a few blocks of query
// tiles and the backward splits the query axis into chunks (about two waves
// of blocks) whose dk / dv partials are summed in order afterwards.  N = 1
// (Twins stage 4) is a tile of one key: p ≡ 1, dS = 0 up to rounding.
//
// What later work changes: wgmma tiles, bf16 operands.

#include "attention_tc.cuh"

namespace {

cudaError_t check_dims(const float* extra, int groups, int B, int N, int H, int D) {
  if (B < 1 || N < 1 || H < 1 || D < 1 || D > DMAX || B > 65535 || H > 65535 ||
      (long long)B * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (extra && (groups < 1 || B % groups)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The grouped bias's gradient: dextra[g, h, q, k] = Σ_{r < R} ds[g·R + r,
// h, q, k], R = B / G rows per group, summed in r order (one thread per
// output element)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(EW_THREADS)
group_sum_kernel(const float* __restrict__ ds, int R, long long per_row,
                 long long total, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (e >= total) return;
  const long long g = e / per_row, rem = e % per_row;
  const float* src = ds + g * R * per_row + rem;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += src[(long long)r * per_row];
  out[e] = s;
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

cudaError_t check_sra_dims(int B, int G, int M, int N, int D) {
  if (B < 1 || G < 1 || M < 1 || N < 1 || D < 1 || D > DMAX || B > 65535 ||
      G > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

tca::Bias extra_bias(const float* extra, long long e_sg, long long e_sm) {
  return tca::Bias{extra, 1, 0, e_sg, e_sm};
}

}  // namespace

// The packed-row attention (common.cuh): the forward, out [B, N, H·D] and lse
// or null ...
cudaError_t vtx::packed_attention_fwd(const float* qkv, const float* extra, int groups,
                                      float* out, float* lse, int B, int N, int H, int D,
                                      float scale, cudaStream_t s) {
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

// ... and the backward: dqkv in the layout of qkv, and with a non-null
// dextra dS into dsbuf and its ordered sum over each group's rows into dextra
cudaError_t vtx::packed_attention_bwd(const float* qkv, const float* extra, int groups,
                                      const float* out, const float* lse, const float* dout,
                                      float* dq_part, float* dsbuf, float* dqkv,
                                      float* dextra, int B, int N, int H, int D, float scale,
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

// The C entry points return the first cudaError_t met (0 = success).  qkv
// [B, N, 3·H·D]; extra [G, H, N, N] (groups = G) may be null; D ≤ 64.

// out [B, N, H·D]; lse [B, H, N] or null (no saves)
extern "C" int vtx_fused_attention_qkv_fwd(
    const float* qkv, const float* extra, int groups, float* out, float* lse,
    int B, int N, int H, int D, float scale, void* stream) {
  return static_cast<int>(vtx::packed_attention_fwd(qkv, extra, groups, out, lse, B, N, H,
                                                    D, scale,
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
  return static_cast<int>(vtx::packed_attention_bwd(qkv, extra, groups, out, lse, dout,
                                                    dq_part, dsbuf, dqkv, dextra, B, N, H,
                                                    D, scale,
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
  VTX_CHECK(vtx::packed_attention_fwd(qkv, extra, groups, acc, lse, B, N, H, D, scale, s));
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
  VTX_CHECK(vtx::packed_attention_bwd(qkv, extra, groups, acc, lse, dacc, dq_part, dsbuf,
                                      dqkv, dextra, B, N, H, D, scale, s));
  return static_cast<int>(vtx::qkv_in_bwd(x, GemmExtra{}, wqkv, wqkv_s0, wqkv_s1, dqkv, wpart,
                                          splits_qkv, cpart, dwqkv, dwqkv_s0, dwqkv_s1,
                                          dbqkv, dx, M, C, HD, s));
}

// B6, the reduced-kv attention.
// The C entry points return the first cudaError_t met (0 = success).  q, k,
// v (and do) are given by their base pointer and their (b, g, row) strides
// in elements, unit stride along D; D ≤ 64.  extra (nullable) is element
// (g, m, n) at extra[g·e_sg + m·e_sm + n].

// out [B, M, G, D]; lse [B, G, M] or null (no saves)
extern "C" int vtx_fused_attention_fwd(
    const float* q, long long q_sb, long long q_sg, long long q_sm,
    const float* k, long long k_sb, long long k_sg, long long k_sn,
    const float* v, long long v_sb, long long v_sg, long long v_sn,
    const float* extra, long long e_sg, long long e_sm,
    float* out, float* lse, int B, int G, int M, int N, int D, float scale,
    void* stream) {
  VTX_CHECK(check_sra_dims(B, G, M, N, D));
  tca::FwdArgs a{};
  a.q = tca::Rows{q, q_sb, q_sg, q_sm};
  a.k = tca::Rows{k, k_sb, k_sg, k_sn};
  a.v = tca::Rows{v, v_sb, v_sg, v_sn};
  a.out = tca::WRows{out, (long long)M * G * D, D, (long long)G * D};
  a.lse = lse;
  a.bias = extra_bias(extra, e_sg, e_sm);
  a.M = M;
  a.N = N;
  a.D = D;
  a.scale = scale;
  return static_cast<int>(tca::attention_fwd(a, B, G, static_cast<cudaStream_t>(stream)));
}

// out and lse: the training forward's.  Workspace: dq_part [KT·B·M·G·D] for
// N > 64 (KT = ceil(N / 64) key tiles), else null; dkv_part
// [2·chunks·B·N·G·D] for chunks > 1 (1 ≤ chunks ≤ ceil(M / 64) query
// chunks), else null; dsbuf [B·G·M·N] with a non-null dextra.  Writes dq
// [B, M, G, D], dkv [2, B, N, G, D] (dk, then dv) and, when non-null (with
// extra), dextra [G, M, N] = Σ_b dS.
extern "C" int vtx_fused_attention_bwd(
    const float* q, long long q_sb, long long q_sg, long long q_sm,
    const float* k, long long k_sb, long long k_sg, long long k_sn,
    const float* v, long long v_sb, long long v_sg, long long v_sn,
    const float* extra, long long e_sg, long long e_sm,
    const float* out, const float* lse,
    const float* dout, long long do_sb, long long do_sg, long long do_sm,
    float* dq_part, float* dkv_part, int chunks, float* dsbuf,
    float* dq, float* dkv, float* dextra,
    int B, int G, int M, int N, int D, float scale, void* stream) {
  VTX_CHECK(check_sra_dims(B, G, M, N, D));
  if (2LL * B * N * G * D > 0x7fffffffLL || (long long)G * M * N > 0x7fffffffLL ||
      (dextra && (!extra || !dsbuf)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long GD = (long long)G * D;
  tca::BwdArgs a{};
  a.q = tca::Rows{q, q_sb, q_sg, q_sm};
  a.k = tca::Rows{k, k_sb, k_sg, k_sn};
  a.v = tca::Rows{v, v_sb, v_sg, v_sn};
  a.o = tca::Rows{out, M * GD, D, GD};
  a.dout = tca::Rows{dout, do_sb, do_sg, do_sm};
  a.lse = lse;
  a.bias = extra_bias(extra, e_sg, e_sm);
  a.dq = tca::WRows{dq, M * GD, D, GD};
  a.dk = tca::WRows{dkv, N * GD, D, GD};
  a.dv = tca::WRows{dkv + B * N * GD, N * GD, D, GD};
  a.ds = dextra ? dsbuf : nullptr;
  a.M = M;
  a.N = N;
  a.D = D;
  a.scale = scale;
  VTX_CHECK(tca::attention_bwd(a, B, G, chunks, dq_part, dkv_part, s));
  if (dextra)  // Σ_b dS in b order
    VTX_CHECK(launch_splitk_reduce(dsbuf, B, 1, (int)((long long)G * M * N), dextra, 0, 1,
                                   s));
  return cudaSuccess;
}
