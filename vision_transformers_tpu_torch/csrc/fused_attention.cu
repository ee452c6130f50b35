// Reduced-kv attention, forward and backward, float32, on Hopper's tensor
// cores (sm_90a):
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

cudaError_t check_dims(int B, int G, int M, int N, int D) {
  if (B < 1 || G < 1 || M < 1 || N < 1 || D < 1 || D > DMAX || B > 65535 ||
      G > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

tca::Bias extra_bias(const float* extra, long long e_sg, long long e_sm) {
  return tca::Bias{extra, 1, 0, e_sg, e_sm};
}

}  // namespace

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
  VTX_CHECK(check_dims(B, G, M, N, D));
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
  VTX_CHECK(check_dims(B, G, M, N, D));
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
