// The packed-row attention's bf16 form (attention_bf16_tma.cuh: wgmma fed
// by TMA), heads a multiple of 8 up to 64 wide, any N, with or without an
// additive bias [G, H, N, N] f32 and its gradient: the attention of B1's and
// B2's bf16 forms (fused_layer.cu, fused_layer_bwd.cu, fused_layer1_bwd.cu
// call vtx::packed_attention_fwd_bf16 / _bwd_bf16, declared in common.cuh;
// B1 with DINO's block mask, B2 with Swin's grouped bias) and the thin door chip_smoke.py times beside
// scaled_dot_product_attention (ops/fused_layer.py packed_attention_bf16 /
// _bwd).  A source of its own, so that nvcc builds it beside the others.

#include "attention_bf16_tma.cuh"

// The workspace of the backward, in floats: the L and Δ rows [B·H,
// ceil(N / 64), 2, 64], then, where N > 256 (the head's dq past what
// shared memory holds beside the rings), the key tiles' dq partials
// [ceil(N / 128), B·N, H·D], and with the bias's gradient (dbias) the
// chunks' dS sums [chunks, G, H, N, N]
long long vtx::packed_attention_bwd_bf16_floats(int B, int N, int H, int D, int G, int dbias) {
  const long long rows = 2LL * B * H * cdiv(N, abt::TQ) * abt::TQ;
  const long long dq = N > abt::DQ_SMEM_MAX_N ? (long long)cdiv(N, abt::TK) * B * N * H * D : 0;
  return rows + dq +
         (dbias ? (long long)bias_chunks(B, G, H) * G * H * N * N : 0);
}

namespace {

template <int NW, bool HAS_BIAS>
cudaError_t launch_fwd(abt::FwdParams& p, long long items, cudaStream_t s) {
  using namespace abt;
  constexpr int SMEM = FwdTiles<NW>::SMEM;
  static_assert(SMEM <= 227 * 1024, "a block's shared memory");
  static bool sized = false;  // the attribute once per instantiation
  if (!sized) {
    VTX_CHECK(cudaFuncSetAttribute(bf16_attn_fwd_kernel<NW, HAS_BIAS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
    sized = true;
  }
  const int sms = sm_count();  // persistent blocks: one an SM
  if (!sms) return cudaErrorInvalidDevice;
  bf16_attn_fwd_kernel<NW, HAS_BIAS><<<(int)(items < sms ? items : sms), THREADS, SMEM, s>>>(p);
  return cudaGetLastError();
}

template <int DQ, bool HAS_BIAS, bool DBIAS = false>
cudaError_t launch_bwd(const abt::BwdParams& p, int items, cudaStream_t s) {
  using namespace abt;
  static bool sized = false;  // the attribute once per instantiation
  if (!sized) {
    VTX_CHECK(cudaFuncSetAttribute(bf16_attn_bwd_kernel<DQ, HAS_BIAS, DBIAS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bwd_smem(DBIAS ? TK : DQ_SMEM_MAX_N, DQ, DBIAS)));
    sized = true;
  }
  const int sms = sm_count();
  if (!sms) return cudaErrorInvalidDevice;
  const int grid = items < sms ? items : sms;
  bf16_attn_bwd_kernel<DQ, HAS_BIAS, DBIAS><<<grid, THREADS, bwd_smem(p.N, DQ, DBIAS), s>>>(p);
  return cudaGetLastError();
}

// the bias [G, H, N, N]: null, or G ≥ 1 groups dividing the batch
inline bool bias_ok(const float* bias, int groups, int B) {
  return !bias || (groups >= 1 && B % groups == 0);
}

}  // namespace

// The forward: out [B, N, H·D] bf16 and lse [B, H, N] f32 when non-null;
// key tiles of 128, or one of 208 where 192 < N ≤ 208 without a bias; bias
// [G, H, N, N] f32 or null (groups = G; image b takes group b / (B / G)).
// A bias call takes the 128-key tiles at every N: the 208-key tile's scores
// beside the bias's loads spilled (ptxas: 576 bytes)
cudaError_t vtx::packed_attention_fwd_bf16(const bf16* qkv, const float* bias, int groups,
                                           bf16* out, float* lse, int B, int N, int H, int D,
                                           float scale, cudaStream_t s) {
  using namespace abt;
  VTX_CHECK(check(qkv, out, B, N, H, D));
  if (!bias_ok(bias, groups, B)) return cudaErrorInvalidValue;
  const long long HD = (long long)H * D;
  FwdParams p{};
  if (!head_map(&p.qkv, qkv, B, N, 3 * H, D, 3 * HD, TQF) ||
      !head_map(&p.out, out, B, N, H, D, HD, 64))
    return cudaErrorInvalidValue;  // raised by the caller: no other path is taken
  const bool wide = N > 192 && N <= 208;
  p.lse = lse;
  p.N = N;
  p.H = H;
  p.QT = cdiv(N, TQF);
  p.KT = wide && !bias ? 1 : cdiv(N, TK);
  const long long items = (long long)B * H * p.QT;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.items = (int)items;
  p.scale2 = scale * LOG2E;
  p.bias = bias;
  p.per_group = bias ? B / groups : B;
  if (bias) return launch_fwd<0, true>(p, items, s);
  return wide ? launch_fwd<208, false>(p, items, s) : launch_fwd<0, false>(p, items, s);
}

// The backward: dqkv bf16 in the layout of qkv from the forward's out and
// lse and dout [B, N, H·D], P recomputed with the forward's bias; ws the
// workspace of vtx::packed_attention_bwd_bf16_floats.  dbias [G, H, N, N]
// f32 (with the bias, N ≤ 128) takes the bias's gradient, the sum of dS
// over each group's images (per chunk of them, then over the chunks in
// order); null, none
cudaError_t vtx::packed_attention_bwd_bf16(const bf16* qkv, const float* bias, int groups,
                                           const bf16* out, const float* lse,
                                           const bf16* dout, float* ws, bf16* dqkv,
                                           float* dbias, int B, int N, int H, int D,
                                           float scale, cudaStream_t s) {
  using namespace abt;
  VTX_CHECK(check(qkv, dqkv, B, N, H, D));
  VTX_CHECK(check(out, dout, B, N, H, D));
  if (!lse || !ws || !aligned16(ws) || !bias_ok(bias, groups, B) ||
      (dbias && (!bias || N > TK)))
    return cudaErrorInvalidValue;
  const long long HD = (long long)H * D;
  BwdParams p{};
  if (!head_map(&p.kv, qkv, B, N, 3 * H, D, 3 * HD, TK) ||
      !head_map(&p.q, qkv, B, N, 3 * H, D, 3 * HD, TQ) ||
      !head_map(&p.dout, dout, B, N, H, D, HD, TQ))
    return cudaErrorInvalidValue;
  p.B = B;
  p.N = N;
  p.H = H;
  p.D = D;
  p.QT = cdiv(N, TQ);
  p.KT = cdiv(N, TK);
  p.scale = scale;
  p.scale2 = scale * LOG2E;
  float* rows = ws;
  p.rows = rows;
  p.dqkv = dqkv;
  p.dq_part = ws + 2LL * B * H * p.QT * TQ;
  p.bias = bias;
  p.per_group = bias ? B / groups : B;
  if ((long long)B * p.QT > 0x7fffffffLL || TQ * H * 4 > 48 * 1024) return cudaErrorInvalidValue;
  bf16_attn_rows_kernel<<<B * p.QT, 256, TQ * H * 4, s>>>(out, dout, lse, rows, N, H, D, p.QT);
  VTX_CHECK(cudaGetLastError());
  if (dbias) {  // one key tile: dq straight to dqkv; the chunks' dS sums, then their sum
    p.G = groups;
    p.chunks = bias_chunks(B, groups, H);
    p.per_chunk = cdiv(p.per_group, p.chunks);
    p.dbias_part = p.dq_part;
    const long long items = (long long)p.chunks * groups * H;
    if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
    VTX_CHECK((launch_bwd<DQ_TO_ROWS, true, true>(p, (int)items, s)));
    return launch_splitk_reduce(p.dbias_part, p.chunks, groups * H * N, N, dbias, N, 1, s);
  }
  const int items = B * H;
  const bool dq_smem = N <= DQ_SMEM_MAX_N;
  if (dq_smem)
    VTX_CHECK((bias ? launch_bwd<DQ_IN_SMEM, true>(p, items, s)
                    : launch_bwd<DQ_IN_SMEM, false>(p, items, s)));
  else
    VTX_CHECK((bias ? launch_bwd<DQ_TO_PART, true>(p, items, s)
                    : launch_bwd<DQ_TO_PART, false>(p, items, s)));
  if (!dq_smem)  // the key tiles' partials in order, rounded once
    VTX_CHECK(launch_splitk_reduce(p.dq_part, p.KT, B * N, (int)HD, dqkv, 3 * HD, 1, s));
  return cudaSuccess;
}

// The C entry points return the first cudaError_t met (0 = success).  qkv
// [B, N, 3·H·D] bf16, 16-byte aligned; D a multiple of 8, at most 64; bias
// [G, H, N, N] f32 or null (groups = G, dividing B).

// The thin door chip_smoke.py times beside scaled_dot_product_attention:
// out [B, N, H·D], lse [B, H, N] or null ...
extern "C" int vtx_packed_attention_fwd_bf16(const bf16* qkv, const float* bias, int groups,
                                             bf16* out, float* lse, int B, int N, int H, int D,
                                             float scale, void* stream) {
  return static_cast<int>(vtx::packed_attention_fwd_bf16(
      qkv, bias, groups, out, lse, B, N, H, D, scale, static_cast<cudaStream_t>(stream)));
}

// ... and the backward: dqkv from out, lse and dout; dq_part the workspace
// (vtx::packed_attention_bwd_bf16_floats floats: the L and Δ rows, the dq
// partials where N > 256, the dbias chunks' sums); dbias [G, H, N, N] f32
// or null (with the bias, N ≤ 128)
extern "C" int vtx_packed_attention_bwd_bf16(const bf16* qkv, const float* bias, int groups,
                                             const bf16* out, const float* lse,
                                             const bf16* dout, float* dq_part, bf16* dqkv,
                                             float* dbias, int B, int N, int H, int D,
                                             float scale, void* stream) {
  return static_cast<int>(vtx::packed_attention_bwd_bf16(
      qkv, bias, groups, out, lse, dout, dq_part, dqkv, dbias, B, N, H, D, scale,
      static_cast<cudaStream_t>(stream)));
}
