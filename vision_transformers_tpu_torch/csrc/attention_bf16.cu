// The packed-row attention's bf16 form (attention_bf16_tma.cuh: wgmma fed
// by TMA), bias-free, heads a multiple of 8 up to 64 wide, any N: the
// attention of B1's and B2's bf16 forms (fused_layer.cu, fused_layer_bwd.cu
// call vtx::packed_attention_fwd_bf16 / _bwd_bf16, declared in common.cuh)
// and the thin door chip_smoke.py times beside scaled_dot_product_attention
// (ops/fused_layer.py packed_attention_bf16 / _bwd).  A source of its own,
// so that nvcc builds it beside the others.

#include "attention_bf16_tma.cuh"

// The workspace of the backward, in floats: the L and Δ rows [B·H,
// ceil(N / 64), 2, 64], then, where N > 256 (the head's dq past what
// shared memory holds beside the rings), the key tiles' dq partials
// [ceil(N / 128), B·N, H·D]
long long vtx::packed_attention_bwd_bf16_floats(int B, int N, int H, int D) {
  const long long rows = 2LL * B * H * cdiv(N, abt::TQ) * abt::TQ;
  return N > abt::DQ_SMEM_MAX_N ? rows + (long long)cdiv(N, abt::TK) * B * N * H * D : rows;
}

namespace {

template <int NW>
cudaError_t launch_fwd(abt::FwdParams& p, long long items, cudaStream_t s) {
  using namespace abt;
  constexpr int SMEM = FwdTiles<NW>::SMEM;
  static_assert(SMEM <= 227 * 1024, "a block's shared memory");
  static bool sized = false;  // the attribute once per instantiation
  if (!sized) {
    VTX_CHECK(cudaFuncSetAttribute(bf16_attn_fwd_kernel<NW>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
    sized = true;
  }
  const int sms = sm_count();  // persistent blocks: one an SM
  if (!sms) return cudaErrorInvalidDevice;
  bf16_attn_fwd_kernel<NW><<<(int)(items < sms ? items : sms), THREADS, SMEM, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The forward: out [B, N, H·D] bf16 and lse [B, H, N] f32 when non-null;
// key tiles of 128, or one of 208 where 192 < N ≤ 208
cudaError_t vtx::packed_attention_fwd_bf16(const bf16* qkv, bf16* out, float* lse, int B,
                                           int N, int H, int D, float scale, cudaStream_t s) {
  using namespace abt;
  VTX_CHECK(check(qkv, out, B, N, H, D));
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
  p.KT = wide ? 1 : cdiv(N, TK);
  const long long items = (long long)B * H * p.QT;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.items = (int)items;
  p.scale2 = scale * LOG2E;
  return wide ? launch_fwd<208>(p, items, s) : launch_fwd<0>(p, items, s);
}

// The backward: dqkv bf16 in the layout of qkv from the forward's out and
// lse and dout [B, N, H·D]; ws the workspace of
// vtx::packed_attention_bwd_bf16_floats
cudaError_t vtx::packed_attention_bwd_bf16(const bf16* qkv, const bf16* out, const float* lse,
                                           const bf16* dout, float* ws, bf16* dqkv, int B,
                                           int N, int H, int D, float scale, cudaStream_t s) {
  using namespace abt;
  VTX_CHECK(check(qkv, dqkv, B, N, H, D));
  VTX_CHECK(check(out, dout, B, N, H, D));
  if (!lse || !ws || !aligned16(ws)) return cudaErrorInvalidValue;
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
  if ((long long)B * p.QT > 0x7fffffffLL || TQ * H * 4 > 48 * 1024) return cudaErrorInvalidValue;
  bf16_attn_rows_kernel<<<B * p.QT, 256, TQ * H * 4, s>>>(out, dout, lse, rows, N, H, D, p.QT);
  VTX_CHECK(cudaGetLastError());
  const bool dq_smem = N <= DQ_SMEM_MAX_N;
  static bool sized[2] = {false, false};  // the attribute once per instantiation
  if (!sized[dq_smem]) {
    VTX_CHECK(cudaFuncSetAttribute(
        dq_smem ? bf16_attn_bwd_kernel<true> : bf16_attn_bwd_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem(DQ_SMEM_MAX_N, dq_smem)));
    sized[dq_smem] = true;
  }
  const int sms = sm_count();
  if (!sms) return cudaErrorInvalidDevice;
  const int grid = B * H < sms ? B * H : sms;
  if (dq_smem)
    bf16_attn_bwd_kernel<true><<<grid, THREADS, bwd_smem(N, true), s>>>(p);
  else
    bf16_attn_bwd_kernel<false><<<grid, THREADS, bwd_smem(N, false), s>>>(p);
  VTX_CHECK(cudaGetLastError());
  if (!dq_smem)  // the key tiles' partials in order, rounded once
    VTX_CHECK(launch_splitk_reduce(p.dq_part, p.KT, B * N, (int)HD, dqkv, 3 * HD, 1, s));
  return cudaSuccess;
}

// The C entry points return the first cudaError_t met (0 = success).  qkv
// [B, N, 3·H·D] bf16, 16-byte aligned; D a multiple of 8, at most 64.

// The thin door chip_smoke.py times beside scaled_dot_product_attention:
// out [B, N, H·D], lse [B, H, N] or null ...
extern "C" int vtx_packed_attention_fwd_bf16(const bf16* qkv, bf16* out, float* lse, int B,
                                             int N, int H, int D, float scale, void* stream) {
  return static_cast<int>(vtx::packed_attention_fwd_bf16(
      qkv, out, lse, B, N, H, D, scale, static_cast<cudaStream_t>(stream)));
}

// ... and the backward: dqkv from out, lse and dout; dq_part the workspace
// (vtx::packed_attention_bwd_bf16_floats floats: the L and Δ rows, and the
// dq partials where N > 256)
extern "C" int vtx_packed_attention_bwd_bf16(const bf16* qkv, const bf16* out,
                                             const float* lse, const bf16* dout,
                                             float* dq_part, bf16* dqkv, int B, int N, int H,
                                             int D, float scale, void* stream) {
  return static_cast<int>(vtx::packed_attention_bwd_bf16(
      qkv, out, lse, dout, dq_part, dqkv, B, N, H, D, scale,
      static_cast<cudaStream_t>(stream)));
}
