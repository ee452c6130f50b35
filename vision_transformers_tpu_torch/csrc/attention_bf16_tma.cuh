// The packed-row attention core's bf16 form on Hopper (sm_90a): wgmma fed
// by TMA, forward and backward.  It is the attention of B1 and B2 at the
// JAX package's default precision (bfloat16), the attention inside
//   vision_transformers_tpu/ops/fused_layer.py:116   (B1 forward)
//   vision_transformers_tpu/ops/fused_layer.py:183   (B1 backward)
//   vision_transformers_tpu/ops/fused_layer1.py:91   (B2 forward)
//   vision_transformers_tpu/ops/fused_layer1.py:181  (B2 backward)
// at ViT's calls (B = 128 images, N = 197 tokens, 6 heads 64 wide at
// ViT-S/16) and, with an additive bias, at DINO's packed local crops (B1:
// 256 rows of 111 tokens at 96 images, the block-diagonal −1e9 mask) and
// Swin-S's window pairs (B2: 2048 / 512 / 128 / 64 rows of 98 / 98 / 98 /
// 49 tokens at 64 images, heads 32 wide, the grouped relative-position
// bias and shift mask, and its gradient),
// reading the projection's packed rows qkv [B, N, 3·H·D] (q-heads | k-heads
// | v-heads) and writing out [B, N, H·D] and dqkv in the layout of qkv, so
// nothing is transposed on either side:
//
//   out[b, :, h] = softmax(q_h·k_hᵀ·scale + bias[b / (B / G), h])·v_h
//
// The bias (HAS_BIAS, a template parameter: the bias-free instantiations
// are the kernels without it) is [G, H, N, N] f32, image b reading group
// b / (B / G) (ops/fused_layer.py extra_groups' layout), as the JAX kernel
// adds it (fused_layer.py:139-141: s = q·kᵀ·scale + extra in f32, before
// the max).  Each score leaves the accumulators as a logit in the log₂
// domain, fmaf(s, scale·log₂e, bias·log₂e), the bias read from global
// memory in the accumulators' fragment layout (DINO's [111, 111] mask over
// 6 heads is 296 KB: L2-resident; each row's lines prefetched into L1
// while the tile's products run), on 128-key tiles at every N (the 208-key
// tile's scores beside the bias's loads spilled); the backward recomputes P
// with it.  DINO's mask takes no gradient; Swin-S's bias does (DBIAS,
// below).  A query whose
// first key tiles are all masked sums them under a running max near
// −1.44e9; the first tile with a real key rescales them by 2^(−1.44e9 − m)
// = 0, as the exact softmax gives them 0.
//
// What bounds it on this card.  At ViT-S/16 the forward does 4·B·H·N²·D =
// 7.6 GFLOP (0.008 ms at 989 TFLOP/s) against 78 MB of q, k, v, out and lse
// (0.023 ms at 3.35 TB/s), the backward 19 GFLOP (0.019 ms) against 155 MB
// (0.047 ms): the bytes bound both.  What the design does about it: each
// operand is read once a (b, h) by TMA (K and V of a head from L2 for its
// second query tile), S, P and dS never leave the chip, dq is summed in
// shared memory over a head's key tiles (no f32 partials in device memory
// at N ≤ 256), and the products run on wgmma at the bf16 rate.  On the
// H100 both kernels were found bound by neither: a load-free build ran as
// fast, and the time went to each warpgroup's chain of products, softmax
// and barriers (PERF.md).  So the exponentials run on the SFU's
// ex2.approx.ftz, branch-free (a branch an element kept them apart: the
// backward 0.25 → 0.16 ms), and the forward takes one key tile of 208 keys
// where N allows (fewer products, exponentials and waits).
//
// Both kernels are persistent (a block an SM walks the work items) blocks
// of three warpgroups:
//   the producer  one thread keeps TMA loads in flight into rings of
//                 128-byte swizzled tiles under full / empty mbarriers
//                 (full counts the bytes in, empty the consumers' warps
//                 out); setmaxnreg gives its registers to the consumers
//                 (40 / 232)
//   the consumers two warpgroups on wgmma, 64 rows each
// The tensor maps read qkv as [B][N][3H][D] (4-D): a head's box is 64 bf16
// (128 bytes, the swizzle's width) by 64 or 128 rows of one image, so a box
// past N zero-fills inside its image and never reads the next image's
// tokens, and a head narrower than 64 zero-fills its columns past D (the k
// loop of q·kᵀ and the width of P·V stay 64).  Keys past N are masked to
// −∞ (forward) or to P = 0 (backward).
//
// Forward (bf16_attn_fwd_kernel<NW, HAS_BIAS>): items (b, h, 128-query
// tile), qt fastest (a head's two query tiles on neighbouring SMs at once:
// K and V from L2 for the second).  The producer loads the item's Q [128 x 64] into
// one of two Q slots and the K / V tiles into a ring of stages; the next
// item's loads run under this one's products and epilogue.  The key tiles:
// 128 keys in a ring of four stages (NW = 0), or, where 192 < N ≤ 208
// (ViT-S/16's and DeiT-S/16's 197 tokens at 224 px), one tile of 208 keys
// staged as 256 rows in two stages (NW = 208: 19% fewer products and
// exponentials than two tiles of 128, no rescale; 0.056 → 0.045 ms on the
// H100).  Consumer warpgroup w takes queries 64w..64w + 63: per key tile S
// = Q·Kᵀ by wgmma m64n128k16 (m64n208k16) from shared memory (4 k steps),
// the online softmax in f32 on the accumulators (exp2 with scale·log₂e
// folded into one FMA; with one key tile the exact softmax), P rounded to
// bf16 in registers as the A operand of O += P·V (m64n64k16, A from
// registers; V read MN-major through the transpose bit, no transposed
// copy).  As the JAX kernel's bf16 p before
// P·V, p is rounded to bf16 — here the unnormalised p, and the f32 sums are
// divided by l (the same order of error; packed_attention_reference rounds
// likewise).  O / l is rounded to bf16 once, staged swizzled in shared
// memory and stored by TMA (clipped at N and D), left in flight; lse [B, H,
// N] f32 only when asked (B1's training forward; B2's serving call not).
//
// Backward (bf16_attn_bwd_kernel<DQ, HAS_BIAS, DBIAS>): items (b, h); a block
// walks a head's 128-key tiles and, for each, its 64-query tiles.  A short
// pass before it (bf16_attn_rows_kernel) writes, per 64-query tile, L =
// lse·log₂e (+∞ past N) and Δ = rowsum(dO ⊙ out) from the rounded out, in
// f32, once a query row (1.6 MB at ViT-S/16, ~0.018 ms) — not once a key
// tile in every block.  The producer loads the key tile's K and V (two slots: the next key tile's
// under this one) and a ring of three stages of (Q, dO, L and Δ).
// Consumer warpgroup w takes keys 64w..64w + 63:
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ    wgmma m64n64k16 from shared memory
//   Pᵀ = exp2(Sᵀ·scale·log₂e − L), dSᵀ = Pᵀ ⊙ (dPᵀ − Δ)     f32
//   dV += Pᵀ·dO, dK += (dSᵀ·scale)·Q   A from registers (Pᵀ and dSᵀ·scale
//                                      rounded to bf16), dO and Q MN-major
//   dSᵀ·scale (bf16, where the JAX kernel rounds dsb) into a swizzled
//   [128 keys x 64 queries] tile, two tiles in turn
// then, the two warpgroups' dS tiles complete, one warpgroup (in turn by
// query tile) computes the query tile's dq = dS·K (m64n64k16, both
// operands MN-major from shared memory) and adds it to the head's f32 dq
// in shared memory ([N rounded up to 64] x 64, columns swizzled against
// bank conflicts), written at the first key tile and summed in key-tile
// order after it.  dK and dV are rounded once at the end of their key tile
// and stored into dqkv's k and v columns; the head's dq is rounded once
// after its last key tile and stored into the q columns.  With N > 256
// the head's dq does not fit beside the rings: each key tile's dq goes to
// f32 partials [ceil(N / 128), B·N, H·D], summed in key-tile order and
// rounded once afterwards (common.cuh splitk_reduce_kernel).  Either way no
// float atomics: the gradients are bit-identical from run to run.
//
// The bias's gradient (DBIAS: Swin-S's relative-position bias and shift
// mask, B1's and B2's bf16 backward with dextra; N ≤ 128, so one key tile):
// dbias[g, h] = Σ over the group's images of dS, in f32 from the f32 dS
// before dS·scale is rounded (the JAX kernel's dextra_ref[0, h] += ds,
// fused_layer1.py:350-356).  No [B, H, N, N] dS buffer (236 MB at Swin-S
// stage 1, three times the attention's own bytes): as in the f32 window
// attention (window_attention_tc.cuh), an item is a (chunk of a group's
// images, group, head), a block walks the chunk's images in order and sums
// each element of dSᵀ into an f32 [128 queries x 128 keys] tile in shared
// memory that its thread alone owns (columns swizzled against bank
// conflicts), and writes the tile to the chunk's f32 partial [chunks, G, H,
// N, N] once; the partials are then summed in chunk order
// (splitk_reduce_kernel).  The chunk count is the window attention's rule
// (common.cuh bias_chunks; ops/fused_layer.py window_chunks).  With
// one key tile a query tile's dq is complete after its dS·K, so it is
// rounded and stored at once (DQ_TO_ROWS) and the head's dq needs no
// shared memory.  No float atomics here either.
//
// A dq sum across a thread-block cluster of a head's key tiles (through
// distributed shared memory) was the alternative: its barrier needs every
// thread of the cluster, the producer too, at each query tile, or a
// protocol of remote mbarriers; one block a head needs neither, keeps the
// sum's order fixed by program order, and still gives ViT-S/16 768 items
// for 132 SMs.

#pragma once

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {
namespace abt {

using namespace wgm;
using namespace tma;

constexpr int THREADS = 384;        // two consumer warpgroups, then the producer's
constexpr int TQF = 128;            // forward: queries an item
constexpr int TK = 128;             // keys a key tile
constexpr int TQ = 64;              // backward: queries a query tile
constexpr int TILE64 = 64 * 128;    // a 64-row box of a head: 64 x 128 bytes
constexpr int TILE128 = 128 * 128;  // a 128-row box
constexpr int FWD_KV_STAGES = 4;
constexpr int BWD_QD_STAGES = 3;
constexpr int DQ_SMEM_MAX_N = 256;  // the backward sums dq in shared memory up to here
// where the backward's dq goes: key-tile partials in device memory, the
// head's sum in shared memory, or (one key tile) straight into dqkv
constexpr int DQ_TO_PART = 0, DQ_IN_SMEM = 1, DQ_TO_ROWS = 2;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// byte offset of bf16 element (r, c < 64) of a 128-byte swizzled box:
// 16-byte chunk k of row r at chunk k ^ (r mod 8)
__device__ __forceinline__ int slot(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// a consumer warpgroup's barrier (ids 1, 2), and the two consumer
// warpgroups' (3); 0 is __syncthreads'
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// 2^x by the SFU alone (ex2.approx.ftz: a result below 2^-126 is 0, which
// rounds to bf16 as 0 does)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the A fragments of a product's rows from accumulators s[4j + 2h + e] (row
// h, column 8j + 2·(lane % 4) + e), rounded to bf16: k step kk takes
// columns 16kk..16kk + 15, groups j = 2kk, 2kk + 1
template <int NA>
__device__ __forceinline__ void a_frags(uint32_t (&a)[NA], const float (&s)[NA * 2]) {
#pragma unroll
  for (int kk = 0; kk < NA / 4; ++kk) {
    a[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}
// the ring position a stage on
template <int S>
__device__ __forceinline__ void advance(int& st, int& ph) {
  if (++st == S) {
    st = 0;
    ph ^= 1;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// O += P·V over K16 16-key steps, P the A fragments in registers, V at sv
// (MN-major), committed as one group
template <int K16>
__device__ __forceinline__ void pv(float (&o)[32], const uint32_t (&pa)[4 * K16], uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
    wgmma_bf16_rs_n64<1>(o, a, desc_mn(sv + 2048 * kk), 1);
  }
  wg_commit();
}

// The row max of a tile's scores s (keys at or past nk at −∞ first) times
// scale·log₂e, folded into the running max m; alpha the factor that
// rescales what was summed under the old max (0 on the first tile)
template <int NS>
__device__ __forceinline__ void tile_max(float (&s)[NS], int nk, int cq, float scale2,
                                         float (&m)[2], float (&alpha)[2]) {
  if (nk < NS * 2) {
#pragma unroll
    for (int c = 0; c < NS; ++c)
      if (8 * (c >> 2) + cq + (c & 1) >= nk) s[c] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < NS; ++c) mx[(c >> 1) & 1] = fmaxf(mx[(c >> 1) & 1], s[c]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]) * scale2);  // finite: the tile has a key
    alpha[r] = exp2_fast(m[r] - mn);
    m[r] = mn;
  }
}

// p = 2^(s·scale·log₂e − m) in place (0 past the keys), summed into l
template <int NS>
__device__ __forceinline__ void tile_exp(float (&s)[NS], float scale2, const float (&m)[2],
                                         float (&l)[2]) {
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    const float v = exp2_fast(fmaf(s[c], scale2, -m[(c >> 1) & 1]));
    s[c] = v;
    l[(c >> 1) & 1] += v;
  }
}

// HAS_BIAS: a tile's scores s as logits in the log₂ domain, s·scale·log₂e
// + bias·log₂e in one FMA, before tile_max (which then takes scale2 = 1):
// keys at or past N −∞, query rows past N a bias of 0 (their out is not
// stored).  row0 the thread's first query (its second is row0 + 8), key0
// the tile's first key, bias the (image's group, head) plane [N, N]; each
// element read at an immediate offset from its row's pointer
template <int NS>
__device__ __forceinline__ void bias_logits(float (&s)[NS], const float* __restrict__ bias,
                                            int N, int row0, int key0, int cq,
                                            float scale2) {
  const int lim = N - key0 - cq;  // the thread's keys 8·(c >> 2) + (c & 1) below it are real
  const float* rp[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    live[r] = row0 + 8 * r < N;
    rp[r] = bias + (long long)(live[r] ? row0 + 8 * r : 0) * N + key0 + cq;
  }
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    const int k = 8 * (c >> 2) + (c & 1), r = (c >> 1) & 1;
    const float b2 = live[r] && k < lim ? __ldg(rp[r] + k) * LOG2E : 0.f;
    s[c] = k < lim ? fmaf(s[c], scale2, b2) : -INFINITY;
  }
}

// 128-byte lines of the bias into L1 while a tile's products run: thread t
// of a warpgroup asks for `width` keys from key0 + width·(t & 1) of query
// row row0 + (t >> 1), inside [N, N]
__device__ __forceinline__ void prefetch_bias(const float* bias, int N, int row0, int key0,
                                              int width) {
  const int t = threadIdx.x & 127, row = row0 + (t >> 1), k = key0 + width * (t & 1);
  if (row >= N || k >= N) return;
  const float* a = bias + (long long)row * N + k;
  const int last = min(width - 1, N - 1 - k);
#pragma unroll
  for (int i = 0; i < width; i += 32)
    if (i <= last) asm volatile("prefetch.global.L1 [%0];" ::"l"(a + i));
  asm volatile("prefetch.global.L1 [%0];" ::"l"(a + last));
}

// (the bias's fields last: the bias-free kernels read the others at the
// offsets they had before it)
struct FwdParams {
  CUtensorMap qkv;    // [B][N][3H][D], boxes 64 x 128 rows
  CUtensorMap out;    // [B][N][H][D], boxes 64 x 64 rows
  float* lse;         // [B, H, N] or null
  int N, H, QT, KT, items;
  float scale2;       // scale·log₂e
  const float* bias;  // [G, H, N, N] (HAS_BIAS)
  int per_group;      // images a bias group: image b reads group b / per_group
};

// The key tiles: NW = 0, tiles of 128 keys under the online softmax, K /
// V in a ring of four stages; NW = 208, where 192 < N ≤ 208 (ViT-S/16's and
// DeiT-S/16's 197 tokens at 224 px), one tile of 208 keys (the exact
// softmax, 19% fewer products and exponentials than two tiles of 128, and
// no rescale), K / V staged as 256 rows (two boxes) in two stages
template <int NW>
struct FwdTiles {
  static constexpr int ROWS = NW ? 256 : TK, STAGES = NW ? 2 : FWD_KV_STAGES,
                       KV_BYTES = 2 * ROWS * 128;
  // shared memory: Q [2][128 rows] | K, V [STAGES][ROWS] | the warpgroups'
  // out staging [2][64 rows] | barriers
  static constexpr int Q = 0, KV = 2 * TILE128, STG = KV + STAGES * KV_BYTES,
                       BAR = STG + 2 * TILE64, SMEM = 1024 + BAR + 256;
};

template <int NW, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    bf16_attn_fwd_kernel(const __grid_constant__ FwdParams p) {
  // a bias call takes the 128-key tiles: the 208-key tile's scores beside
  // the bias's loads spilled
  static_assert(!(NW && HAS_BIAS), "the bias on the 128-key tiles only");
  using T = FwdTiles<NW>;
  constexpr int S = T::STAGES;
  extern __shared__ char smem_raw[];
  char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);  // the swizzle's alignment
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::BAR);
  uint64_t* q_empty = q_full + 2;
  uint64_t* kv_full = q_empty + 2;
  uint64_t* kv_empty = kv_full + S;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 8);  // each consuming warp arrives
    }
    for (int i = 0; i < S; ++i) {
      mbar_init(kv_full + i, 1);
      mbar_init(kv_empty + i, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread issues the loads
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int qs = 0, qph = 0, st = 0, ph = 0;
      for (int i = blockIdx.x; i < p.items; i += gridDim.x) {
        const int qt = i % p.QT, bh = i / p.QT, h = bh % p.H, b = bh / p.H;
        mbar_wait(q_empty + qs, qph ^ 1);  // the first round passes: the slots start empty
        mbar_expect_tx(q_full + qs, TILE128);
        tma_load_4d(smem + T::Q + qs * TILE128, &p.qkv, q_full + qs, 0, h, qt * TQF, b);
        advance<2>(qs, qph);
        for (int kt = 0; kt < p.KT; ++kt) {
          mbar_wait(kv_empty + st, ph ^ 1);
          mbar_expect_tx(kv_full + st, T::KV_BYTES);
          char* k = smem + T::KV + st * T::KV_BYTES;
#pragma unroll
          for (int half = 0; half < T::ROWS / TK; ++half) {  // K, then V
            tma_load_4d(k + half * TILE128, &p.qkv, kv_full + st, 0, p.H + h,
                        (kt + half) * TK, b);
            tma_load_4d(k + T::ROWS * 128 + half * TILE128, &p.qkv, kv_full + st, 0,
                        2 * p.H + h, (kt + half) * TK, b);
          }
          advance<S>(st, ph);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
    const int r0 = 16 * w4 + (lane >> 2), cq = 2 * (lane & 3);  // the thread's rows r0, r0 + 8
    const bool leader = (threadIdx.x & 127) == 0;
    char* stg = smem + T::STG + wg * TILE64;
    int qs = 0, qph = 0, st = 0, ph = 0;
    for (int i = blockIdx.x; i < p.items; i += gridDim.x) {
      const int qt = i % p.QT, bh = i / p.QT, h = bh % p.H, b = bh / p.H;
      const int q0 = qt * TQF + 64 * wg;  // the warpgroup's first query
      const float* bias = nullptr;          // the (group, head) plane of the bias
      if constexpr (HAS_BIAS)
        bias = p.bias + ((long long)(b / p.per_group) * p.H + h) * p.N * p.N;
      mbar_wait(q_full + qs, qph);
      const uint32_t sq = saddr(smem + T::Q + qs * TILE128) + TILE64 * wg;
      float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int c = 0; c < 32; ++c) o[c] = 0.f;
      for (int kt = 0; kt < p.KT; ++kt) {
        mbar_wait(kv_full + st, ph);
        const uint32_t sk = saddr(smem + T::KV + st * T::KV_BYTES), sv = sk + T::ROWS * 128;
        if constexpr (NW) {  // S = Q·Kᵀ over the one tile, P·V over its 13 16-key steps
          float s[NW / 2];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16_n208<0, 0>(s, desc_k(sq + 32 * kk), desc_k(sk + 32 * kk), kk > 0);
          wg_commit();
          wg_wait<0>();
          fence_acc(s);
          tile_max(s, p.N, cq, p.scale2, m, alpha);
          tile_exp(s, p.scale2, m, l);
          uint32_t pa[NW / 4];
          a_frags(pa, s);
          wg_fence();
          pv<NW / 16>(o, pa, sv);
        } else {  // S = Q·Kᵀ over 128 keys, the online rescale, O += P·V
          float s[64];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16_n128<0, 0>(s, desc_k(sq + 32 * kk), desc_k(sk + 32 * kk), kk > 0);
          wg_commit();
          if constexpr (HAS_BIAS) prefetch_bias(bias, p.N, q0, kt * TK, TK / 2);
          wg_wait<0>();
          fence_acc(s);
          if constexpr (HAS_BIAS) bias_logits(s, bias, p.N, q0 + r0, kt * TK, cq, p.scale2);
          tile_max(s, p.N - kt * TK, cq, HAS_BIAS ? 1.f : p.scale2, m, alpha);
#pragma unroll
          for (int r = 0; r < 2; ++r) l[r] *= alpha[r];
          if (kt) {
#pragma unroll
            for (int c = 0; c < 32; ++c) o[c] *= alpha[(c >> 1) & 1];
          }
          tile_exp(s, HAS_BIAS ? 1.f : p.scale2, m, l);
          uint32_t pa[32];
          a_frags(pa, s);
          wg_fence();
          pv<TK / 16>(o, pa, sv);
        }
        wg_wait<0>();
        fence_acc(o);
        if (lane == 0) mbar_arrive(kv_empty + st);
        advance<S>(st, ph);
      }
      if (lane == 0) mbar_arrive(q_empty + qs);
      advance<2>(qs, qph);
      // the epilogue: O / l rounded once, staged swizzled, stored by TMA
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = 1.f / l[r];
      }
      if (leader) bulk_wait_read();  // the staging tile's last store has read it
      wg_sync(wg);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(stg + slot(r0 + 8 * r, 8 * j + cq)) =
              pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      fence_proxy_async();
      wg_sync(wg);
      if (leader && q0 < p.N) {
        tma_store_4d(&p.out, stg, 0, h, q0, b);
        bulk_commit();
      }
      if (p.lse && (lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + r0 + 8 * r;
          if (row < p.N) p.lse[(long long)bh * p.N + row] = (m[r] + log2f(l[r])) * LN2;
        }
      }
    }
    if (leader) bulk_wait();  // the stores have left shared memory
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// rows[((b·H + h)·QT + qt)][2][64] = L (lse·log₂e; +∞ past N), Δ =
// Σ_d dO ⊙ out (0 past N), summed in d order from the bf16 values.  A block
// a (b, 64-query tile): first a thread a (query, head) row, heads fastest
// (out and dout read in rows), Δ into shared memory; then a thread a (head,
// query), queries fastest (lse read and the rows written in runs)
__global__ void __launch_bounds__(256)
    bf16_attn_rows_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, float* __restrict__ rows, int N, int H,
                          int D, int QT) {
  extern __shared__ float delta_s[];  // [64][H]
  const int b = blockIdx.x / QT, qt = blockIdx.x % QT, q0 = qt * TQ;
  for (int e = threadIdx.x; e < TQ * H; e += 256) {
    const int q = q0 + e / H, h = e % H;
    float delta = 0.f;
    if (q < N) {  // the row's 16-byte chunks all loaded first (D a multiple of 8, ≤ 64)
      const long long off = ((long long)b * N + q) * H * D + (long long)h * D;
      const uint4* o4 = reinterpret_cast<const uint4*>(out + off);
      const uint4* d4 = reinterpret_cast<const uint4*>(dout + off);
      uint4 x[8], y[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < D / 8) {
          x[c] = __ldg(o4 + c);
          y[c] = __ldg(d4 + c);
        }
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < D / 8) {
          const uint32_t xs[4] = {x[c].x, x[c].y, x[c].z, x[c].w};
          const uint32_t ys[4] = {y[c].x, y[c].y, y[c].z, y[c].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            delta = fmaf(lo_f32(ys[k]), lo_f32(xs[k]), delta);
            delta = fmaf(hi_f32(ys[k]), hi_f32(xs[k]), delta);
          }
        }
    }
    delta_s[e] = delta;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TQ * H; e += 256) {
    const int h = e / TQ, qi = e % TQ, q = q0 + qi;
    float* r = rows + (((long long)b * H + h) * QT + qt) * 2 * TQ + qi;
    r[0] = q < N ? lse[((long long)b * H + h) * N + q] * LOG2E : INFINITY;
    r[TQ] = delta_s[qi * H + h];
  }
}

struct BwdParams {
  CUtensorMap kv;    // qkv [B][N][3H][D], boxes 64 x 128 rows (K, V)
  CUtensorMap q;     // the same, boxes 64 x 64 rows (Q)
  CUtensorMap dout;  // [B][N][H][D], boxes 64 x 64 rows
  const float* rows; // bf16_attn_rows_kernel's L and Δ
  bf16* dqkv;        // [B, N, 3·H·D]
  float* dq_part;    // [KT, B·N, H·D] where dq is not summed in shared memory
  int B, N, H, D, QT, KT;
  float scale, scale2;
  const float* bias; // [G, H, N, N] (HAS_BIAS; the fields last, as FwdParams')
  int per_group;     // images a bias group
  float* dbias_part;      // DBIAS: the chunks' partials [chunks, G, H, N, N]
  int G, chunks, per_chunk;  // ... the bias's groups, chunks a group, images a chunk
};

// shared memory: K, V [2][128 rows each] | (Q, dO [64 rows each], L and Δ)
// [stages] | dSᵀ·scale [2][128 keys x 64 queries] | barriers | the head's
// f32 dq [N rounded up to 64][64] (DQ_IN_SMEM) or the f32 dbias tile
// [128 queries][128 keys] (DBIAS)
constexpr int BWD_QD_BYTES = 2 * TILE64 + 1024;  // the L and Δ rows (512 bytes), aligned
constexpr int BWD_KV = 0, BWD_QD = BWD_KV + 2 * 2 * TILE128,
              BWD_DS = BWD_QD + BWD_QD_STAGES * BWD_QD_BYTES, BWD_BAR = BWD_DS + 2 * TILE128,
              BWD_DQ = BWD_BAR + 256;
constexpr int BWD_SMEM_BASE = 1024 + BWD_DQ;

constexpr int BWD_DB_BYTES = 2 * TQ * TK * 4;

__host__ __device__ constexpr int bwd_smem(int N, int dq, bool dbias) {
  return BWD_SMEM_BASE + (dq == DQ_IN_SMEM ? (N + TQ - 1) / TQ * TQ * 64 * 4 : 0) +
         (dbias ? BWD_DB_BYTES : 0);
}

// the dbias tile's element (query q, key k): columns swizzled by
// ((q / 2) mod 4)·8, so a warp's accesses of an accumulator layout (eight
// keys by four query pairs) hit every bank once
__device__ __forceinline__ int db_index(int q, int k) {
  return q * TK + (k ^ (((q >> 1) & 3) << 3));
}

// A work item's head and images [b0, b1): (b, h) one image, or (DBIAS) the
// images of chunk c of group g; gh = g·H + h
struct BwdItem {
  int h, b0, b1, gh, c;
};
template <bool DBIAS>
__device__ __forceinline__ BwdItem bwd_item(const BwdParams& p, int i) {
  if constexpr (DBIAS) {
    const int h = i % p.H, gc = i / p.H, g = gc % p.G, c = gc / p.G;
    const int b0 = g * p.per_group + c * p.per_chunk;
    return {h, b0, min(b0 + p.per_chunk, (g + 1) * p.per_group), g * p.H + h, c};
  } else {
    return {i % p.H, i / p.H, i / p.H + 1, 0, 0};
  }
}

// the head's f32 dq, element (q, c): columns swizzled by (q mod 4)·8, so a
// warp's float2 accesses of an accumulator layout hit every bank once a
// half-warp
__device__ __forceinline__ int dq_index(int q, int c) { return q * 64 + (c ^ ((q & 3) << 3)); }

// A query tile's dq (dS·K over key tile kt, complete): into the head's f32
// dq in shared memory, written at key tile 0 and summed in key-tile order
// after (DQ_IN_SMEM), as key tile kt's partial (DQ_TO_PART), or, the one
// key tile's, rounded once into dqkv's q columns (DQ_TO_ROWS)
template <int DQ>
__device__ __forceinline__ void put_dq(const BwdParams& p, float (&dq)[32], float* dq_acc, int b,
                                       int h, int kt, int qt, int r0, int cq) {
  fence_acc(dq);
  if constexpr (DQ == DQ_TO_ROWS) {
    const long long RS = 3LL * p.H * p.D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qt * TQ + r0 + 8 * r;
      if (q >= p.N) continue;
      bf16* row = p.dqkv + ((long long)b * p.N + q) * RS + (long long)h * p.D;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * j + cq < p.D)
          *reinterpret_cast<uint32_t*>(row + 8 * j + cq) =
              pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  } else if constexpr (DQ == DQ_IN_SMEM) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qt * TQ + r0 + 8 * r;
        float2* a = reinterpret_cast<float2*>(dq_acc + dq_index(q, 8 * j + cq));
        const float2 v = make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        *a = kt ? make_float2(a->x + v.x, a->y + v.y) : v;
      }
  } else {
    const long long HD = (long long)p.H * p.D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qt * TQ + r0 + 8 * r;
      if (q >= p.N) continue;
      float* row = p.dq_part + ((long long)kt * p.B * p.N + (long long)b * p.N + q) * HD +
                   (long long)h * p.D;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * j + cq < p.D)
          *reinterpret_cast<float2*>(row + 8 * j + cq) =
              make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

template <int DQ, bool HAS_BIAS, bool DBIAS>
__global__ void __launch_bounds__(THREADS, 1)
    bf16_attn_bwd_kernel(const __grid_constant__ BwdParams p) {
  // the bias's gradient: with the bias, one key tile, dq straight to dqkv
  static_assert(!DBIAS || (HAS_BIAS && DQ == DQ_TO_ROWS), "dbias: one key tile");
  extern __shared__ char smem_raw[];
  char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + BWD_BAR);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* qd_full = kv_empty + 2;
  uint64_t* qd_empty = qd_full + BWD_QD_STAGES;
  float* dq_acc = reinterpret_cast<float*>(smem + BWD_DQ);
  float* db_acc = reinterpret_cast<float*>(smem + BWD_DQ);  // DBIAS (no dq in shared memory)
  const int wg = threadIdx.x >> 7;
  const int items = DBIAS ? p.chunks * p.G * p.H : p.B * p.H;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(kv_full + i, 1);
      mbar_init(kv_empty + i, 8);
    }
    for (int i = 0; i < BWD_QD_STAGES; ++i) {
      mbar_init(qd_full + i, 1);
      mbar_init(qd_empty + i, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int ks = 0, kph = 0, st = 0, ph = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const BwdItem t = bwd_item<DBIAS>(p, i);
        const int h = t.h;
        for (int b = t.b0; b < t.b1; ++b) {
          const long long bh = (long long)b * p.H + h;
          for (int kt = 0; kt < p.KT; ++kt) {
            mbar_wait(kv_empty + ks, kph ^ 1);
            mbar_expect_tx(kv_full + ks, 2 * TILE128);
            char* k = smem + BWD_KV + ks * 2 * TILE128;
            tma_load_4d(k, &p.kv, kv_full + ks, 0, p.H + h, kt * TK, b);
            tma_load_4d(k + TILE128, &p.kv, kv_full + ks, 0, 2 * p.H + h, kt * TK, b);
            advance<2>(ks, kph);
            for (int qt = 0; qt < p.QT; ++qt) {
              mbar_wait(qd_empty + st, ph ^ 1);
              mbar_expect_tx(qd_full + st, 2 * TILE64 + 2 * TQ * 4);
              char* qd = smem + BWD_QD + st * BWD_QD_BYTES;
              tma_load_4d(qd, &p.q, qd_full + st, 0, h, qt * TQ, b);
              tma_load_4d(qd + TILE64, &p.dout, qd_full + st, 0, h, qt * TQ, b);
              bulk_load(qd + 2 * TILE64, p.rows + (bh * p.QT + qt) * 2 * TQ, 2 * TQ * 4,
                        qd_full + st);
              advance<BWD_QD_STAGES>(st, ph);
            }
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
    const int r0 = 16 * w4 + (lane >> 2), cq = 2 * (lane & 3);
    const long long HD = (long long)p.H * p.D, RS = 3 * HD;
    int ks = 0, kph = 0, st = 0, ph = 0, it = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const BwdItem t = bwd_item<DBIAS>(p, i);
      const int h = t.h;
      for (int b = t.b0; b < t.b1; ++b) {
        const float* bias = nullptr;  // the (group, head) plane of the bias
        if constexpr (HAS_BIAS)
          bias = p.bias + ((long long)(b / p.per_group) * p.H + h) * p.N * p.N;
        for (int kt = 0; kt < p.KT; ++kt) {
          mbar_wait(kv_full + ks, kph);
          const uint32_t sk = saddr(smem + BWD_KV + ks * 2 * TILE128), sv = sk + TILE128;
          const int key_lim = p.N - kt * TK - 64 * wg;  // the warpgroup's keys below it are real
          float dk[32], dv[32];
  #pragma unroll
          for (int c = 0; c < 32; ++c) dk[c] = dv[c] = 0.f;
          for (int qt = 0; qt < p.QT; ++qt, ++it) {
            mbar_wait(qd_full + st, ph);
            char* qd = smem + BWD_QD + st * BWD_QD_BYTES;
            const uint32_t sq = saddr(qd), sdo = sq + TILE64;
            const float* Ls = reinterpret_cast<const float*>(qd + 2 * TILE64);
            const float* Ds = Ls + TQ;
            float s[32], dp[32];
            wg_fence();
  #pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_bf16_n64<0, 0>(s, desc_k(sk + TILE64 * wg + 32 * kk), desc_k(sq + 32 * kk),
                                   kk > 0);
  #pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_bf16_n64<0, 0>(dp, desc_k(sv + TILE64 * wg + 32 * kk), desc_k(sdo + 32 * kk),
                                   kk > 0);
            wg_commit();
            if constexpr (HAS_BIAS) prefetch_bias(bias, p.N, qt * TQ, kt * TK + 64 * wg, 32);
            wg_wait<0>();
            fence_acc(s);
            fence_acc(dp);
            // s[4j + 2h + e]: key r0 + 8h of the warpgroup's, query 8j + cq + e:
            // P = 2^(s·scale·log₂e (+ bias·log₂e) − L) (0 past the keys; L =
            // +∞ past the queries), dS·scale = P ⊙ (dP − Δ)·scale
            const float* bq[2];  // HAS_BIAS: the bias at query qt·TQ + cq, key r0 + 8h
            int q_lim = 0;       // ... and its queries 8j + e below it are real
            if constexpr (HAS_BIAS) {
              q_lim = p.N - qt * TQ - cq;
  #pragma unroll
              for (int r = 0; r < 2; ++r)
                bq[r] = bias + (long long)(qt * TQ + cq) * p.N + kt * TK + 64 * wg + r0 + 8 * r;
            }
  #pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 L = *reinterpret_cast<const float2*>(Ls + 8 * j + cq);
              const float2 dl = *reinterpret_cast<const float2*>(Ds + 8 * j + cq);
  #pragma unroll
              for (int r = 0; r < 2; ++r)
  #pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int c = 4 * j + 2 * r + e;
                  float x;
                  if constexpr (HAS_BIAS) {  // element (8j + e) rows below its row's pointer
                    const float b2 = q_lim > 8 * j + e && r0 + 8 * r < key_lim
                                         ? __ldg(bq[r] + (8 * j + e) * p.N) * LOG2E
                                         : 0.f;
                    x = r0 + 8 * r < key_lim ? fmaf(s[c], p.scale2, b2) - (e ? L.y : L.x)
                                             : -INFINITY;
                  } else {
                    x = r0 + 8 * r < key_lim ? s[c] * p.scale2 - (e ? L.y : L.x) : -INFINITY;
                  }
                  const float pv = exp2_fast(x);
                  s[c] = pv;
                  // DBIAS keeps dS itself until its sum below
                  const float ds = pv * (dp[c] - (e ? dl.y : dl.x));
                  dp[c] = DBIAS ? ds : ds * p.scale;
                }
            }
            if (p.N == 1) {  // a softmax over one key is 1 and has no gradient, exactly
  #pragma unroll
              for (int c = 0; c < 32; ++c) {
                s[c] = r0 + 8 * ((c >> 1) & 1) < key_lim &&
                               Ls[8 * (c >> 2) + cq + (c & 1)] != INFINITY
                           ? 1.f
                           : 0.f;
                dp[c] = 0.f;
              }
            }
            if constexpr (DBIAS) {  // dS (f32) into the thread's own elements of the tile
              const bool first = b == t.b0;
  #pragma unroll
              for (int c = 0; c < 32; ++c) {
                float* a = db_acc + db_index(qt * TQ + 8 * (c >> 2) + cq + (c & 1),
                                             64 * wg + r0 + 8 * ((c >> 1) & 1));
                *a = first ? dp[c] : *a + dp[c];
                dp[c] *= p.scale;
              }
            }
            uint32_t pa[16], da[16];
            a_frags(pa, s);
            a_frags(da, dp);
            wg_fence();
  #pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
              wgmma_bf16_rs_n64<1>(dv, a, desc_mn(sdo + 2048 * kk), 1);
            }
  #pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
              wgmma_bf16_rs_n64<1>(dk, a, desc_mn(sq + 2048 * kk), 1);
            }
            wg_commit();
            // dSᵀ·scale, rounded as the A operand above, into dS tile it % 2:
            // row = key (64·wg + r0 + 8h), column = query
            char* dst = smem + BWD_DS + (it & 1) * TILE128;
  #pragma unroll
            for (int j = 0; j < 8; ++j)
  #pragma unroll
              for (int r = 0; r < 2; ++r)
                *reinterpret_cast<uint32_t*>(dst + slot(64 * wg + r0 + 8 * r, 8 * j + cq)) =
                    da[4 * (j >> 1) + 2 * (j & 1) + r];
            fence_proxy_async();
            consumers_sync();  // both warpgroups' dS rows are in the tile
            wg_wait<0>();
            fence_acc(dv);
            fence_acc(dk);
            if (lane == 0) mbar_arrive(qd_empty + st);  // Q, dO, L and Δ read
            advance<BWD_QD_STAGES>(st, ph);
            if ((it & 1) == wg) {  // this query tile's dq = dS·K, the warpgroups in turn
              float dq[32];
              const uint32_t sds = saddr(dst);
              wg_fence();
  #pragma unroll
              for (int kk = 0; kk < 8; ++kk)
                wgmma_bf16_n64<1, 1>(dq, desc_mn(sds + 2048 * kk), desc_mn(sk + 2048 * kk),
                                     kk > 0);
              wg_commit();
              wg_wait<0>();
              put_dq<DQ>(p, dq, dq_acc, b, h, kt, qt, r0, cq);
            }
          }
          if (lane == 0) mbar_arrive(kv_empty + ks);  // K (this warpgroup's dq too) and V read
          advance<2>(ks, kph);
          // dK, dV rounded once into dqkv's k and v columns
  #pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = kt * TK + 64 * wg + r0 + 8 * r;
            if (key >= p.N) continue;
            bf16* kr = p.dqkv + ((long long)b * p.N + key) * RS + HD + (long long)h * p.D;
  #pragma unroll
            for (int j = 0; j < 8; ++j)
              if (8 * j + cq < p.D) {
                *reinterpret_cast<uint32_t*>(kr + 8 * j + cq) =
                    pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
                *reinterpret_cast<uint32_t*>(kr + HD + 8 * j + cq) =
                    pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
              }
          }
        }
        if constexpr (DQ == DQ_IN_SMEM) {  // the head's dq rounded once into dqkv's q columns
          consumers_sync();       // every key tile's dq is in
          for (int e = threadIdx.x; e < p.N * 16; e += 256) {  // threads 0..255
            const int q = e >> 4, c = (e & 15) * 4;
            if (c >= p.D) continue;
            const float4 v = *reinterpret_cast<const float4*>(dq_acc + dq_index(q, c));
            *reinterpret_cast<uint2*>(p.dqkv + ((long long)b * p.N + q) * RS + (long long)h * p.D +
                                      c) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
          }
        }
      }
      if constexpr (DBIAS) {  // the chunk's sum of dS into its partial [q][k]
        consumers_sync();     // every thread's elements are in
        float* part = p.dbias_part + ((long long)t.c * p.G * p.H + t.gh) * p.N * p.N;
        for (int e = threadIdx.x; e < p.N * p.N; e += 256) {
          const int q = e / p.N;
          part[e] = db_acc[db_index(q, e - q * p.N)];
        }
        consumers_sync();  // read before the next item's first image writes the tile
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// a map over [B][rows][heads][D] bf16 (D contiguous, a row `row` elements
// long): boxes of one head 64 wide (past D zero-filled) by box_rows rows of
// one image (past `rows` zero-filled)
inline bool head_map(CUtensorMap* m, const bf16* p, int B, int rows, int heads, int D,
                     long long row, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)row * 2,
                                 (cuuint64_t)row * 2 * (cuuint64_t)rows};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  return encode_tiled(m, p, false, 4, dims, strides, box);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline cudaError_t check(const void* a, const void* b, int B, int N, int H, int D) {
  if (B < 1 || N < 1 || H < 1 || D < 8 || D > 64 || D % 8 || (long long)B * N * H > (1LL << 31) ||
      !aligned16(a) || !aligned16(b))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

inline int sm_count() {
  int dev, sms;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace abt
}  // namespace
