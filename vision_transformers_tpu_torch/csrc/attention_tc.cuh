// Attention on the tensor cores in 3xTF32 (mma_tf32.cuh), forward and
// backward, the core of two ops:
//   fused_attention.cu      B6, the reduced-kv attention (PVT's SRA, Twins'
//                           GSA): q [B, G, M, D], k / v [B, G, N, D], N ≤ 64
//                           in the models
//   fused_attention_qkv.cu  B3, the packed-qkv self-attention (ViT with
//                           dropout, Swin under 'fused'): M = N tokens
//
//   out[b, h] = softmax(q[b, h]·k[b, h]ᵀ·scale + bias[b, h])·v[b, h]
//
// Every operand is strided: element (b, h, r, d) of q, k, v, o, do at
// p[b·sb + h·sh + r·sr + d], so both ops read their tensors where they lie
// (B6 the heads of a projection, B3 the packed [B, N, 3·H·D] rows) and write
// out, dq, dk, dv the same way.  bias element (q, k) of (b, h) at
// p[(b / rpg)·sg + h·sh + q·sq + k]: B3's grouped [G, H, N, N], B6's
// broadcast [G, M, N] (sg = 0).
//
// Blocks of 8 warps, one block an SM at heads 64 wide (the shared memory
// of one block: 139 KB forward, 209 KB backward), so two warps on each
// SM sub-partition hide each other's latency.  A forward query tile is 128
// queries (16 a warp), a backward query tile 64, a key tile 64 keys; the
// last one of each is padded to a multiple of 8 inside the mma loops.  A
// head is DH = 32 or 64 floats wide in shared memory (D ≤ DH zero-filled),
// tiles have a row stride of DH + 4.
//
// Forward (attn_fwd_kernel): a block owns one (b, h) and a run of query
// tiles.  With one key tile (N ≤ 64: B6 in every model) K and V are staged
// once with cp.async and split into hi / lo halves in shared memory for the
// whole run, and each next query tile is prefetched while the current one
// computes; with more (B3: N = 197, 98) the K / V tiles are double-buffered
// and each is split once as it arrives.  Per key tile a warp computes S =
// q·kᵀ (3xTF32), adds scale and bias, and runs the max-subtracted softmax on
// the accumulator fragments (row max and sum by quad shuffles; with one key
// tile this is the exact softmax, the rescale multiplies zeros), then P goes
// from the accumulators straight to A fragments and O += P·V (3xTF32).  lse
// = m + log l is written by the training instantiation.
//
// Backward (attn_bwd_kernel), one pass: a block owns one key tile of one
// (b, h) (K and V split once, resident) and walks a chunk of query tiles
// (cp.async staging of q, do, o and lse for the next tile while this one
// computes):
//   prologue   Δ = rowsum(do ⊙ o) and q, do split into hi / lo
//   phase A    warp w, keys 16·(w mod 4) + 0..15 against queries 32·(w / 4)
//              + 0..31: Sᵀ = k·qᵀ, dPᵀ = v·doᵀ; P = exp(S·scale + bias −
//              lse), dS = P ⊙ (dP − Δ) (with N = 1, P = 1 and dS = 0
//              exactly, as the JAX kernel's softmax gives them); dv += Pᵀ·do,
//              dk += dSᵀ·q·scale, accumulated in registers over the chunk;
//              dS·scale to shared memory
//   phase B    warp w, queries 16·(w mod 4) + 0..15, head columns of half
//              w / 4: dq = dS·k·scale over the tile's keys, complete with
//              one key tile, else a partial per key tile
// dk / dv leave once, at the end of the chunk, the two query halves' sums
// added in a fixed order: complete with one chunk, else a partial per chunk.  The partials are summed in order afterwards
// (common.cuh splitk_reduce_kernel), and dS goes to a [B, H, M, N] buffer
// for the bias gradient: no float atomics, so the gradients are
// bit-identical from run to run.
//
// What bounds it on this card.  Attention does 4·M·N·D operations a (b, h)
// forward and 10·M·N·D backward against 4 bytes of each q, k, v, o, do
// element; at PVT-S stage 1 (N = 49) the bytes bound both, at ViT-S/16 (N =
// 197) the f32-accurate tensor-core rate (165 TFLOP/s) does.  The design
// reads every operand once per block through 16-byte cp.async, keeps S, P,
// dS in registers or one shared tile, and splits a reused operand once.
//
// The bf16 form of the bias-free packed-row attention (B1 and B2 at the JAX
// package's default precision) is not an instantiation of this core: it is
// attention_bf16_tma.cuh, on wgmma fed by TMA.

#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {
namespace tca {

constexpr int THREADS = 256;  // 8 warps; one block an SM is enough (up to 255
                              // registers a thread: the accumulators stay there)
constexpr int TQF = 128;      // queries per forward query tile, 16 a warp
constexpr int TQ = 64;        // queries per backward query tile
constexpr int TK = 64;        // keys per key tile
constexpr int LDS = TQ + 4;   // row stride of the dS tile [keys][queries]
constexpr int SMS = 132;      // H100 SXM streaming multiprocessors

// A strided [B, H, rows, D] operand, unit stride along D
struct Rows {
  const float* p;
  long long sb, sh, sr;
  __device__ __forceinline__ const float* row(int b, int h, int r) const {
    return p + b * sb + h * sh + (long long)r * sr;
  }
};

struct WRows {
  float* p;
  long long sb, sh, sr;
  __device__ __forceinline__ float* row(int b, int h, int r) const {
    return p + b * sb + h * sh + (long long)r * sr;
  }
};

// the shared memory of every kernel here (one declaration for every
// instantiation)
extern __shared__ __align__(16) unsigned char tca_smem[];

// the additive bias of (b, h): element (q, k) at base(b, h)[q·sq + k]
struct Bias {
  const float* p;
  int rpg;  // rows (b) per group
  long long sg, sh, sq;
  __device__ __forceinline__ const float* base(int b, int h) const {
    return p + (long long)(b / rpg) * sg + h * sh;
  }
};

__device__ __forceinline__ int cdiv_d(int a, int b) { return (a + b - 1) / b; }

// rows [r0, r0 + n) of t at (b, h) into the ROWS-row tile T (row stride
// DH + 4), zero-filled past n rows and past D; 16-byte copies when ``vec``
// (D and every stride a multiple of 4, the base 16-byte aligned), else
// 4-byte copies
template <int DH, int ROWS = 64>
__device__ __forceinline__ void stage_rows(float* Tl, const Rows& t, int b, int h, int r0,
                                           int n, int D, bool vec) {
  constexpr int LD = DH + 4;
  if (vec) {
    constexpr int CV = DH / 4;
    for (int i = threadIdx.x; i < ROWS * CV; i += THREADS) {
      const int r = i / CV, c = (i % CV) * 4;
      const bool ok = r < n && c < D;
      tc::cp_async16(Tl + r * LD + c, ok ? t.row(b, h, r0 + r) + c : t.p, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DH; i += THREADS) {
      const int r = i / DH, c = i % DH;
      const bool ok = r < n && c < D;
      tc::cp_async4(Tl + r * LD + c, ok ? t.row(b, h, r0 + r) + c : t.p, ok);
    }
  }
}

// a staged f32 tile T → T = hi, L = lo (64 rows)
template <int DH>
__device__ __forceinline__ void split_f32(float* T, float* L) {
  constexpr int N4 = 64 * (DH + 4) / 4;
  float4* t4 = reinterpret_cast<float4*>(T);
  float4* l4 = reinterpret_cast<float4*>(L);
  for (int i = threadIdx.x; i < N4; i += THREADS) {
    float4 x = t4[i], lo;
    uint32_t h, l;
    tc::split(x.x, h, l); x.x = __uint_as_float(h); lo.x = __uint_as_float(l);
    tc::split(x.y, h, l); x.y = __uint_as_float(h); lo.y = __uint_as_float(l);
    tc::split(x.z, h, l); x.z = __uint_as_float(h); lo.z = __uint_as_float(l);
    tc::split(x.w, h, l); x.w = __uint_as_float(h); lo.w = __uint_as_float(l);
    t4[i] = x;
    l4[i] = lo;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  Rows q, k, v;
  WRows out;
  float* lse;  // [B, H, M] or null
  Bias bias;
  int M, N, D, per_block, vec;
  float scale;
};

// one key tile of a warp's 16 queries: the online softmax state (m, l per
// row g and g + 8; l a per-thread partial until the epilogue) and O
template <int DH, bool HAS_BIAS>
__device__ __forceinline__ void fwd_tile(const float* Qw, const float* Kh, const float* Kl,
                                         const float* Vh, const float* Vl, int nk, int key0,
                                         int row0, const FwdArgs& a, const float* bias,
                                         float (&m)[2], float (&l)[2], float (&o)[DH / 8][4],
                                         int g, int t) {
  constexpr int LD = DH + 4, KS = DH / 8, NT = TK / 8;
  const int ntv = (nk + 7) >> 3;
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    tc::FragA fa;
    tc::load_a(fa, Qw + ks * 8, LD, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < ntv) {
        tc::FragB fb;
        tc::load_b_nmajor(fb, Kh + nt * 8 * LD + ks * 8, Kl + nt * 8 * LD + ks * 8, LD, g, t);
        tc::mma3(s[nt], fa, fb);
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = nt * 8 + 2 * t + (i & 1);
      float x = s[nt][i] * a.scale;
      if (HAS_BIAS) {
        const int row = row0 + g + (i >> 1) * 8;
        if (row < a.M && kj < nk) x += bias[(long long)row * a.bias.sq + key0 + kj];
      }
      x = kj < nk ? x : -INFINITY;
      s[nt][i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], tc::quad_max(mx[r]));  // finite: the tile has a key
    alpha[r] = expf(m[r] - mn);                      // 0 on the first tile
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int dt = 0; dt < KS; ++dt) {
    o[dt][0] *= alpha[0];
    o[dt][1] *= alpha[0];
    o[dt][2] *= alpha[1];
    o[dt][3] *= alpha[1];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(s[nt][i] - m[i >> 1]);  // 0 past the keys
      s[nt][i] = p;
      l[i >> 1] += p;
    }
  }
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    if (kk < ntv) {
      tc::FragA fa;
      tc::a_from_c(fa, s[kk]);
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        tc::FragB fb;
        tc::load_b_kperm(fb, Vh + kk * 8 * LD + dt * 8, Vl + kk * 8 * LD + dt * 8, LD, g, t);
        tc::mma3(o[dt], fa, fb);
      }
    }
  }
}

// grid (query-tile runs, H, B); shared memory, in 64 x LD tiles:
// one key tile  Q0 Q1 (2 each) | K V (staged, then hi) | Kl Vl    8 tiles
// more          Q (2) | K0 V0 K1 V1 (staged, then hi) | Kl Vl     8 tiles
template <int DH, bool SAVE_LSE, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS, 1) attn_fwd_kernel(const FwdArgs a) {
  constexpr int LD = DH + 4, TILE = 64 * LD, KS = DH / 8;
  float* const smem = reinterpret_cast<float*>(tca_smem);
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int KT = cdiv_d(a.N, TK), QT = cdiv_d(a.M, TQF);
  const bool resident = KT == 1;
  const int qt0 = blockIdx.x * a.per_block, qt1 = min(QT, qt0 + a.per_block);
  if (qt0 >= qt1) return;
  float* Q0 = smem;
  float* Q1 = resident ? smem + 2 * TILE : smem;
  float* kv = smem + (resident ? 4 : 2) * TILE;
  float* const K0 = kv;
  float* const V0 = kv + TILE;
  float* const K1 = resident ? K0 : kv + 2 * TILE;
  float* const V1 = resident ? V0 : kv + 3 * TILE;
  float* Kl = kv + (resident ? 2 : 4) * TILE;
  float* Vl = Kl + TILE;
  const bool vec = a.vec;
  const float* bias = HAS_BIAS ? a.bias.base(b, h) : nullptr;

  stage_rows<DH, TQF>(Q0, a.q, b, h, qt0 * TQF, min(TQF, a.M - qt0 * TQF), a.D, vec);
  stage_rows<DH>(K0, a.k, b, h, 0, min(TK, a.N), a.D, vec);
  stage_rows<DH>(V0, a.v, b, h, 0, min(TK, a.N), a.D, vec);
  tc::cp_async_commit();

  for (int qt = qt0, it = 0; qt < qt1; ++qt, ++it) {
    const int q0 = qt * TQF;
    const float* Qw = ((it & 1) ? Q1 : Q0) + warp * 16 * LD;
    const bool rows = warp * 16 < a.M - q0;  // the warp has queries
    float o[KS][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      // in flight while this tile computes: the next query tile (one key
      // tile) or the next key tile
      if (resident) {
        if (qt + 1 < qt1)
          stage_rows<DH, TQF>((it & 1) ? Q0 : Q1, a.q, b, h, q0 + TQF,
                              min(TQF, a.M - q0 - TQF), a.D, vec);
      } else if (kt + 1 < KT) {
        const int n1 = min(TK, a.N - (kt + 1) * TK);
        stage_rows<DH>((kt & 1) ? K0 : K1, a.k, b, h, (kt + 1) * TK, n1, a.D, vec);
        stage_rows<DH>((kt & 1) ? V0 : V1, a.v, b, h, (kt + 1) * TK, n1, a.D, vec);
      }
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
      __syncthreads();
      float* const Kh = (kt & 1) ? K1 : K0;
      float* const Vh = (kt & 1) ? V1 : V0;
      if (!resident || it == 0) {
        split_f32<DH>(Kh, Kl);
        split_f32<DH>(Vh, Vl);
        __syncthreads();
      }
      if (rows)
        fwd_tile<DH, HAS_BIAS>(Qw, Kh, Kl, Vh, Vl, min(TK, a.N - kt * TK), kt * TK,
                               q0 + warp * 16, a, bias, m, l, o, g, t);
      __syncthreads();
    }
    if (rows) {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = tc::quad_sum(l[r]);
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + r * 8;
        if (row < a.M) {
          float* orow = a.out.row(b, h, row);
#pragma unroll
          for (int dt = 0; dt < KS; ++dt) {
            const int col = dt * 8 + 2 * t;
            if (col < a.D) orow[col] = o[dt][2 * r] * inv[r];
            if (col + 1 < a.D) orow[col + 1] = o[dt][2 * r + 1] * inv[r];
          }
          if (SAVE_LSE && t == 0)
            a.lse[((long long)b * gridDim.y + h) * a.M + row] = m[r] + logf(l[r]);
        }
      }
    }
    if (!resident && qt + 1 < qt1) {  // the next query tile and its first key tile
      stage_rows<DH, TQF>(Q0, a.q, b, h, q0 + TQF, min(TQF, a.M - q0 - TQF), a.D, vec);
      stage_rows<DH>(K0, a.k, b, h, 0, TK, a.D, vec);
      stage_rows<DH>(V0, a.v, b, h, 0, TK, a.D, vec);
      tc::cp_async_commit();
    }
  }
  tc::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  Rows q, k, v, o, dout;
  const float* lse;  // [B, H, M]
  Bias bias;
  WRows dq;          // the final dq (set by the caller)
  WRows dqp;         // where the kernel writes dq: dq itself, or + kt·dq_kt
  long long dq_kt;   // the key tile's partial (set by attention_bwd)
  WRows dk, dv;      // + c·dkv_c: the query chunk's partial
  long long dkv_c;
  float* ds;         // [B, H, M, N] dS (bias gradient) or null
  int M, N, D, per_chunk, vec;
  float scale;
};

// phase A of one query tile for the warp's 16 keys (Kh ... at its rows) and
// its 32 queries (query n-tiles n0 .. n0 + 3): P, dS; dv += Pᵀ·do, dk +=
// dSᵀ·q·scale; dS·scale → DSw (the warp's 16 rows of the [keys][queries]
// tile)
template <int DH, bool HAS_BIAS>
__device__ __forceinline__ void bwd_keys(const float* Kh, const float* Kl, const float* Vh,
                                         const float* Vl, const float* Qh, const float* Ql,
                                         const float* dOh, const float* dOl, const float* Ls,
                                         const float* Ds, float* DSw, int n0, int ntv, int q0,
                                         int key0, const BwdArgs& a, const float* bias,
                                         float* ds, float (&dk)[DH / 8][4],
                                         float (&dv)[DH / 8][4], int g, int t) {
  constexpr int LD = DH + 4, KS = DH / 8, NP = 4;
  const bool one_key = a.N == 1;
  float s[NP][4], dp[NP][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    tc::FragA fk, fv;
    tc::load_a_split(fk, Kh + ks * 8, Kl + ks * 8, LD, g, t);
    tc::load_a_split(fv, Vh + ks * 8, Vl + ks * 8, LD, g, t);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (n0 + j < ntv) {
        const int o = (n0 + j) * 8 * LD + ks * 8;
        tc::FragB fb;
        tc::load_b_nmajor(fb, Qh + o, Ql + o, LD, g, t);
        tc::mma3(s[j], fk, fb);
        tc::load_b_nmajor(fb, dOh + o, dOl + o, LD, g, t);
        tc::mma3(dp[j], fv, fb);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + g + (i >> 1) * 8, qc = (n0 + j) * 8 + 2 * t + (i & 1);
      const int row = q0 + qc;
      const bool ok = row < a.M && key < a.N;
      float x = s[j][i] * a.scale;
      if (HAS_BIAS && ok) x += bias[(long long)row * a.bias.sq + key];
      // a softmax over one key is 1 and has no gradient: exactly, not up to
      // the rounding of dP against Δ (Twins' last stage, N = 1)
      const float p = one_key ? (row < a.M ? 1.f : 0.f)
                              : expf(x - Ls[qc]);  // lse = +inf past the queries: 0
      const float d = one_key ? 0.f : p * (dp[j][i] - Ds[qc]);
      if (HAS_BIAS && ds && ok) ds[(long long)row * a.N + key] = d;
      s[j][i] = p;
      dp[j][i] = d * a.scale;
    }
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (n0 + j < ntv) {
      tc::FragA fp, fd;
      tc::a_from_c(fp, s[j]);
      tc::a_from_c(fd, dp[j]);
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        const int o = (n0 + j) * 8 * LD + dt * 8;
        tc::FragB fb;
        tc::load_b_kperm(fb, dOh + o, dOl + o, LD, g, t);
        tc::mma3(dv[dt], fp, fb);
        tc::load_b_kperm(fb, Qh + o, Ql + o, LD, g, t);
        tc::mma3(dk[dt], fd, fb);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int c = (n0 + j) * 8 + 2 * t;
    DSw[g * LDS + c] = dp[j][0];
    DSw[g * LDS + c + 1] = dp[j][1];
    DSw[(g + 8) * LDS + c] = dp[j][2];
    DSw[(g + 8) * LDS + c + 1] = dp[j][3];
  }
}

// grid (chunks · key tiles, H, B); shared memory: Kh Kl Vh Vl | Qh Ql dOh dOl
// | staged Q dO O (64 x LD each) | dS [64 keys][LDS] | staged lse, lse, Δ
// [64] each
template <int DH>
constexpr size_t bwd_smem_bytes() {
  return (11 * 64 * (DH + 4) + 64 * LDS + 3 * 64) * sizeof(float);
}

template <int DH, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_kernel(const BwdArgs a) {
  constexpr int LD = DH + 4, TILE = 64 * LD, KS = DH / 8, KH = KS / 2;
  float* const smem = reinterpret_cast<float*>(tca_smem);
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rows16 = (warp & 3) * 16;  // the warp's keys (phase A), queries (phase B)
  const int half = warp >> 2;          // its query half (A), head-column half (B)
  const int KT = cdiv_d(a.N, TK), QT = cdiv_d(a.M, TQ);
  const int kt = blockIdx.x % KT, c = blockIdx.x / KT;
  const int key0 = kt * TK, nk = min(TK, a.N - key0);
  const int qt0 = c * a.per_chunk, qt1 = min(QT, qt0 + a.per_chunk);
  float* Kh = smem;
  float* Kl = Kh + TILE;
  float* Vh = Kl + TILE;
  float* Vl = Vh + TILE;
  float* Qh = Vl + TILE;
  float* Ql = Qh + TILE;
  float* dOh = Ql + TILE;
  float* dOl = dOh + TILE;
  float* Qr = dOl + TILE;  // staged
  float* dOr = Qr + TILE;
  float* Or = dOr + TILE;
  float* DS = Or + TILE;
  float* Lr = DS + 64 * LDS;  // staged lse
  float* Ls = Lr + 64;
  float* Ds = Ls + 64;
  const bool vec = a.vec;
  const float* bias = HAS_BIAS ? a.bias.base(b, h) : nullptr;
  float* ds = a.ds ? a.ds + ((long long)b * gridDim.y + h) * a.M * a.N : nullptr;
  const float* lse = a.lse + ((long long)b * gridDim.y + h) * a.M;

  auto stage_queries = [&](int qt) {
    const int r0 = qt * TQ, n = min(TQ, a.M - r0);
    stage_rows<DH>(Qr, a.q, b, h, r0, n, a.D, vec);
    stage_rows<DH>(dOr, a.dout, b, h, r0, n, a.D, vec);
    stage_rows<DH>(Or, a.o, b, h, r0, n, a.D, vec);
    if (threadIdx.x < TQ) {
      const bool ok = threadIdx.x < n;
      tc::cp_async4(Lr + threadIdx.x, ok ? lse + r0 + threadIdx.x : lse, ok);
    }
  };
  stage_rows<DH>(Kh, a.k, b, h, key0, nk, a.D, vec);
  stage_rows<DH>(Vh, a.v, b, h, key0, nk, a.D, vec);
  if (qt0 < qt1) stage_queries(qt0);
  tc::cp_async_commit();

  float dk[KS][4], dv[KS][4];
#pragma unroll
  for (int dt = 0; dt < KS; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[dt][i] = dv[dt][i] = 0.f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * TQ, nq = min(TQ, a.M - q0);
    tc::cp_async_wait<0>();
    __syncthreads();
    if (qt == qt0) {
      split_f32<DH>(Kh, Kl);
      split_f32<DH>(Vh, Vl);
    }
    {  // Δ = rowsum(do ⊙ o) in a fixed order (four threads a row, then
       // their sums in pairs), lse (+inf past the queries), q and do split
       // out of the staging
      const int r = threadIdx.x >> 2, quarter = threadIdx.x & 3;
      float dsum = 0.f;
#pragma unroll 4
      for (int j = 0; j < DH / 4; ++j) {
        const int i = r * LD + quarter + 4 * j;
        const float x = dOr[i];
        dsum = fmaf(x, Or[i], dsum);
        uint32_t hi, lo;
        tc::split(x, hi, lo);
        dOh[i] = __uint_as_float(hi);
        dOl[i] = __uint_as_float(lo);
        tc::split(Qr[i], hi, lo);
        Qh[i] = __uint_as_float(hi);
        Ql[i] = __uint_as_float(lo);
      }
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      if (!quarter) {
        Ls[r] = r < nq ? Lr[r] : INFINITY;
        Ds[r] = dsum;
      }
    }
    __syncthreads();
    if (qt + 1 < qt1) stage_queries(qt + 1);  // in flight while this tile computes
    tc::cp_async_commit();
    const int ntv = (nq + 7) >> 3;
    if (rows16 < nk && half * 4 < ntv)
      bwd_keys<DH, HAS_BIAS>(Kh + rows16 * LD, Kl + rows16 * LD, Vh + rows16 * LD,
                             Vl + rows16 * LD, Qh, Ql, dOh, dOl, Ls, Ds, DS + rows16 * LDS,
                             half * 4, ntv, q0, key0 + rows16, a, bias, ds, dk, dv, g, t);
    __syncthreads();
    if (rows16 < nq) {  // phase B: dq of the warp's queries and head half
      float dq[KH][4];
#pragma unroll
      for (int dt = 0; dt < KH; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
      const int kv = (nk + 7) >> 3;
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) {
        if (kk < kv) {
          tc::FragA fa;
          tc::load_a_tperm(fa, DS + kk * 8 * LDS + rows16, LDS, g, t);
#pragma unroll
          for (int dt = 0; dt < KH; ++dt) {
            const int o = kk * 8 * LD + (half * KH + dt) * 8;
            tc::FragB fb;
            tc::load_b_kperm(fb, Kh + o, Kl + o, LD, g, t);
            tc::mma3(dq[dt], fa, fb);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + rows16 + g + r * 8;
        if (row < a.M) {
          float* drow = a.dqp.row(b, h, row) + kt * a.dq_kt;
#pragma unroll
          for (int dt = 0; dt < KH; ++dt) {
            const int col = (half * KH + dt) * 8 + 2 * t;
            if (col < a.D) drow[col] = dq[dt][2 * r];
            if (col + 1 < a.D) drow[col + 1] = dq[dt][2 * r + 1];
          }
        }
      }
    }
    __syncthreads();
  }
  tc::cp_async_wait<0>();
  // the two query halves' dk / dv: half 1 hands its sums to half 0 through
  // the (idle) q tiles, half 0 adds them to its own
  float* X = reinterpret_cast<float*>(Qh) + (warp & 3) * (2 * KS * 4 * 32);
  if (half && rows16 < nk) {
#pragma unroll
    for (int dt = 0; dt < KS; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        X[(dt * 4 + i) * 32 + lane] = dk[dt][i];
        X[((KS + dt) * 4 + i) * 32 + lane] = dv[dt][i];
      }
  }
  __syncthreads();
  if (!half && rows16 < nk) {  // this chunk's dk / dv (zeros for an empty chunk)
#pragma unroll
    for (int dt = 0; dt < KS; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dk[dt][i] += X[(dt * 4 + i) * 32 + lane];
        dv[dt][i] += X[((KS + dt) * 4 + i) * 32 + lane];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + rows16 + g + r * 8;
      if (key < a.N) {
        float* krow = a.dk.row(b, h, key) + c * a.dkv_c;
        float* vrow = a.dv.row(b, h, key) + c * a.dkv_c;
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          const int col = dt * 8 + 2 * t;
          if (col < a.D) {
            krow[col] = dk[dt][2 * r];
            vrow[col] = dv[dt][2 * r];
          }
          if (col + 1 < a.D) {
            krow[col + 1] = dk[dt][2 * r + 1];
            vrow[col + 1] = dv[dt][2 * r + 1];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 16-byte copies: the base aligned, every stride a whole number of 16 bytes
inline bool rows_vec(const Rows& r) {
  return aligned16(r.p) && r.sb % 4 == 0 && r.sh % 4 == 0 && r.sr % 4 == 0;
}

template <int DH>
constexpr size_t fwd_smem_bytes() {
  return 8 * 64 * (DH + 4) * sizeof(float);
}

template <int DH, bool SAVE_LSE, bool HAS_BIAS>
cudaError_t launch_fwd_t(const FwdArgs& a, dim3 grid, size_t smem, cudaStream_t s) {
  VTX_CHECK(cudaFuncSetAttribute(attn_fwd_kernel<DH, SAVE_LSE, HAS_BIAS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  attn_fwd_kernel<DH, SAVE_LSE, HAS_BIAS><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_fwd_dh(FwdArgs a, int B, int H, cudaStream_t s) {
  const bool resident = a.N <= TK;
  constexpr size_t smem = fwd_smem_bytes<DH>();
  const int QT = cdiv(a.M, TQF);
  // one key tile: a block walks a run of query tiles with K / V resident,
  // about two waves of blocks; more: a query tile a block
  const long long per_sm = (227 * 1024) / (long long)smem;
  const long long want = 2 * SMS * per_sm / ((long long)B * H);
  const int runs = !resident ? QT : want < 1 ? 1 : want > QT ? QT : (int)want;
  a.per_block = cdiv(QT, runs);
  const dim3 grid(cdiv(QT, a.per_block), H, B);
  const bool save = a.lse != nullptr, bias = a.bias.p != nullptr;
  if (save)
    return bias ? launch_fwd_t<DH, true, true>(a, grid, smem, s)
                : launch_fwd_t<DH, true, false>(a, grid, smem, s);
  return bias ? launch_fwd_t<DH, false, true>(a, grid, smem, s)
              : launch_fwd_t<DH, false, false>(a, grid, smem, s);
}

// the forward over B·H heads; the 32-wide instantiation for D ≤ 32
inline cudaError_t attention_fwd(FwdArgs a, int B, int H, cudaStream_t s) {
  if (B < 1 || H < 1 || a.M < 1 || a.N < 1 || a.D < 1 || a.D > 64 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  a.vec = a.D % 4 == 0 && rows_vec(a.q) && rows_vec(a.k) && rows_vec(a.v);
  return a.D <= 32 ? launch_fwd_dh<32>(a, B, H, s) : launch_fwd_dh<64>(a, B, H, s);
}

template <int DH, bool HAS_BIAS>
cudaError_t launch_bwd_t(const BwdArgs& a, dim3 grid, cudaStream_t s) {
  constexpr size_t smem = bwd_smem_bytes<DH>();
  VTX_CHECK(cudaFuncSetAttribute(attn_bwd_kernel<DH, HAS_BIAS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  attn_bwd_kernel<DH, HAS_BIAS><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// The backward over B·H heads.  dq, dk, dv are the final targets, each a
// [B·rows, H·D] matrix with row stride sr (sb = rows·sr, sh = D).  With
// more than one key tile dq is first written as key-tile partials to
// dq_part [KT, B, M, H, D] and summed in order into dq; with chunks > 1,
// dk / dv as chunk partials to dkv_part [2, chunks, B, N, H, D], summed in
// order likewise.
inline cudaError_t attention_bwd(BwdArgs a, int B, int H, int chunks, float* dq_part,
                                 float* dkv_part, cudaStream_t s) {
  if (B < 1 || H < 1 || a.M < 1 || a.N < 1 || a.D < 1 || a.D > 64 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  const int KT = cdiv(a.N, TK), QT = cdiv(a.M, TQ);
  const bool dq_partials = KT > 1;
  if (chunks < 1 || chunks > QT || (long long)chunks * KT > 0x7fffffffLL ||
      (dq_partials && !dq_part) || (chunks > 1 && !dkv_part))
    return cudaErrorInvalidValue;
  const long long HD = (long long)H * a.D;
  const long long BMHD = (long long)B * a.M * HD, BNHD = (long long)B * a.N * HD;
  const auto dk = a.dk, dv = a.dv;
  a.dq_kt = 0;
  if (dq_partials) {
    a.dqp = WRows{dq_part, a.M * HD, a.D, HD};
    a.dq_kt = BMHD;
  } else {
    a.dqp = a.dq;
  }
  a.dkv_c = 0;
  if (chunks > 1) {
    a.dk = WRows{dkv_part, a.N * HD, a.D, HD};
    a.dv = WRows{dkv_part + chunks * BNHD, a.N * HD, a.D, HD};
    a.dkv_c = BNHD;
  }
  a.per_chunk = cdiv(QT, chunks);
  a.vec = a.D % 4 == 0 && rows_vec(a.q) && rows_vec(a.k) && rows_vec(a.v) &&
          rows_vec(a.o) && rows_vec(a.dout);
  const dim3 grid(chunks * KT, H, B);
  const bool bias = a.bias.p != nullptr;
  if (a.D <= 32) {
    VTX_CHECK(bias ? (launch_bwd_t<32, true>(a, grid, s)) : (launch_bwd_t<32, false>(a, grid, s)));
  } else {
    VTX_CHECK(bias ? (launch_bwd_t<64, true>(a, grid, s)) : (launch_bwd_t<64, false>(a, grid, s)));
  }
  if (dq_partials)
    VTX_CHECK(launch_splitk_reduce(dq_part, KT, B * a.M, (int)HD, a.dq.p, a.dq.sr, 1, s));
  if (chunks > 1) {
    VTX_CHECK(launch_splitk_reduce(dkv_part, chunks, B * a.N, (int)HD, dk.p, dk.sr, 1, s));
    VTX_CHECK(launch_splitk_reduce(dkv_part + chunks * BNHD, chunks, B * a.N, (int)HD,
                                   dv.p, dv.sr, 1, s));
  }
  return cudaSuccess;
}

}  // namespace tca
}  // namespace
