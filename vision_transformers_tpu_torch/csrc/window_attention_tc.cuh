// Window attention on the tensor cores in 3xTF32 (mma_tf32.cuh), forward and
// backward: the attention of three ops, between their projection GEMMs
//   B1   the attention layer with a bias (fused_layer.cu: Twins-SVT's local
//        attention over window pairs, one group)
//   B2   the whole pre-LN layer with Swin's grouped bias (fused_layer.cu,
//        fused_layer1_bwd.cu)
//   B9   the whole Swin layer on the map (fused_swin.cu), its window pairs
//        sample-major
//
//   out[p, i] = softmax_j(q_i·k_jᵀ·scale + bias[g(p), h, i, j])·v_j
//
// over the N ≤ 128 tokens j of window (pair) p, q / k / v the packed rows
// p·N … of the qkv projection [P·N, 3·H·D] (q-heads | k-heads | v-heads),
// heads up to 32 wide (zero-filled to 32).  Group g(p) = p / (P/G) for B1 /
// B2 (group-major rows), p mod G for B9 (sample-major pairs: CYCLIC).
//
// A file of its own, not a third addressing of halo_attention_tc.cuh: a
// window pair has M = N = 98 queries at Swin-S, past that file's M ≤ 64.  Its
// backward gives each query slice two key-half warps; at M = 98 that is 14
// warps, whose 512-thread block leaves 128 registers a thread, and there the
// 18-tile key half, the dbias sums and the key phase spill.  Here 8 warps
// take the 14 (slice, key half) units two each, and dq is a pass of its own
// from the dS tile, so that no warp holds two units' dq.  The split and fragment
// loads are mma_tf32.cuh's (split_lo: hi = cvt.rna.tf32, lo = x − hi
// truncated by the tensor core), shared with the halo attention.
//
// What Swin's windows offer, and what the design does with it:
//   * every window of a group has the same bias [N, N] (38.4 KB at N = 98):
//     a block owns one (group, head) and a chunk of that group's windows,
//     and the bias stays in shared memory for the whole chunk;
//   * all of a window's keys fit in shared memory, so the forward softmax is
//     exact in one pass, with no online rescale;
//   * dq, dk and dv are complete inside the window: the backward is one pass
//     per window and writes them once, straight into dqkv.
//
// Forward (window_fwd_kernel), per window, warp = 16 queries x all keys: S =
// q·kᵀ in 3xTF32 (q and K as float pairs), scale and the resident bias
// added, row max and sum by quad shuffles, P from the accumulators straight
// into A fragments, O += P·V; lse = m + log l in training.  A group of
// ⌈N / 16⌉ warps owns a window; a block holds as many groups as make 8
// warps (one at N = 98, two at N = 49), each walking its own windows of the
// chunk on its own named barrier, and each group's next window is staged
// with cp.async while the current one computes (q and K of the next during
// P·V, V during the next q·kᵀ).
//
// Backward (window_bwd_kernel), per window, the whole block (8 warps):
//   prologue  Δ = rowsum(do ⊙ out) (four threads a row, fixed order; out
//             read from device memory), lse (+inf past the queries: P = 0)
//   queries   unit = 16 queries x one key half, two a warp: S and dP =
//             do·vᵀ, P = exp(S·scale + bias − lse), dS = P ⊙ (dP − Δ); dS
//             summed into the dbias registers (fixed fragment positions for
//             the whole chunk); P and dS·scale to shared memory
//   dq        dq = (dS·scale)·k over all keys from the dS tile, 16 queries x
//             16 columns of d a unit, written once
//   keys      dvᵀ = doᵀ·P and dkᵀ = qᵀ·(dS·scale), 16 rows of d x half the
//             key columns a warp, complete over the window's queries and
//             written once
//   dbias     the block's register sums written once as its partial
//             [chunk, G, H, N, N], summed over the chunks in order by
//             launch_splitk_reduce: no [P, H, N, N] dS buffer, no float
//             atomics, bit-identical from run to run.
// Where P and dS of all the window's rows do not fit beside the rest (N >
// 104) the queries and keys phases run in rounds of 64 rows, a later round
// adding its dk / dv share to the earlier's in dqkv.  The next window is
// staged when the last round is done with this one.
//
// Chunks: each group's windows are cut into the count that brings the
// rounds of blocks the card runs at once times the windows a block walks
// within 5% of its least (chunk_count): at Swin-S stage 1 a count aimed at
// two waves (3 chunks, 288 blocks) leaves the third round 18% full, a
// fifth of the backward's time.
//
// Budget (heads 32 wide; N = 98 → 7 query slices, 13 key n-tiles, the
// instantiations for N ≤ 104; those for N ≤ 128 hold 16 n-tiles):
//   forward   blocks of 32·⌈N/16⌉·NG threads (≤ 256), __launch_bounds__(256, 2):
//             ≤ 128 registers a thread, the score accumulators 52 of them (N >
//             104: 64, one block an SM); shared memory the bias tile [Mp][ldb] +
//             per group q, K [Mp | Np][40] and V [Np][36]: 93.9 KiB at N = 98
//             (Mp = 112, Np = 104), so two blocks (14 warps) an SM.
//   backward  256 threads, __launch_bounds__(256, 1): the dbias sums of a
//             warp's two units (56 registers), S and dP of a key half (56)
//             and the fragments; shared memory the bias tile, q / do
//             [Mp][36], K / V [Np][36], P / dS [Mp][Np + 4], lse and Δ:
//             201.6 KiB at N = 98 (one round); at N = 128 rounds of 64 rows,
//             207.0 KiB.  One block an SM.
//
// mma.sync, not wgmma: a window is 98 rows, not a multiple of 64, and the
// backward's products need operands transposed (Pᵀ·do, dSᵀ·q) that mma.sync
// loads from shared memory as they are.
//
// What bounds it on this card: 4·N²·D operations a window and head forward,
// 10·N²·D backward, at the f32-accurate tensor-core rate (495 / 3 = 165
// TFLOP/s), against the bytes of qkv, out, lse and the bias once each
// (backward: qkv, out, do, lse, the bias, dqkv and dbias).

#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {
namespace wta {

using namespace tc;

constexpr int DH = 32;              // a head's width, zero-filled
constexpr int KS = DH / 8;          // k-steps over a head
constexpr int LD = DH + 4;          // row stride of the tiles ≡ 4 (mod 32)
constexpr int LDP = DH + 8;         // ... of the forward's pair-loaded q, K
constexpr int NMAX = 128;           // tokens of a window at most
constexpr int NT_NARROW = 13;       // key n-tiles of the instantiation for N ≤ 104
constexpr int NT_WIDE = NMAX / 8;   // ... and for N ≤ 128
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROUND_ROWS = 64;      // query rows of a backward round when all do not fit
constexpr int SMEM_MAX = 227 * 1024;
constexpr int SMS = 132;            // H100 SXM streaming multiprocessors

// row strides: the bias tile ≡ 8 (mod 16) floats (float-pair loads), the P
// / dS tiles ≡ 4 (mod 8) (rows 2t, columns g: 2t·ld + g covers the 32 banks)
__host__ __device__ __forceinline__ int bias_ld(int np) { return np % 16 ? np : np + 8; }
__host__ __device__ __forceinline__ int ps_ld(int np) { return np + 4; }

__host__ __device__ __forceinline__ int fwd_group_floats(int Mp, int Np) {
  return (Mp + Np) * LDP + Np * LD;
}

// the backward's shared floats with rounds of rp query rows
__host__ __device__ __forceinline__ int bwd_floats(int Mp, int Np, int rp) {
  return Mp * bias_ld(Np) + 2 * (Mp + Np) * LD + 2 * rp * ps_ld(Np) + 2 * Mp;
}

// the backward's query rows a round: all of them where their P and dS fit
// beside the rest (N ≤ 104: Swin's and Twins' pairs), else 64
__host__ __device__ __forceinline__ int round_rows(int Mp, int Np) {
  return 4 * bwd_floats(Mp, Np, Mp) <= SMEM_MAX ? Mp : ROUND_ROWS;
}

struct Args {
  const float* qkv;   // [P·N, 3·H·D]
  const float* bias;  // [G, H, N, N]
  const float* out;   // [P·N, H·D]: the forward's output, which the backward reads
  const float* dout;  // [P·N, H·D]
  const float* lse;   // [P, H, N]: the backward reads it
  float* o;           // the forward's out ...
  float* lse_o;       // ... and lse
  float* dqkv;        // [P·N, 3·H·D]
  float* part;        // [chunks, G, H, N, N] or null
  int P, G, N, H, D, cyclic, per_block, NG, vec, bvec;
  float scale;
};

// window k of the block's chunk: the i-th window of group gb
__device__ __forceinline__ int pair_of(const Args& a, int gb, int i) {
  return a.cyclic ? i * a.G + gb : gb * (a.P / a.G) + i;
}

// rows [0, rows) of a DH-wide tile T (row stride ld) from rows p·N + r of
// ``base`` (row stride ``stride``), zeros past N and past D; 16-byte copies
// when ``vec``
__device__ __forceinline__ void stage_rows(float* T, int ld, int rows, const float* base,
                                           long long stride, int N, int D, bool vec,
                                           int tid, int nthr) {
  if (vec) {
    for (int i = tid; i < rows * (DH / 4); i += nthr) {
      const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
      const bool ok = r < N && c < D;
      cp_async16(T + r * ld + c, ok ? base + r * stride + c : base, ok);
    }
  } else {
    for (int i = tid; i < rows * DH; i += nthr) {
      const int r = i / DH, c = i % DH;
      const bool ok = r < N && c < D;
      cp_async4(T + r * ld + c, ok ? base + r * stride + c : base, ok);
    }
  }
}

// the bias tile [Mp][ldb] from bh [N, N], zeros past N
__device__ __forceinline__ void stage_bias(float* Bs, int ldb, int Mp, int Np,
                                           const float* bh, int N, bool vec, int tid,
                                           int nthr) {
  if (vec) {
    for (int i = tid; i < Mp * (Np / 4); i += nthr) {
      const int r = i / (Np / 4), c = (i % (Np / 4)) * 4;
      const bool ok = r < N && c < N;
      cp_async16(Bs + r * ldb + c, ok ? bh + (long long)r * N + c : bh, ok);
    }
  } else {
    for (int i = tid; i < Mp * Np; i += nthr) {
      const int r = i / Np, c = i % Np;
      const bool ok = r < N && c < N;
      cp_async4(Bs + r * ldb + c, ok ? bh + (long long)r * N + c : bh, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// grid (chunks, G·H), NG groups of QS = ⌈N/16⌉ warps; shared memory: the bias
// tile [Mp][ldb] | per group q, K [Mp | Np][LDP], V [Np][LD].  NT: the key
// n-tiles the score registers hold (N ≤ 8·NT).
template <bool SAVE_LSE, int NT>
__global__ void __launch_bounds__(THREADS, NT <= NT_NARROW ? 2 : 1)
    window_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float wsm[];
  const int N = a.N, H = a.H, D = a.D, HD = H * D;
  const int gb = blockIdx.y / H, h = blockIdx.y % H;
  const int QS = (N + 15) >> 4, Mp = 16 * QS, Np = (N + 7) & ~7, ntv = Np >> 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp / QS, wq = warp % QS;
  const int gtid = threadIdx.x - grp * QS * 32, gthr = QS * 32;
  const int ldb = bias_ld(Np);
  float* const Bs = wsm;
  float* const Qs = Bs + Mp * ldb + grp * fwd_group_floats(Mp, Np);
  float* const Ks = Qs + Mp * LDP;
  float* const Vs = Ks + Np * LDP;
  const long long rs = 3LL * HD;  // qkv's row stride
  const int chunk = blockIdx.x;
  const int i0 = chunk * a.per_block + grp;
  const int i1 = min(a.P / a.G, (chunk + 1) * a.per_block);
  const int nwin = i0 < i1 ? (i1 - i0 + a.NG - 1) / a.NG : 0;
  const bool vec = a.vec;
  const float* qh = a.qkv + h * D;

  auto stage_qk = [&](int p) {
    const float* base = qh + (long long)p * N * rs;
    stage_rows(Qs, LDP, Mp, base, rs, N, D, vec, gtid, gthr);
    stage_rows(Ks, LDP, Np, base + HD, rs, N, D, vec, gtid, gthr);
  };
  auto stage_v = [&](int p) {
    stage_rows(Vs, LD, Np, qh + (long long)p * N * rs + 2 * HD, rs, N, D, vec, gtid, gthr);
  };

  // cp.async groups: [bias, q, K of the first window], then [its V]
  stage_bias(Bs, ldb, Mp, Np, a.bias + ((long long)gb * H + h) * N * N, N, a.bvec,
             threadIdx.x, blockDim.x);
  int p = pair_of(a, gb, i0);
  if (nwin) stage_qk(p);
  cp_async_commit();
  if (nwin) stage_v(p);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // the resident bias, q and K of every group's first window

  // Two group barriers a window: after the scores (V has landed; q and K are
  // free for the next window's) and after P·V (the next q and K have
  // landed; V is free)
  for (int wi = 0; wi < nwin; ++wi) {
    const int p1 = wi + 1 < nwin ? pair_of(a, gb, i0 + (wi + 1) * a.NG) : p;
    // S = q·kᵀ over all keys, the warp's 16 queries
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    const float* Qw = Qs + wq * 16 * LDP;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      FragA fa;
      ld_a_pairs(fa, Qw + ks * 8, LDP, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < ntv) {
          FragB fb;
          ld_b_pairs(fb, Ks + nt * 8 * LDP + ks * 8, LDP, g, t);
          mma3(sc[nt], fa, fb);
        }
      }
    }
    // scale, the bias (float pairs of the zero-padded tile), the exact
    // softmax on the accumulators: every key is here
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int kj = nt * 8 + 2 * t, r = wq * 16 + g + rr * 8;
        float x0 = -INFINITY, x1 = -INFINITY;
        if (nt < ntv) {
          const float2 b = *reinterpret_cast<const float2*>(Bs + r * ldb + kj);
          if (kj < N) x0 = fmaf(sc[nt][2 * rr], a.scale, b.x);
          if (kj + 1 < N) x1 = fmaf(sc[nt][2 * rr + 1], a.scale, b.y);
        }
        sc[nt][2 * rr] = x0;
        sc[nt][2 * rr + 1] = x1;
        mx[rr] = fmaxf(mx[rr], fmaxf(x0, x1));
      }
    }
    const float m[2] = {quad_max(mx[0]), quad_max(mx[1])};  // finite: N ≥ 1
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = __expf(sc[nt][i] - m[i >> 1]);  // 0 past the keys
        sc[nt][i] = pr;
        l[i >> 1] += pr;
      }
    }
    cp_async_wait<0>();     // V of this window
    group_sync(grp, QS);    // ... and the group is done with q, K
    if (wi + 1 < nwin) stage_qk(p1);
    cp_async_commit();
    // O = P·V
    float o[KS][4];
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      if (kk < ntv) {
        FragA fa;
        c_to_a(fa, sc[kk]);
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          FragB fb;
          ld_b_kperm(fb, Vs + kk * 8 * LD + dt * 8, LD, g, t);
          mma3(o[dt], fa, fb);
        }
      }
    }
    const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq * 16 + g + r * 8;
      if (row < N) {
        const float inv = 1.f / lt[r];
        float* orow = a.o + ((long long)p * N + row) * HD + h * D;
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          const int col = dt * 8 + 2 * t;
          const float v0 = o[dt][2 * r] * inv, v1 = o[dt][2 * r + 1] * inv;
          if (col + 1 < D && !(D & 1)) {  // a float pair: whole 32-byte sectors
            *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
          } else {
            if (col < D) orow[col] = v0;
            if (col + 1 < D) orow[col + 1] = v1;
          }
        }
        if (SAVE_LSE && t == 0)
          a.lse_o[((long long)p * H + h) * N + row] = m[r] + logf(lt[r]);
      }
    }
    cp_async_wait<0>();     // q and K of the next window
    group_sync(grp, QS);    // ... and the group is done with V
    if (wi + 1 < nwin) stage_v(p1);
    cp_async_commit();
    p = p1;
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// grid (chunks, G·H), 8 warps; shared memory: the bias tile [Mp][ldb] | q,
// do [Mp][LD] | K, V [Np][LD] | P, dS [rp][ldp] | lse, Δ [Mp] (rp =
// round_rows(Mp, Np)).  NT: the key n-tiles (N ≤ 8·NT).  A warp's query
// units are (slice, key half) = (4k + warp / 2, warp mod 2), k = 0, 1.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1) window_bwd_kernel(const Args a) {
  constexpr int NH = (NT + 1) / 2;  // a key half's n-tiles
  constexpr int JB = NH > 7 ? 2 : 4;  // ... in blocks of JB (the registers' limit)
  extern __shared__ __align__(16) float wsm[];
  const int N = a.N, H = a.H, D = a.D, HD = H * D;
  const int gb = blockIdx.y / H, h = blockIdx.y % H;
  const int QS = (N + 15) >> 4, Mp = 16 * QS, Np = (N + 7) & ~7, ntv = Np >> 3;
  const int rp = round_rows(Mp, Np), rounds = (Mp + rp - 1) / rp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sl = warp >> 1, kh = warp & 1;
  const int ldb = bias_ld(Np), ldp = ps_ld(Np);
  float* const Bs = wsm;
  float* const Qs = Bs + Mp * ldb;
  float* const dOs = Qs + Mp * LD;
  float* const Ks = dOs + Mp * LD;
  float* const Vs = Ks + Np * LD;
  float* const Ps = Vs + Np * LD;
  float* const DSs = Ps + rp * ldp;
  float* const Ls = DSs + rp * ldp;
  float* const Ds = Ls + Mp;
  const long long rs = 3LL * HD;
  const int chunk = blockIdx.x;
  const int i0 = chunk * a.per_block;
  const int i1 = min(a.P / a.G, i0 + a.per_block);
  const int nwin = i0 < i1 ? i1 - i0 : 0;
  const bool vec = a.vec;
  const int tid = threadIdx.x;
  // the warp's key n-tiles in the query phase: its half
  const int h1 = (ntv + 1) >> 1, n0 = kh ? h1 : 0, ncnt = kh ? ntv - h1 : h1;
  // the key phase: combo = (dv | dk) x 16 rows of d, key group = half the
  // key n-tiles
  const int combo = warp & 3, is_dk = combo & 1, md = combo >> 1;
  const int per2 = (ntv + 1) >> 1, m0 = (warp >> 2) * per2, mc = min(ntv - m0, per2);

  auto stage_queries = [&](int p) {  // q, do of window p
    stage_rows(Qs, LD, Mp, a.qkv + (long long)p * N * rs + h * D, rs, N, D, vec, tid,
               THREADS);
    stage_rows(dOs, LD, Mp, a.dout + (long long)p * N * HD + h * D, HD, N, D, vec, tid,
               THREADS);
  };
  auto stage_keys = [&](int p) {  // K, V of window p
    const float* base = a.qkv + (long long)p * N * rs + HD + h * D;
    stage_rows(Ks, LD, Np, base, rs, N, D, vec, tid, THREADS);
    stage_rows(Vs, LD, Np, base + HD, rs, N, D, vec, tid, THREADS);
  };

  stage_bias(Bs, ldb, Mp, Np, a.bias + ((long long)gb * H + h) * N * N, N, a.bvec, tid,
             THREADS);
  if (nwin) {
    const int p = pair_of(a, gb, i0);
    stage_queries(p);
    stage_keys(p);
  }
  cp_async_commit();

  float db[2][NH][4];  // Σ over the chunk's windows of dS at the units' fragments
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) db[k][j][i] = 0.f;

  for (int wi = 0; wi < nwin; ++wi) {
    const int p = pair_of(a, gb, i0 + wi);
    cp_async_wait<0>();
    __syncthreads();  // the window's q, do, K, V (and the first time the bias)
    {  // Δ = rowsum(do ⊙ out) in a fixed order: four threads a row, then
       // their sums in pairs; lse, +inf past the queries (P = 0 there)
      const int quarter = tid & 3;
      for (int r = tid >> 2; r < Mp; r += THREADS / 4) {
        float dsum = 0.f;
        if (r < N) {
          const float* orow = a.out + ((long long)p * N + r) * HD + h * D;
#pragma unroll
          for (int j = 0; j < DH / 4; ++j) {
            const int d = quarter + 4 * j;
            if (d < D) dsum = fmaf(dOs[r * LD + d], orow[d], dsum);
          }
        }
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
        if (!quarter) {
          Ls[r] = r < N ? a.lse[((long long)p * H + h) * N + r] : INFINITY;
          Ds[r] = dsum;
        }
      }
    }
    __syncthreads();

    for (int rnd = 0; rnd < rounds; ++rnd) {
      const int s0 = rnd * rp / 16, s1 = min(QS, s0 + rp / 16);  // the round's slices
      // the query phase: S, dP of a slice's 16 queries against a key half
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s = 4 * k + sl;
        if (s >= s0 && s < s1) {
          const int rr = (s - s0) * 16 + g;  // the slice's rows in the round's tiles
          // the half's n-tiles in blocks of JB: S and dP of a block in
          // registers at a time
#pragma unroll
          for (int jb = 0; jb < NH; jb += JB) {
            float sc[JB][4], dp[JB][4];
#pragma unroll
            for (int jj = 0; jj < JB; ++jj)
#pragma unroll
              for (int i = 0; i < 4; ++i) sc[jj][i] = dp[jj][i] = 0.f;
#pragma unroll 1  // unrolled, the fragment loads hoisted past 255 registers
            for (int ks = 0; ks < KS; ++ks) {
              FragA fq, fd;
              ld_a(fq, Qs + s * 16 * LD + ks * 8, LD, g, t);
              ld_a(fd, dOs + s * 16 * LD + ks * 8, LD, g, t);
#pragma unroll
              for (int jj = 0; jj < JB; ++jj) {
                if (jb + jj < NH && jb + jj < ncnt) {
                  const int o = (n0 + jb + jj) * 8 * LD + ks * 8;
                  FragB fb;
                  ld_b_nmajor(fb, Ks + o, LD, g, t);
                  mma3(sc[jj], fq, fb);
                  ld_b_nmajor(fb, Vs + o, LD, g, t);
                  mma3(dp[jj], fd, fb);
                }
              }
            }
#pragma unroll
            for (int jj = 0; jj < JB; ++jj) {
              const int j = jb + jj;
              if (j < NH) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int r = s * 16 + g + (i >> 1) * 8;
                  const int kj = (n0 + j) * 8 + 2 * t + (i & 1);
                  const bool ok = j < ncnt && kj < N;
                  const float pr =
                      ok ? __expf(sc[jj][i] * a.scale + Bs[r * ldb + kj] - Ls[r]) : 0.f;
                  const float d = pr * (dp[jj][i] - Ds[r]);
                  db[k][j][i] += d;
                  sc[jj][i] = pr;
                  dp[jj][i] = d * a.scale;
                }
                if (j < ncnt) {
                  const int c = (n0 + j) * 8 + 2 * t;
                  *reinterpret_cast<float2*>(Ps + rr * ldp + c) =
                      make_float2(sc[jj][0], sc[jj][1]);
                  *reinterpret_cast<float2*>(Ps + (rr + 8) * ldp + c) =
                      make_float2(sc[jj][2], sc[jj][3]);
                  *reinterpret_cast<float2*>(DSs + rr * ldp + c) =
                      make_float2(dp[jj][0], dp[jj][1]);
                  *reinterpret_cast<float2*>(DSs + (rr + 8) * ldp + c) =
                      make_float2(dp[jj][2], dp[jj][3]);
                }
              }
            }
          }
        }
      }
      __syncthreads();  // P and dS of the round written; V read

      // dq = (dS·scale)·k over all keys, from the dS tile: unit = (slice,
      // 16 columns of d), written once
      for (int u = warp; u < 2 * (s1 - s0); u += WARPS) {
        const int s = s0 + (u >> 1), d0 = (u & 1) * 16;
        float dqa[2][4] = {};
        for (int kk = 0; kk < ntv; ++kk) {
          FragA fa;
          ld_a_pairs(fa, DSs + (s - s0) * 16 * ldp + kk * 8, ldp, g, t);
#pragma unroll
          for (int dt = 0; dt < 2; ++dt) {
            FragB fb;
            ld_b_kperm(fb, Ks + kk * 8 * LD + d0 + dt * 8, LD, g, t);
            mma3(dqa[dt], fa, fb);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = s * 16 + g + r * 8;
          if (row < N) {
            float* drow = a.dqkv + ((long long)p * N + row) * rs + h * D + d0;
#pragma unroll
            for (int dt = 0; dt < 2; ++dt) {
              const int col = dt * 8 + 2 * t;
              if (d0 + col < D) drow[col] = dqa[dt][2 * r];
              if (d0 + col + 1 < D) drow[col + 1] = dqa[dt][2 * r + 1];
            }
          }
        }
      }

      // the key phase: dvᵀ = doᵀ·P, dkᵀ = qᵀ·(dS·scale) over the round's
      // query rows; a later round adds its share to the earlier's rows in
      // dqkv (the same thread wrote them)
      const float* A = (is_dk ? Qs : dOs) + s0 * 16 * LD + md * 16;
      const float* Bt = is_dk ? DSs : Ps;
      const int ksteps = (s1 - s0) * 2;
      float acc[NH][4];
#pragma unroll
      for (int j = 0; j < NH; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int kq = 0; kq < ksteps; ++kq) {
        FragA fa;
        ld_a_tperm(fa, A + kq * 8 * LD, LD, g, t);
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          if (j < mc) {
            FragB fb;
            ld_b_kperm(fb, Bt + kq * 8 * ldp + (m0 + j) * 8, ldp, g, t);
            mma3(acc[j], fa, fb);
          }
        }
      }
      float* dst = a.dqkv + (long long)p * N * rs + (is_dk ? HD : 2 * HD) + h * D;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        if (j < mc) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = md * 16 + g + (i >> 1) * 8, kj = (m0 + j) * 8 + 2 * t + (i & 1);
            if (kj < N && d < D) {
              float* e = dst + (long long)kj * rs + d;
              *e = rnd ? *e + acc[j][i] : acc[j][i];
            }
          }
        }
      }
      __syncthreads();  // P, dS, K and (last round) q, do read
    }
    if (wi + 1 < nwin) {
      const int p1 = pair_of(a, gb, i0 + wi + 1);
      stage_queries(p1);
      stage_keys(p1);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  // this block's dbias partial: the units' fragments tile the [N, N] bias
  if (a.part) {
    float* pp = a.part + (((long long)chunk * a.G + gb) * H + h) * N * N;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = 4 * k + sl;
      if (s < QS) {
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          if (j < ncnt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = s * 16 + g + (i >> 1) * 8, kj = (n0 + j) * 8 + 2 * t + (i & 1);
              if (r < N && kj < N) pp[(long long)r * N + kj] = db[k][j][i];
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// chunks c of each group's R windows over G·H (group, head) rows of blocks,
// ``slots`` blocks the card runs at once and ``walkers`` groups of warps in
// a block sharing its chunk: the fewest whose rounds of blocks times the
// windows a walker takes, ⌈G·H·c / slots⌉·⌈⌈R / c⌉ / walkers⌉, come within
// 5% of the least over c ≤ R (wave quantisation: at Swin-S stage 1 three
// chunks leave the third round of blocks 18% full)
inline int chunk_count(int R, int GH, int slots, int walkers) {
  auto cost = [&](int c) {
    const long long rounds = ((long long)GH * c + slots - 1) / slots;
    return rounds * (((R + c - 1) / c + walkers - 1) / walkers);
  };
  long long best = cost(1);
  for (int c = 2; c <= R; ++c) best = cost(c) < best ? cost(c) : best;
  int c = 1;
  while (20 * cost(c) > 21 * best) ++c;
  return c;
}

// the backward's chunks: one block an SM (ops/fused_layer.py's window_chunks
// mirrors it to size the partials)
inline int bwd_chunks(int P, int G, int H) { return chunk_count(P / G, G * H, SMS, 1); }

inline bool valid(const Args& a) {
  return a.P >= 1 && a.G >= 1 && a.P % a.G == 0 && a.N >= 1 && a.N <= NMAX && a.D >= 1 &&
         a.D <= DH && a.H >= 1 && (long long)a.G * a.H <= 65535 && a.qkv && a.bias;
}

inline void set_vec(Args& a) {
  a.vec = a.D % 4 == 0 && aligned16(a.qkv) && (!a.out || aligned16(a.out)) &&
          (!a.dout || aligned16(a.dout));
  a.bvec = a.N % 4 == 0 && aligned16(a.bias);
}

template <bool SAVE_LSE, int NT>
cudaError_t launch_fwd(const Args& a, dim3 grid, int threads, size_t smem, cudaStream_t s) {
  VTX_CHECK(cudaFuncSetAttribute(window_fwd_kernel<SAVE_LSE, NT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  window_fwd_kernel<SAVE_LSE, NT><<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_bwd(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  VTX_CHECK(cudaFuncSetAttribute(window_bwd_kernel<NT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  window_bwd_kernel<NT><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// out [P·N, H·D] and, when lse is non-null, lse [P, H, N] from qkv
// [P·N, 3·H·D] and the bias [G, H, N, N]; window p in group p / (P/G), or p
// mod G when ``cyclic``
inline cudaError_t attention_fwd(const float* qkv, const float* bias, int G, bool cyclic,
                                 float* out, float* lse, int P, int N, int H, int D,
                                 float scale, cudaStream_t s) {
  Args a{};
  a.qkv = qkv;
  a.bias = bias;
  a.o = out;
  a.lse_o = lse;
  a.P = P, a.G = G, a.N = N, a.H = H, a.D = D, a.cyclic = cyclic, a.scale = scale;
  if (!valid(a) || !out) return cudaErrorInvalidValue;
  set_vec(a);
  const int QS = (N + 15) / 16, Mp = 16 * QS, Np = (N + 7) & ~7, R = P / G;
  a.NG = WARPS / QS < R ? WARPS / QS : R;
  const size_t smem = ((size_t)Mp * bias_ld(Np) + (size_t)a.NG * fwd_group_floats(Mp, Np)) *
                      sizeof(float);
  const int per_sm = SMEM_MAX / smem >= 2 ? 2 : 1;
  const int chunks = chunk_count(R, G * H, SMS * per_sm, a.NG);
  a.per_block = (R + chunks - 1) / chunks;
  const dim3 grid((R + a.per_block - 1) / a.per_block, G * H);
  const int threads = 32 * QS * a.NG;
  const bool narrow = Np <= 8 * NT_NARROW;
  if (lse)
    return narrow ? launch_fwd<true, NT_NARROW>(a, grid, threads, smem, s)
                  : launch_fwd<true, NT_WIDE>(a, grid, threads, smem, s);
  return narrow ? launch_fwd<false, NT_NARROW>(a, grid, threads, smem, s)
                : launch_fwd<false, NT_WIDE>(a, grid, threads, smem, s);
}

// dqkv [P·N, 3·H·D] from qkv, the forward's out and lse, dout [P·N, H·D];
// with dbias non-null, its blocks' partials into part [bwd_chunks(P, G, H),
// G, H, N, N] and their ordered sum into dbias [G, H, N, N]
inline cudaError_t attention_bwd(const float* qkv, const float* out, const float* dout,
                                 const float* lse, const float* bias, int G, bool cyclic,
                                 float* dqkv, float* part, float* dbias, int P, int N,
                                 int H, int D, float scale, cudaStream_t s) {
  Args a{};
  a.qkv = qkv;
  a.bias = bias;
  a.out = out;
  a.dout = dout;
  a.lse = lse;
  a.dqkv = dqkv;
  a.part = dbias ? part : nullptr;
  a.P = P, a.G = G, a.N = N, a.H = H, a.D = D, a.cyclic = cyclic, a.scale = scale;
  if (!valid(a) || !out || !dout || !lse || !dqkv || (dbias && !part))
    return cudaErrorInvalidValue;
  set_vec(a);
  const int QS = (N + 15) / 16, Np = (N + 7) & ~7, chunks = bwd_chunks(P, G, H);
  const int Mp = 16 * QS;
  const size_t smem = (size_t)bwd_floats(Mp, Np, round_rows(Mp, Np)) * sizeof(float);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  a.per_block = (P / G + chunks - 1) / chunks;
  const dim3 grid(chunks, G * H);
  VTX_CHECK(Np <= 8 * NT_NARROW ? launch_bwd<NT_NARROW>(a, grid, smem, s)
                                : launch_bwd<NT_WIDE>(a, grid, smem, s));
  if (dbias) return launch_splitk_reduce(part, chunks, G * H * N, N, dbias, N, 1, s);
  return cudaSuccess;
}

}  // namespace wta
}  // namespace
