// Halo attention on the tensor cores in 3xTF32 (mma_tf32.cuh), forward and
// backward: the attention of three ops (fused_halo.cu)
//   B4   the whole Halo layer, between its GEMMs: q / k / v the packed
//        [M, 3HD] rows of the qkv projection
//   B5a  halo_attention_direct: q [B, H, W, HD], kv [B, H, W, 2HD] maps
//   B5b  halo_attention: q [B', M, HD], kv [B', N, 2HD] gathered windows
//
//   out[window, i] = softmax_j(q_i·k_jᵀ·scale + bias[h, i, j])·v_j
//
// over the N keys j of the window's neighbourhood.  The three differ only in
// addressing (GATHER): on the map, query i of window (wy, wx) is the map
// token of the window's i-th pixel and key j the token of the neighbourhood's
// j-th position, −1 outside the map, which cp.async's zero-fill loads as a
// ZERO key and value (the reference zero-pads the projected kv, so such a
// position scores bias alone and takes softmax mass); gathered, window p's
// rows are p·M … and p·N … .
//
// What halo attention offers, and what the design does with it:
//   * every window of a head has the same bias [M, N]: a block owns one head
//     and a chunk of windows, the head's bias tile stays in shared memory for
//     the whole chunk (Halo-S: 64 x 144, 38.9 KB) and the scores add it from
//     there;
//   * a window's keys fit in shared memory (144 at Halo-S, 100 at window 4 /
//     halo 3), so the forward softmax is exact in one pass; N > KT_FWD keys
//     stream in tiles with the online softmax;
//   * a window's dq, dk and dv are complete inside the window: the backward
//     is one pass per window, with no partial of dk / dv.
//
// Groups.  A window is owned by a group of warps: QS = ⌈M / 16⌉ query slices
// of 16 rows in the forward, and those slices x 2 key halves in the backward
// (a pair of warps at M ≤ 16: no warp idles beyond the padding to 16 rows).
// A block holds as many groups as its shared memory allows (at most 12
// warps forward at heads 32 wide, whose registers then stop at 168, else 8),
// every group walking its own windows of the chunk and syncing on its own
// named barrier, and each group's next window is staged with cp.async while
// the current one computes: in the forward K of the next step lands during
// P·V and V during the next q·kᵀ; in the backward K / V land during the key
// phase, q / do / out / lse during nothing but the other groups' work.  Every staged operand is f32 and split into TF32 hi /
// lo as its fragments load (the split costs ALU, the bytes of shared memory
// read stay those of one f32 tile): hi = cvt.rna.tf32(x) and lo = x − hi
// passed as it is, whose low 13 bits the tensor core does not read (lo
// truncated to TF32, an error below 2⁻²¹·|x|, as CUTLASS's fast 3xTF32
// takes it), one conversion an element instead of mma_tf32.cuh's two.
//
// Forward (halo_fwd_kernel), per window, warp = 16 queries x all keys of the
// tile: S = q·kᵀ in 3xTF32 (q and K fragments loaded as float pairs), scale
// and the resident bias added, row max and sum by quad shuffles, P from the
// accumulators straight to A fragments, O += P·V; lse = m + log l written by
// the training instantiation.  Its integer work per window is kept small:
// no division on the step counters, the map's row table by multiply-shift.
//
// Backward (halo_bwd_kernel), per window, the whole of it:
//   prologue  Δ = rowsum(do ⊙ out) (four threads a row, fixed order), lse
//   queries   warp = 16 queries x one key half: S and dP = do·vᵀ recomputed
//             once, P = exp(S·scale + bias − lse), dS = P ⊙ (dP − Δ); dS
//             summed into the dbias registers (fixed fragment positions for
//             the whole chunk); P and dS·scale to shared memory; dq =
//             dS·k·scale over the half, the two halves added in a fixed
//             order and written once
//   keys      dvᵀ = doᵀ·P and dkᵀ = qᵀ·(dS·scale), d rows x key columns,
//             complete over the window's queries: B5b writes them straight
//             into dkv, B4 / B5a into the per-window buffer dkvw that
//             halo_fold_kernel sums in window order.  Folding inside the block
//             (adjacent windows of a band overlap by 2·halo rows) was not
//             taken: the buffer's traffic (0.9 GB written, read once, at
//             Halo-S stage 1) costs ~0.5 ms of the card's bytes against a
//             backward of several ms, and a fold in the block would order
//             the windows of a band onto one block.
//   dbias     the groups' register sums added in group order through the
//             (dead) bias tile, one partial per block, summed over the
//             blocks in order by launch_splitk_reduce: no [B', H, M, N] dS
//             buffer, no float atomics, bit-identical from run to run.
// A block of the backward owns one (head, key tile): with N > kt_bwd keys the
// tiles are independent (P comes from the saved lse), each writes its dk /
// dv rows and a dq partial, summed in key-tile order afterwards.
//
// mma.sync, not wgmma: a window is 16-64 query rows and its key count is not
// a multiple of 64 (144, 100), and the products need operands transposed
// (Pᵀ·do, dSᵀ·q) that mma.sync loads from shared memory as they are.  It is
// a step toward wgmma, not the end.
//
// What bounds it on this card: 4·M·N·D operations a window and head forward,
// 10·M·N·D backward, at the f32-accurate tensor-core rate (495 / 3 = 165
// TFLOP/s), against the bytes of q, kv, out, do once each (B5a, B4: the map;
// B5b: the gathered kv, 2.25x the map at Halo-S, 6.25x at window 4 / halo
// 3).  At Halo-S the bytes bound both directions (chip_smoke.py's work
// counts).

#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

// map geometry: H x W tokens per image, windows w x w, neighbourhoods k x k,
// hs x ws windows per image; nq / nk queries / keys of a window, qn / kn
// rows of q / kv per image (H·W on the map; nq / nk gathered, where each
// "image" is one window); wdiv / kdiv = ⌈2¹⁶ / w⌉, ⌈2¹⁶ / k⌉: x / w =
// (x·wdiv) >> 16 exactly for x·w < 2¹⁶ (a window's rows, k ≤ 16)
struct HaloGeom {
  int H, W, w, halo, k, hs, ws, nq, nk, qn, kn, wdiv, kdiv;
};

inline HaloGeom halo_geom(int H, int W, int window, int halo) {
  const int k = window + 2 * halo;
  return {H, W, window, halo, k, H / window, W / window, window * window, k * k, H * W,
          H * W, (65535 + window) / window, (65535 + k) / k};
}

// the gathered problem: M queries against N neighbourhood rows per window
inline HaloGeom gather_geom(int M, int N) { return {0, 0, 0, 0, 0, 1, 1, M, N, M, N, 0, 0}; }

namespace hta {

constexpr int WARPS = 8;          // a backward block's warps at most
constexpr int THREADS = 32 * WARPS;
// a forward block's warps: 12 at heads 32 wide (≤ 170 registers a thread),
// 8 at 64 wide (its accumulators need more)
template <int DH>
__host__ __device__ constexpr int fwd_warps() {
  return DH <= 32 ? 12 : 8;
}
constexpr int KT_FWD = 144;       // keys of a resident forward tile
constexpr int NTM = KT_FWD / 8;   // its n-tiles
constexpr int SMEM_MAX = 227 * 1024;
constexpr int SMS = 132;          // H100 SXM streaming multiprocessors

// keys of a backward tile: 144 at heads 32 wide; 72 at 64 wide, where a
// 144-key window would need 245 KB
template <int DH>
__host__ __device__ constexpr int kt_bwd() {
  return DH <= 32 ? 144 : 72;
}

// row strides: the bias tile ≡ 8 (mod 16) floats (a warp's float pairs of
// rows g, 2t hit every bank twice), the P / dS tiles ≡ 4 (mod 16) (rows 2t,
// columns g: conflict-free)
__host__ __device__ __forceinline__ int bias_ld(int ktp) { return ktp % 16 ? ktp : ktp + 8; }
__host__ __device__ __forceinline__ int ps_ld(int ktp) { return ktp % 16 ? ktp + 12 : ktp + 4; }

// shared floats of one group: forward q, K (rows of DH + 8), V; backward q,
// do, out, K, V, P, dS and lse (staged, +inf past the queries), Δ
__host__ __device__ __forceinline__ int fwd_group_floats(int DH, int Mp, int KTp) {
  return (Mp + KTp) * (DH + 8) + KTp * (DH + 4);
}
__host__ __device__ __forceinline__ int bwd_group_floats(int DH, int Mp, int KTp) {
  return (3 * Mp + 2 * KTp) * (DH + 4) + 2 * Mp * ps_ld(KTp) + 3 * Mp;
}

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

using namespace tc;  // split_lo and its fragment loads, group_sync

// token (y·W + x) of query i of window (wy, wx)
__device__ __forceinline__ int q_token(const HaloGeom& g, int wy, int wx, int i) {
  const int iy = (i * g.wdiv) >> 16;
  return (wy * g.w + iy) * g.W + wx * g.w + i - iy * g.w;
}

// token of neighbourhood position j of window (wy, wx), −1 outside the map
__device__ __forceinline__ int nb_token(const HaloGeom& g, int wy, int wx, int j) {
  const int jy = (j * g.kdiv) >> 16;
  const int y = wy * g.w - g.halo + jy;
  const int x = wx * g.w - g.halo + j - jy * g.k;
  return (y >= 0 && y < g.H && x >= 0 && x < g.W) ? y * g.W + x : -1;
}

// window p (image-major, windows row-major; gathered: window p): its rows of
// q / kv.  The row table of the design: query i → q row, neighbourhood
// position j → kv row or −1 (a zero row)
template <bool GATHER>
struct Win {
  int b, wy, wx;
  long long qimg, kimg;
  __device__ __forceinline__ Win(const HaloGeom& g, int p) {
    const int S = g.hs * g.ws, win = GATHER ? 0 : p % S;
    b = GATHER ? p : p / S;
    wy = GATHER ? 0 : win / g.ws;
    wx = GATHER ? 0 : win % g.ws;
    qimg = (long long)b * g.qn;
    kimg = (long long)b * g.kn;
  }
  // the row of query i within its image's rows (lse's index)
  __device__ __forceinline__ int qtok(const HaloGeom& g, int i) const {
    return GATHER ? i : q_token(g, wy, wx, i);
  }
  __device__ __forceinline__ long long qrow(const HaloGeom& g, int i) const {
    return qimg + qtok(g, i);
  }
  __device__ __forceinline__ long long krow(const HaloGeom& g, int j) const {
    const int r = GATHER ? j : nb_token(g, wy, wx, j);
    return r < 0 ? -1 : kimg + r;
  }
};

// rows [0, rows) of a DH-wide tile T (row stride LD, DH + 4 unless given)
// from base[row·stride + c], row = row_of(r) (−1: zeros), zero past D;
// 16-byte copies when ``vec`` (D and the stride multiples of 4, base 16-byte
// aligned), else 4-byte
template <int DH, int LD = DH + 4, class RowOf>
__device__ __forceinline__ void stage_rows(float* T, int rows, const float* base,
                                           long long stride, const RowOf& row_of, int D,
                                           bool vec, int tid, int nthr) {
  if (vec) {
    constexpr int C4 = DH / 4;
    for (int i = tid; i < rows * C4; i += nthr) {
      const int r = i / C4, c = (i % C4) * 4;
      const long long row = c < D ? row_of(r) : -1;
      tc::cp_async16(T + r * LD + c, row >= 0 ? base + row * stride + c : base, row >= 0);
    }
  } else {
    for (int i = tid; i < rows * DH; i += nthr) {
      const int r = i / DH, c = i % DH;
      const long long row = c < D ? row_of(r) : -1;
      tc::cp_async4(T + r * LD + c, row >= 0 ? base + row * stride + c : base, row >= 0);
    }
  }
}

// the bias tile [Mp][ldb]: rows < M, columns [key0, key0 + n) of bh [M, N],
// zeros elsewhere; 16-byte copies when ``vec`` (N a multiple of 4, bh
// 16-byte aligned)
__device__ __forceinline__ void stage_bias(float* Bs, int ldb, int Mp, int KTp,
                                           const float* bh, int M, int N, int key0, int n,
                                           bool vec, int tid, int nthr) {
  if (vec) {
    const int C4 = KTp / 4;
    for (int i = tid; i < Mp * C4; i += nthr) {
      const int r = i / C4, c = (i % C4) * 4;
      const bool ok = r < M && c < n;
      tc::cp_async16(Bs + r * ldb + c, ok ? bh + (long long)r * N + key0 + c : bh, ok);
    }
  } else {
    for (int i = tid; i < Mp * KTp; i += nthr) {
      const int r = i / KTp, c = i % KTp;
      const bool ok = r < M && c < n;
      tc::cp_async4(Bs + r * ldb + c, ok ? bh + (long long)r * N + key0 + c : bh, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float* q;  // head 0's first lane of each operand; element (row, h·D + d)
  const float* k;  // at p[row·stride + h·D + d]
  const float* v;
  long long qs, kvs;
  const float* bias;  // [nh, M, N]
  float* out;         // [rows, HD]
  float* lse;         // [B, nh, qn] or null
  HaloGeom g;
  int nh, D, pairs, per_block, QS, NG, KT, vec, bvec;
  float scale;
};

// grid (chunks, nh), NG groups of QS warps; shared memory: the bias tile
// [Mp][ldb] | per group q [Mp] and K [KTp] rows of DH + 8 (the pair loads),
// V [KTp] rows of DH + 4.  With more than one key tile NG = 1 and the bias
// tile follows the key tile.
template <int DH, bool SAVE_LSE, bool GATHER>
__global__ void __launch_bounds__(32 * fwd_warps<DH>(), 1) halo_fwd_kernel(const FwdArgs a) {
  constexpr int LD = DH + 4, LDP = DH + 8, KS = DH / 8;
  extern __shared__ __align__(16) float smem[];
  const HaloGeom gm = a.g;
  const int h = blockIdx.y, nh = a.nh, D = a.D, HD = nh * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int GW = a.QS, grp = warp / GW, wq = warp % GW;
  const int gtid = threadIdx.x - grp * GW * 32, gthr = GW * 32;
  const int M = gm.nq, N = gm.nk, Mp = 16 * a.QS;
  const int KTILES = (N + a.KT - 1) / a.KT, KTp = (min(N, a.KT) + 7) & ~7;
  const int ldb = bias_ld(KTp);
  float* const Bs = smem;
  float* const Qs = Bs + Mp * ldb + grp * fwd_group_floats(DH, Mp, KTp);
  float* const Ks = Qs + Mp * LDP;
  float* const Vs = Ks + KTp * LDP;
  const float* bh = a.bias + (long long)h * M * N;
  const int p0 = blockIdx.x * a.per_block + grp;
  const int p1 = min(a.pairs, (blockIdx.x + 1) * a.per_block);
  const int nwin = p0 < p1 ? (p1 - p0 + a.NG - 1) / a.NG : 0;
  const bool vec = a.vec;
  const float* qh = a.q + h * D;
  const float* kh = a.k + h * D;
  const float* vh = a.v + h * D;

  auto stage_q = [&](const Win<GATHER>& w) {
    stage_rows<DH, LDP>(
        Qs, Mp, qh, a.qs, [&](int r) -> long long { return r < M ? w.qrow(gm, r) : -1; },
        D, vec, gtid, gthr);
  };
  // K of key tile kt (and with key tiles the bias tile) ...
  auto stage_k = [&](const Win<GATHER>& w, int kt) {
    const int key0 = kt * a.KT, n = min(a.KT, N - key0);
    stage_rows<DH, LDP>(
        Ks, KTp, kh, a.kvs,
        [&](int r) -> long long { return r < n ? w.krow(gm, key0 + r) : -1; }, D, vec,
        gtid, gthr);
    if (KTILES > 1) stage_bias(Bs, ldb, Mp, KTp, bh, M, N, key0, n, a.bvec, gtid, gthr);
  };
  // ... and V
  auto stage_v = [&](const Win<GATHER>& w, int kt) {
    const int key0 = kt * a.KT, n = min(a.KT, N - key0);
    stage_rows<DH>(
        Vs, KTp, vh, a.kvs,
        [&](int r) -> long long { return r < n ? w.krow(gm, key0 + r) : -1; }, D, vec,
        gtid, gthr);
  };

  // cp.async groups: [q, K (+ bias) of a step] then [V of the step]
  if (KTILES == 1)
    stage_bias(Bs, ldb, Mp, KTp, bh, M, N, 0, N, a.bvec, threadIdx.x, blockDim.x);
  Win<GATHER> w(gm, p0);
  if (nwin) {
    stage_q(w);
    stage_k(w, 0);
  }
  tc::cp_async_commit();
  if (nwin) stage_v(w, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  __syncthreads();  // the resident bias, q and K of every group's first step

  // Two group barriers a step: after the scores (V has landed; q, K and the
  // bias tile are free for the next step's) and after P·V (the next step's
  // q and K have landed; V is free for the next step's)
  float o[KS][4], m[2], l[2];
  // the steps (window wi, key tile kt) in order, counted without divisions
  for (int wi = 0, kt = 0; wi < nwin;) {
    const int n = min(a.KT, N - kt * a.KT), ntv = (n + 7) >> 3;
    const bool last = kt == KTILES - 1;
    const int wi1 = last ? wi + 1 : wi, kt1 = last ? 0 : kt + 1;  // the next step
    const Win<GATHER> w1 = last ? Win<GATHER>(gm, p0 + wi1 * a.NG) : w;
    if (kt == 0) {
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
    }
    // S = q·kᵀ over the tile's keys, the warp's 16 queries
    float sc[NTM][4];
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    const float* Qw = Qs + wq * 16 * LDP;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      tc::FragA fa;
      ld_a_pairs(fa, Qw + ks * 8, LDP, g, t);
#pragma unroll
      for (int nt = 0; nt < NTM; ++nt) {
        if (nt < ntv) {
          tc::FragB fb;
          ld_b_pairs(fb, Ks + nt * 8 * LDP + ks * 8, LDP, g, t);
          tc::mma3(sc[nt], fa, fb);
        }
      }
    }
    // scale, the bias (float pairs of the zero-padded tile), the (online)
    // softmax on the accumulators
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) {
      if (nt < ntv) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int kj = nt * 8 + 2 * t, r = wq * 16 + g + rr * 8;
          const float2 b = *reinterpret_cast<const float2*>(Bs + r * ldb + kj);
          const float x0 = kj < n ? fmaf(sc[nt][2 * rr], a.scale, b.x) : -INFINITY;
          const float x1 = kj + 1 < n ? fmaf(sc[nt][2 * rr + 1], a.scale, b.y) : -INFINITY;
          sc[nt][2 * rr] = x0;
          sc[nt][2 * rr + 1] = x1;
          mx[rr] = fmaxf(mx[rr], fmaxf(x0, x1));
        }
      } else {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = -INFINITY;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], tc::quad_max(mx[r]));  // finite: the tile has a key
      alpha[r] = __expf(m[r] - mn);                    // 0 on the first tile
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
    for (int nt = 0; nt < NTM; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = __expf(sc[nt][i] - m[i >> 1]);  // 0 past the keys
        sc[nt][i] = p;
        l[i >> 1] += p;
      }
    }
    tc::cp_async_wait<0>();  // V of this step
    group_sync(grp, GW);     // ... and the group is done with q, K, the bias tile
    if (wi1 < nwin) {
      if (last) stage_q(w1);
      stage_k(w1, kt1);
    }
    tc::cp_async_commit();
    // O += P·V
#pragma unroll
    for (int kk = 0; kk < NTM; ++kk) {
      if (kk < ntv) {
        tc::FragA fa;
        c_to_a(fa, sc[kk]);
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          tc::FragB fb;
          ld_b_kperm(fb, Vs + kk * 8 * LD + dt * 8, LD, g, t);
          tc::mma3(o[dt], fa, fb);
        }
      }
    }
    if (last) {
      const float lt[2] = {tc::quad_sum(l[0]), tc::quad_sum(l[1])};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wq * 16 + g + r * 8;
        if (row < M) {
          const int tok = w.qtok(gm, row);
          const float inv = 1.f / lt[r];
          float* orow = a.out + (w.qimg + tok) * HD + h * D;
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
            a.lse[((long long)w.b * nh + h) * gm.qn + tok] = m[r] + logf(lt[r]);
        }
      }
    }
    tc::cp_async_wait<0>();  // q and K of the next step
    group_sync(grp, GW);     // ... and the group is done with V
    if (wi1 < nwin) stage_v(w1, kt1);
    tc::cp_async_commit();
    w = w1;
    wi = wi1;
    kt = kt1;
  }
  tc::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  long long qs, kvs;
  const float* bias;  // [nh, M, N]
  const float* out;   // [rows, HD]
  const float* dout;  // [rows, HD]
  const float* lse;   // [B, nh, qn]
  float* dq;          // element (row, h·D + d) of key tile kt at dq[kt·dq_kt + row·dqs + …]
  long long dqs, dq_kt;
  float* dkv;         // window p's key j: row p·N + j, 2HD lanes (dk, then dv)
  float* part;        // [chunks, nh, M, N]: the blocks' dS sums
  HaloGeom g;
  int nh, D, pairs, per_block, QS, NG, KT, vec, bvec;
  float scale;
};

// grid (chunks, nh · key tiles), NG groups of 2·QS warps; shared memory: the
// bias tile [Mp][ldb] | per group q, do, out [Mp] K, V [KTp] rows of DH + 4,
// P, dS [Mp][ldp], staged lse, lse, Δ [Mp]
template <int DH, bool GATHER>
__global__ void __launch_bounds__(THREADS, 1) halo_bwd_kernel(const BwdArgs a) {
  constexpr int LD = DH + 4, KS = DH / 8, C = 2 * (DH / 16);
  constexpr int NTB = kt_bwd<DH>() / 8, NH = (NTB + 1) / 2;  // a tile's n-tiles, a half's
  extern __shared__ __align__(16) float smem[];
  const HaloGeom gm = a.g;
  const int nh = a.nh, D = a.D, HD = nh * D;
  const int h = blockIdx.y % nh, kt = blockIdx.y / nh;
  const int M = gm.nq, N = gm.nk, QS = a.QS, Mp = 16 * QS, GW = 2 * QS;
  const int key0 = kt * a.KT, n = min(a.KT, N - key0), ntv = (n + 7) >> 3;
  const int KTp = (min(N, a.KT) + 7) & ~7, ldb = bias_ld(KTp), ldp = ps_ld(KTp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp / GW, wg = warp % GW, wq = wg % QS, kg = wg / QS;
  const int gtid = threadIdx.x - grp * GW * 32, gthr = GW * 32;
  float* const Bs = smem;
  float* const Qs = Bs + Mp * ldb + grp * bwd_group_floats(DH, Mp, KTp);
  float* const dOs = Qs + Mp * LD;
  float* const Os = dOs + Mp * LD;
  float* const Ks = Os + Mp * LD;
  float* const Vs = Ks + KTp * LD;
  float* const Ps = Vs + KTp * LD;
  float* const DSs = Ps + Mp * ldp;
  float* const Lr = DSs + Mp * ldp;
  float* const Ls = Lr + Mp;
  float* const Ds = Ls + Mp;
  float* const X = Os;  // the second key half's dq (out is dead by then)
  const float* bh = a.bias + (long long)h * M * N;
  const int p0 = blockIdx.x * a.per_block + grp;
  const int p1 = min(a.pairs, (blockIdx.x + 1) * a.per_block);
  const int nwin = p0 < p1 ? (p1 - p0 + a.NG - 1) / a.NG : 0;
  const bool vec = a.vec;
  const float* qh = a.q + h * D;
  const float* kh = a.k + h * D;
  const float* vh = a.v + h * D;
  const float* oh = a.out + h * D;
  const float* doh = a.dout + h * D;
  // the warp's n-tiles in the query phase: its key half of the tile
  const int h1 = (ntv + 1) >> 1, n0 = kg ? h1 : 0, ncnt = kg ? ntv - h1 : h1;

  auto stage_queries = [&](int wi) {  // q, do, out rows and lse of window wi
    const Win<GATHER> w(gm, p0 + wi * a.NG);
    auto row = [&](int r) -> long long { return r < M ? w.qrow(gm, r) : -1; };
    stage_rows<DH>(Qs, Mp, qh, a.qs, row, D, vec, gtid, gthr);
    stage_rows<DH>(dOs, Mp, doh, HD, row, D, vec, gtid, gthr);
    stage_rows<DH>(Os, Mp, oh, HD, row, D, vec, gtid, gthr);
    const float* lh = a.lse + ((long long)w.b * nh + h) * gm.qn;
    for (int r = gtid; r < Mp; r += gthr) {
      const bool ok = r < M;
      tc::cp_async4(Lr + r, ok ? lh + w.qtok(gm, r) : lh, ok);
    }
  };
  auto stage_keys = [&](int wi) {  // K, V rows of the tile of window wi
    const Win<GATHER> w(gm, p0 + wi * a.NG);
    auto row = [&](int r) -> long long { return r < n ? w.krow(gm, key0 + r) : -1; };
    stage_rows<DH>(Ks, KTp, kh, a.kvs, row, D, vec, gtid, gthr);
    stage_rows<DH>(Vs, KTp, vh, a.kvs, row, D, vec, gtid, gthr);
  };

  stage_bias(Bs, ldb, Mp, KTp, bh, M, N, key0, n, a.bvec, threadIdx.x, blockDim.x);
  if (nwin) {
    stage_queries(0);
    stage_keys(0);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();  // the resident bias and every group's first window

  float db[NH][4];  // Σ over the chunk's windows of dS at the warp's fragments
#pragma unroll
  for (int j = 0; j < NH; ++j) db[j][0] = db[j][1] = db[j][2] = db[j][3] = 0.f;

  for (int wi = 0; wi < nwin; ++wi) {
    const int p = p0 + wi * a.NG;
    const Win<GATHER> w(gm, p);
    if (wi) {
      tc::cp_async_wait<0>();
      group_sync(grp, GW);
    }
    {  // Δ = rowsum(do ⊙ out) in a fixed order: four threads a row, then
       // their sums in pairs; lse (+inf past the queries: P = 0)
      const int r = gtid >> 2, quarter = gtid & 3;
      float dsum = 0.f;
#pragma unroll
      for (int j = 0; j < DH / 4; ++j) {
        const int i = r * LD + quarter + 4 * j;
        dsum = fmaf(dOs[i], Os[i], dsum);
      }
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      if (!quarter) {
        Ls[r] = r < M ? Lr[r] : INFINITY;
        Ds[r] = dsum;
      }
    }
    group_sync(grp, GW);

    // the query phase: S, dP of the warp's 16 queries against its key half
    float sc[NH][4], dp[NH][4];
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      tc::FragA fq, fd;
      ld_a(fq, Qs + wq * 16 * LD + ks * 8, LD, g, t);
      ld_a(fd, dOs + wq * 16 * LD + ks * 8, LD, g, t);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        if (j < ncnt) {
          const int o = (n0 + j) * 8 * LD + ks * 8;
          tc::FragB fb;
          ld_b_nmajor(fb, Ks + o, LD, g, t);
          tc::mma3(sc[j], fq, fb);
          ld_b_nmajor(fb, Vs + o, LD, g, t);
          tc::mma3(dp[j], fd, fb);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wq * 16 + g + (i >> 1) * 8, kj = (n0 + j) * 8 + 2 * t + (i & 1);
        const bool ok = j < ncnt && kj < n;
        const float pr = ok ? expf(sc[j][i] * a.scale + Bs[r * ldb + kj] - Ls[r]) : 0.f;
        const float d = pr * (dp[j][i] - Ds[r]);
        db[j][i] += d;
        sc[j][i] = pr;
        dp[j][i] = d * a.scale;
      }
      if (j < ncnt) {
        const int c = (n0 + j) * 8 + 2 * t, r = wq * 16 + g;
        *reinterpret_cast<float2*>(Ps + r * ldp + c) = make_float2(sc[j][0], sc[j][1]);
        *reinterpret_cast<float2*>(Ps + (r + 8) * ldp + c) = make_float2(sc[j][2], sc[j][3]);
        *reinterpret_cast<float2*>(DSs + r * ldp + c) = make_float2(dp[j][0], dp[j][1]);
        *reinterpret_cast<float2*>(DSs + (r + 8) * ldp + c) = make_float2(dp[j][2], dp[j][3]);
      }
    }
    // dq = dS·k·scale over the key half
    float dqa[KS][4];
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) dqa[dt][0] = dqa[dt][1] = dqa[dt][2] = dqa[dt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      if (j < ncnt) {
        tc::FragA fa;
        c_to_a(fa, dp[j]);
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          tc::FragB fb;
          ld_b_kperm(fb, Ks + (n0 + j) * 8 * LD + dt * 8, LD, g, t);
          tc::mma3(dqa[dt], fa, fb);
        }
      }
    }
    if (kg) {
#pragma unroll
      for (int dt = 0; dt < KS; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) X[((wq * KS + dt) * 4 + i) * 32 + lane] = dqa[dt][i];
    }
    group_sync(grp, GW);  // P, dS and the second half's dq written; K, V read
    if (wi + 1 < nwin) stage_keys(wi + 1);
    tc::cp_async_commit();
    if (!kg) {  // dq: the first key half's, then the second's, written once
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wq * 16 + g + r * 8;
        float v0[KS], v1[KS];
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          v0[dt] = dqa[dt][2 * r] + X[((wq * KS + dt) * 4 + 2 * r) * 32 + lane];
          v1[dt] = dqa[dt][2 * r + 1] + X[((wq * KS + dt) * 4 + 2 * r + 1) * 32 + lane];
        }
        if (row < M) {
          float* drow = a.dq + kt * a.dq_kt + w.qrow(gm, row) * a.dqs + h * D;
#pragma unroll
          for (int dt = 0; dt < KS; ++dt) {
            const int col = dt * 8 + 2 * t;
            if (col < D) drow[col] = v0[dt];
            if (col + 1 < D) drow[col + 1] = v1[dt];
          }
        }
      }
    }

    // the key phase: dvᵀ = doᵀ·P, dkᵀ = qᵀ·(dS·scale); unit u = (combo, key
    // group): combo = (dv | dk) x 16 rows of d, the tile's n-tiles split
    // over the warps a combo has
    const int ngrp = GW >= C ? GW / C : 1, per2 = (ntv + ngrp - 1) / ngrp;
    for (int u = wg; u < C * ngrp; u += GW) {
      const int combo = u % C, is_dk = combo & 1, md = combo >> 1;
      const int m0 = (u / C) * per2, mc = min(ntv - m0, per2);
      const float* A = is_dk ? Qs : dOs;
      const float* Bt = is_dk ? DSs : Ps;
      float acc[NTB][4];
#pragma unroll
      for (int j = 0; j < NTB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int kq = 0; kq < Mp / 8; ++kq) {
        tc::FragA fa;
        ld_a_tperm(fa, A + kq * 8 * LD + md * 16, LD, g, t);
#pragma unroll
        for (int j = 0; j < NTB; ++j) {
          if (j < mc) {
            tc::FragB fb;
            ld_b_kperm(fb, Bt + kq * 8 * ldp + (m0 + j) * 8, ldp, g, t);
            tc::mma3(acc[j], fa, fb);
          }
        }
      }
      float* dst = a.dkv + ((long long)p * N + key0) * 2 * HD + (is_dk ? 0 : HD) + h * D;
#pragma unroll
      for (int j = 0; j < NTB; ++j) {
        if (j < mc) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = md * 16 + g + (i >> 1) * 8, kj = (m0 + j) * 8 + 2 * t + (i & 1);
            if (kj < n && d < D) dst[(long long)kj * 2 * HD + d] = acc[j][i];
          }
        }
      }
    }
    group_sync(grp, GW);  // q, do, P, dS and X read
    if (wi + 1 < nwin) stage_queries(wi + 1);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<0>();

  // this block's dbias partial: the groups' sums added in group order in the
  // bias tile (every group done with it), then written once
  __syncthreads();
  for (int gg = 0; gg < a.NG; ++gg) {
    if (grp == gg) {
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        if (j < ncnt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = wq * 16 + g + (i >> 1) * 8, kj = (n0 + j) * 8 + 2 * t + (i & 1);
            float* b = Bs + r * ldb + kj;
            *b = gg ? *b + db[j][i] : db[j][i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* pp = a.part + ((long long)blockIdx.x * nh + h) * M * N + key0;
  for (int i = threadIdx.x; i < M * n; i += blockDim.x) {
    const int r = i / n, c = i % n;
    pp[(long long)r * N + c] = Bs[r * ldb + c];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// blocks a chunk count aims at: two waves of the blocks one SM holds
inline int wave_chunks(size_t smem, int threads, int rows_of_blocks, int pairs, int NG) {
  const int per_sm = imin((int)(SMEM_MAX / smem), 2048 / threads);
  const long long want = 2LL * SMS * (per_sm > 1 ? per_sm : 1) / rows_of_blocks;
  const int most = (pairs + NG - 1) / NG;
  return want < 1 ? 1 : want > most ? most : (int)want;
}

inline size_t fwd_smem(int DH, int Mp, int KTp, int NG) {
  return ((size_t)Mp * bias_ld(KTp) + (size_t)NG * fwd_group_floats(DH, Mp, KTp)) *
         sizeof(float);
}

inline size_t bwd_smem(int DH, int Mp, int KTp, int NG) {
  return ((size_t)Mp * bias_ld(KTp) + (size_t)NG * bwd_group_floats(DH, Mp, KTp)) *
         sizeof(float);
}

template <int DH, bool SAVE_LSE, bool GATHER>
cudaError_t launch_fwd_t(const FwdArgs& a, dim3 grid, int threads, size_t smem,
                         cudaStream_t s) {
  VTX_CHECK(cudaFuncSetAttribute(halo_fwd_kernel<DH, SAVE_LSE, GATHER>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  halo_fwd_kernel<DH, SAVE_LSE, GATHER><<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int DH, bool GATHER>
cudaError_t fwd_dh(FwdArgs a, cudaStream_t s) {
  const int M = a.g.nq, N = a.g.nk;
  a.QS = (M + 15) / 16;
  a.KT = KT_FWD;
  const int Mp = 16 * a.QS, KTp = (imin(N, a.KT) + 7) & ~7;
  int NG = N > a.KT ? 1 : imin(fwd_warps<DH>() / a.QS, a.pairs);
  while (NG > 1 && fwd_smem(DH, Mp, KTp, NG) > SMEM_MAX) --NG;
  const size_t smem = fwd_smem(DH, Mp, KTp, NG);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  a.NG = NG;
  const int threads = 32 * a.QS * NG;
  const int chunks = wave_chunks(smem, threads, a.nh, a.pairs, NG);
  a.per_block = (a.pairs + chunks - 1) / chunks;
  const dim3 grid((a.pairs + a.per_block - 1) / a.per_block, a.nh);
  return a.lse ? launch_fwd_t<DH, true, GATHER>(a, grid, threads, smem, s)
               : launch_fwd_t<DH, false, GATHER>(a, grid, threads, smem, s);
}

// the forward over ``pairs`` windows of nh heads; the 32-wide instantiation
// for D ≤ 32
template <bool GATHER>
cudaError_t attention_fwd(FwdArgs a, cudaStream_t s) {
  if (a.pairs < 1 || a.nh < 1 || a.nh > 65535 || a.D < 1 || a.D > 64 || a.g.nq < 1 ||
      a.g.nq > 64 || a.g.nk < 1)
    return cudaErrorInvalidValue;
  a.vec = a.D % 4 == 0 && a.qs % 4 == 0 && a.kvs % 4 == 0 && aligned16(a.q) &&
          aligned16(a.k) && aligned16(a.v);
  a.bvec = a.g.nk % 4 == 0 && aligned16(a.bias);
  return a.D <= 32 ? fwd_dh<32, GATHER>(a, s) : fwd_dh<64, GATHER>(a, s);
}

template <int DH, bool GATHER>
cudaError_t bwd_dh(BwdArgs a, int chunks, cudaStream_t s) {
  const int M = a.g.nq, N = a.g.nk;
  a.QS = (M + 15) / 16;
  a.KT = kt_bwd<DH>();
  const int Mp = 16 * a.QS, KTp = (imin(N, a.KT) + 7) & ~7, GW = 2 * a.QS;
  const int KTILES = (N + a.KT - 1) / a.KT;
  if ((long long)a.nh * KTILES > 65535) return cudaErrorInvalidValue;
  int NG = imin(WARPS / GW, (a.pairs + chunks - 1) / chunks);
  while (NG > 1 && bwd_smem(DH, Mp, KTp, NG) > SMEM_MAX) --NG;
  const size_t smem = bwd_smem(DH, Mp, KTp, NG);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  a.NG = NG;
  a.per_block = (a.pairs + chunks - 1) / chunks;
  VTX_CHECK(cudaFuncSetAttribute(halo_bwd_kernel<DH, GATHER>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  halo_bwd_kernel<DH, GATHER><<<dim3(chunks, a.nh * KTILES), 32 * GW * NG, smem, s>>>(a);
  return cudaGetLastError();
}

// keys of the backward's tiles at head width D (ops/fused_halo.py mirrors it
// to size the dq partials)
inline int bwd_key_tile(int D) { return D <= 32 ? kt_bwd<32>() : kt_bwd<64>(); }

// The backward over ``pairs`` windows of nh heads: dq (rows of ``dq`` with
// stride dqs; with more than one key tile first key-tile partials in dq_part
// [KT, rows, HD], summed in order afterwards), dk / dv into a.dkv, the blocks'
// dbias partials into a.part [chunks, nh, M, N].  ``rows`` = the q rows of
// the whole problem.
template <bool GATHER>
cudaError_t attention_bwd(BwdArgs a, int chunks, float* dq_part, long long rows,
                          cudaStream_t s) {
  if (a.pairs < 1 || a.nh < 1 || a.D < 1 || a.D > 64 || a.g.nq < 1 || a.g.nq > 64 ||
      a.g.nk < 1 || chunks < 1 || chunks > a.pairs || chunks > 65535)
    return cudaErrorInvalidValue;
  const int HD = a.nh * a.D, KTILES = (a.g.nk + bwd_key_tile(a.D) - 1) / bwd_key_tile(a.D);
  a.vec = a.D % 4 == 0 && a.qs % 4 == 0 && a.kvs % 4 == 0 && HD % 4 == 0 &&
          aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.out) &&
          aligned16(a.dout);
  a.bvec = a.g.nk % 4 == 0 && aligned16(a.bias);
  float* const dq = a.dq;
  const long long dqs = a.dqs;
  a.dq_kt = 0;
  if (KTILES > 1) {
    if (!dq_part) return cudaErrorInvalidValue;
    a.dq = dq_part;
    a.dqs = HD;
    a.dq_kt = rows * HD;
  }
  VTX_CHECK((a.D <= 32 ? bwd_dh<32, GATHER>(a, chunks, s) : bwd_dh<64, GATHER>(a, chunks, s)));
  if (KTILES > 1) return launch_splitk_reduce(dq_part, KTILES, (int)rows, HD, dq, dqs, 1, s);
  return cudaSuccess;
}

}  // namespace hta
}  // namespace
