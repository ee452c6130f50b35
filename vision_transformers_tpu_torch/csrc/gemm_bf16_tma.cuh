// The GEMM core's bf16 form on Hopper's Tensor Memory Accelerator (sm_90a):
// the projections of B1 (forward, backward) and B2 (forward) at the JAX
// package's default precision, wherever TMA can describe the operands
// (gemm_tc.cu launch_gemm_bf16 / launch_gemm_splitk_bf16 route by shape;
// operands off 16-byte strides keep gemm_tc.cu's register path).  It
// replaces, for the bf16 calls of the TPU kernels, the projections that
// vision_transformers_tpu/ops/fused_layer.py:116 / :183 (B1 fwd / bwd) and
// fused_layer1.py:91 (B2 fwd) compute on the MXU.
//
//   out[M, N] = epilogue(A·B)          the row form: A [M, K] row-major;
//                                      B [N, K] (K-major: the forward's
//                                      weight views) or [K, N] (MN-major:
//                                      the data gradients' weights, read in
//                                      place); out bf16 through the JAX
//                                      kernels' rounding points, or f32
//   part[z] = Aᵀ[:, slab z]·B[slab z]  the split-K form: A as Aᵀ storage
//                                      [K, M] and B [K, N] (the weight
//                                      gradients' activations and dY), both
//                                      MN-major; f32 partials
//
// The design.  A persistent block an SM walks the 128 x BN output tiles
// (tile blockIdx.x, + gridDim.x, ..., n fastest; split-K slab z slowest)
// with three warpgroups:
//   the producer  one thread issues the TMA loads of each 64-deep k stage
//                 (128 bytes of bf16: the swizzle's width) of A [128 x 64]
//                 and B [BN x 64] into a ring of stages, 128-byte swizzled
//                 as wgmma reads them, K-major tiles as one box along k,
//                 MN-major ones as 64-wide boxes along their rows; each
//                 stage's mbarrier counts the bytes in (full), a second
//                 the consumers' warps out (empty).  setmaxnreg gives its
//                 registers to the consumers (40 / 232).
//   the consumers two warpgroups run m64nBNk16 wgmmas on each full stage
//                 (the transpose bits for MN-major tiles), one group a
//                 stage, the previous stage's group in flight
//                 (wait_group 1) before it is given back; both on each
//                 tile, 64 rows each (the cooperative schedule: a
//                 ping-pong one, each warpgroup its own tiles, was no
//                 faster on the H100, PERF.md).
//   the epilogue  the sums through the JAX rounding points in registers
//                 (bf16: round(acc), + bias rounded, silu rounded, ×
//                 round(rs) rounded, + res rounded as stored, each a pass
//                 over the thread's values; f32: the raw sums), written
//                 128-byte swizzled into the warpgroup's staging tile (4-
//                 or 8-byte stores, no bank conflicts), then one TMA store
//                 of its 64 rows left in flight: the tile's stores overlap
//                 the next tile's wgmmas, and the staging tile is waited
//                 for only when it is written again.  What the epilogue
//                 reads comes as the tile starts, under its mainloop: the
//                 residual by TMA into the staging tile (added in place),
//                 the bias as bf16 pairs through shared memory, the row
//                 scales into registers.
// Ragged M, N and K are TMA's zero fill on the loads and its clipping on
// the stores; split-K slabs are whole stages (k_chunk a multiple of 64).
// No float atomics: the partials are summed in slab order by the caller
// (splitk_reduce_kernel), so every result is bit-identical from run to run.
//
// Precision.  The sums of bf16 products are accumulated by the tensor cores
// in f32, each tile over its whole K in one accumulator: the promotion the
// f32 form needs (its TF32 sums truncate) is kept here only as the thin
// door's option, since the card check (chip_smoke.py phase 3bf) finds the
// bf16 sums within their limits without it (PERF.md).
//
// What bounds it on this card.  2·M·N·K operations against 2·(M·K + K·N)
// + 2 or 4·M·N bytes: at ViT-S/16's products (K, N ≥ 384, M = 25,216) the
// bytes and the bf16 rate (989 TFLOP/s) are within 2x of each other
// (chip_smoke prints which bounds each).  What the design does about it:
// nothing is staged through registers or written twice, the operands are
// read once from device memory per tile row (A) or from L2 (B), and the
// store of each output tile runs under the next tile's products.

#pragma once

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {
namespace gtma {

using namespace wgm;
using namespace tma;

// a tile's rows, the depth of a stage, the block (two consumer warpgroups,
// one producer warpgroup)
constexpr int BM = 128, BKS = 64, THREADS = 384;

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return (BM + BN) * BKS * 2;
}

// a warpgroup's staging tile: 64 rows x BN of the output
template <int BN, int F32OUT>
__host__ __device__ constexpr int staging_bytes() {
  return 64 * BN * (F32OUT ? 4 : 2);
}

// the ring's stages: what the shared memory holds beside two staging tiles,
// the tail (the barriers, the warpgroups' bias rows) and the base's
// alignment, at most 8
constexpr int TAIL = 2048;
template <int BN, int F32OUT>
__host__ __device__ constexpr int stages() {
  return (227 * 1024 - 1024 - TAIL - 2 * staging_bytes<BN, F32OUT>()) / stage_bytes<BN>() < 8
             ? (227 * 1024 - 1024 - TAIL - 2 * staging_bytes<BN, F32OUT>()) / stage_bytes<BN>()
             : 8;
}

template <int BN, int F32OUT>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<BN, F32OUT>() * stage_bytes<BN>() + 2 * staging_bytes<BN, F32OUT>() +
         TAIL;
}

// The kernels compiled: the rule's widths (64 and 128 columns in every
// layout, 192 for the forward's bf16 products); the promotion every 64 k
// only where phase 3bf checks it (f32 out, K-major operands, 64 columns: at
// 128 its three sums spill)
template <int BN, int TA, int TB, int F32OUT, int PROMO>
constexpr bool compiled() {
  if (PROMO) return TA == 0 && TB == 0 && F32OUT && BN == 64;
  return BN <= 128 || (BN == 192 && TA == 0 && TB == 0 && !F32OUT);
}

// the kernel's parameters: the tensor maps (A, B, out, res), the epilogue's
// inputs and the problem
struct Params {
  CUtensorMap a, b, out, res;
  const bf16* bias;
  const float* rs;
  int rs_rows, M, N, K, k_chunk, silu, has_res;
};

// a consumer warpgroup's barrier (0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// k16 step kk of a stage: the 64 rows of A at sa (K-major: 32 bytes along
// the row a step; MN-major: two 8-k groups) and B at sb
template <int BN, int TA, int TB>
__device__ __forceinline__ void mma_k(float (&d)[BN / 2], uint32_t sa, uint32_t sb, int kk,
                                      int scale_d) {
  const uint64_t da = TA ? desc_mn(sa + 2048 * kk) : desc_k(sa + 32 * kk);
  const uint64_t db = TB ? desc_mn(sb + 2048 * kk) : desc_k(sb + 32 * kk);
  wgmma_bf16<BN, TA, TB>(d, da, db, scale_d);
}

struct Tile {
  int m0, n0, z, k0, stages;
};

// tile t of the cdiv(N, BN) x cdiv(M, BM) x splits tiles, n fastest
template <int BN>
__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  const int tn = (p.N + BN - 1) / BN, tm = (p.M + BM - 1) / BM;
  Tile T;
  T.n0 = t % tn * BN;
  T.m0 = t / tn % tm * BM;
  T.z = t / (tn * tm);
  T.k0 = T.z * p.k_chunk;
  const int k_end = min(p.K, T.k0 + p.k_chunk);
  T.stages = k_end > T.k0 ? (k_end - T.k0 + BKS - 1) / BKS : 0;
  return T;
}

// the ring position n stages on
template <int S>
__device__ __forceinline__ void advance(int& st, int& ph, int n) {
  st += n;
  ph ^= (st / S) & 1;
  st %= S;
}

template <int BN, int TA, int TB, int F32OUT>
__device__ __forceinline__ void produce(const Params& p, char* ring, uint64_t* full,
                                        uint64_t* empty, int tiles) {
  constexpr int S = stages<BN, F32OUT>(), SB = stage_bytes<BN>();
  int st = 0, ph = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile T = tile_of<BN>(p, t);
    for (int s = 0; s < T.stages; ++s) {
      mbar_wait(empty + st, ph ^ 1);  // the first round passes: the ring starts empty
      mbar_expect_tx(full + st, SB);
      char* sa = ring + st * SB;
      char* sb = sa + BM * BKS * 2;
      const int k = T.k0 + s * BKS;
      if constexpr (TA) {
        tma_load(sa, &p.a, full + st, T.m0, k);
        tma_load(sa + 8192, &p.a, full + st, T.m0 + 64, k);
      } else {
        tma_load(sa, &p.a, full + st, k, T.m0);
      }
      if constexpr (TB) {
#pragma unroll
        for (int i = 0; i < BN / 64; ++i) tma_load(sb + 8192 * i, &p.b, full + st, T.n0 + 64 * i, k);
      } else {
        tma_load(sb, &p.b, full + st, k, T.n0);
      }
      advance<S>(st, ph, 1);
    }
  }
}

// the residual's 64 rows at m_base into the warpgroup's staging tile, once
// its last store has read it (its leader)
template <int BN>
__device__ __forceinline__ void load_res(const Params& p, char* stg, uint64_t* rb, int m_base,
                                         int n0) {
  bulk_wait_read();
  mbar_expect_tx(rb, 64 * BN * 2);
#pragma unroll
  for (int i = 0; i < BN / 64; ++i) tma_load(stg + 8192 * i, &p.res, rb, n0 + 64 * i, m_base);
}

// byte offset of bf16 element (r, c) of a warpgroup's staging tile: the
// TMA boxes of 64 rows x 128 bytes, 16-byte chunk k of row r at k ^ (r mod 8)
__device__ __forceinline__ int bf16_slot(int r, int c) {
  return (c >> 6) * 8192 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// The bf16 epilogue's inputs from device memory, read as a tile starts so
// that their latency passes under its mainloop: a bf16 pair of the tile's
// bias (the warpgroup's thread t < BN / 2: columns 2t, 2t + 1), and the
// rounded row scales of the thread's two rows
struct EpiIn {
  uint32_t bias;
  float rr[2];
};

template <int BN>
__device__ __forceinline__ void load_epi(EpiIn& in, const Params& p, int m_base, int n0) {
  const int t = threadIdx.x & 127, r0 = 16 * ((t >> 5) & 3) + ((t & 31) >> 2);
  const int n = n0 + 2 * t;  // N is a multiple of 8: the pair is whole
  in.bias = p.bias && t < BN / 2 && n < p.N
                ? __ldg(reinterpret_cast<const unsigned int*>(p.bias + n))
                : 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m_base + r0 + 8 * h;
    in.rr[h] = p.rs && m < p.M ? rnd<bf16>(__ldg(p.rs + m / p.rs_rows)) : 1.f;
  }
}

// The epilogue of one warpgroup's 64 rows at m_base: d[4j + 2h + e] is row
// 16·warp + lane / 4 + 8h, column 8j + 2·(lane % 4) + e.  The staging tile
// holds TMA's 128-byte swizzled boxes (64 rows x 128 bytes: 64 bf16 or 32
// f32 columns), 16-byte chunk c of row r at chunk c ^ (r mod 8).  bias_s:
// the warpgroup's row of the tile's bias pairs, filled here from bias.
template <int BN, int F32OUT>
__device__ __forceinline__ void store_block(const Params& p, const float (&d)[BN / 2],
                                            char* stg, uint32_t* bias_s, uint32_t bias,
                                            const float (&rr)[2], uint64_t* rb, int& res_ph,
                                            int wg, int m_base, int n0, int z) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3, t = threadIdx.x & 127;
  const bool leader = t == 0;
  if (m_base >= p.M) return;  // rows past M: nothing to store (uniform in the warpgroup)
  const bool res = !F32OUT && p.has_res;
  if (!F32OUT && t < BN / 2) bias_s[t] = bias;
  if (res) {  // the residual is in the staging tile
    mbar_wait(rb, res_ph);
    res_ph ^= 1;
  } else if (leader) {  // the staging tile's last store has read it
    bulk_wait_read();
  }
  wg_sync(wg);
  const int r0 = 16 * w4 + (lane >> 2), cq = 2 * (lane & 3);
  if constexpr (F32OUT) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + cq;
        const int off = (c >> 5) * 8192 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
                        (c & 3) * 4;
        *reinterpret_cast<float2*>(stg + off) = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  } else {
    // each option a pass over all of the thread's values: its branch is
    // taken once and the values' chains interleave (a branch an element
    // kept them apart: on the H100 qkv took 0.077 ms that way against
    // 0.061, FF1 0.160 against 0.111; PERF.md)
    float v[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) v[i] = rnd<bf16>(d[i]);
    if (p.bias) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t bu = bias_s[(8 * j + cq) / 2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[4 * j + 2 * h] = rnd<bf16>(v[4 * j + 2 * h] + lo_f32(bu));
          v[4 * j + 2 * h + 1] = rnd<bf16>(v[4 * j + 2 * h + 1] + hi_f32(bu));
        }
      }
    }
    if (p.silu) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) v[i] = rnd<bf16>(act_fwd<ACT_SILU>(v[i]));
    }
    if (p.rs) {  // v[4j + 2h + e] is row r0 + 8h
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) v[i] = rnd<bf16>(v[i] * rr[(i >> 1) & 1]);
    }
    if (res) {  // + res, rounded as stored
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t* slot = reinterpret_cast<uint32_t*>(stg + bf16_slot(r0 + 8 * h, 8 * j + cq));
          const uint32_t u = *slot;
          *slot = pack_bf16(v[4 * j + 2 * h] + lo_f32(u), v[4 * j + 2 * h + 1] + hi_f32(u));
        }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(stg + bf16_slot(r0 + 8 * h, 8 * j + cq)) =
              pack_bf16(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
    }
  }
  fence_proxy_async();
  wg_sync(wg);
  if (leader) {
    constexpr int BOX = F32OUT ? 32 : 64;
#pragma unroll
    for (int i = 0; i < BN / BOX; ++i) tma_store(&p.out, stg + 8192 * i, n0 + BOX * i, m_base, z);
    bulk_commit();
  }
}

template <int BN, int TA, int TB, int F32OUT, int PROMO>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_bf16_tma_kernel(const __grid_constant__ Params p, int tiles) {
  constexpr int S = stages<BN, F32OUT>(), SB = stage_bytes<BN>(), STG = staging_bytes<BN, F32OUT>();
  extern __shared__ char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  char* ring = smem;
  char* staging = ring + S * SB;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * STG);
  uint64_t* empty = full + S;
  uint64_t* resb = empty + S;  // the warpgroups' residual tiles
  uint32_t* bias_rows = reinterpret_cast<uint32_t*>(full + 256 / 8);  // [2][BN / 2]
  static_assert((2 * S + 2) * 8 <= 256 && 256 + 4 * BN <= TAIL, "the tail: barriers, bias rows");
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // each consuming warp arrives
    }
    mbar_init(resb, 1);
    mbar_init(resb + 1, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread issues the loads
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) produce<BN, TA, TB, F32OUT>(p, ring, full, empty, tiles);
  } else {
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31;
    const bool leader = (threadIdx.x & 127) == 0;
    char* stg = staging + wg * STG;
    uint64_t* rb = resb + wg;
    int st = 0, ph = 0, res_ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile T = tile_of<BN>(p, t);
      const int m_base = T.m0 + 64 * wg;
      if (!F32OUT && p.has_res && leader && m_base < p.M) load_res<BN>(p, stg, rb, m_base, T.n0);
      EpiIn in{};
      if constexpr (!F32OUT) load_epi<BN>(in, p, m_base, T.n0);
      const uint32_t a_off = 8192 * wg;
      float acc[BN / 2];
#pragma unroll
      for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
      int prev = 0;
      if constexpr (PROMO) {
        // the products of each stage (64 k) into part0 / part1 in turn, each
        // added to acc (one f32 add, round to nearest) once its group is
        // done, the next stage's group in flight meanwhile
        float part0[BN / 2], part1[BN / 2];
        for (int s = 0; s < T.stages; s += 2) {
          mbar_wait(full + st, ph);
          {
            const uint32_t sa = saddr(ring + st * SB) + a_off, sb = saddr(ring + st * SB) + BM * BKS * 2;
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BKS / 16; ++kk) mma_k<BN, TA, TB>(part0, sa, sb, kk, kk > 0);
            wg_commit();
          }
          wg_wait<1>();
          if (s > 0) {
            fence_acc(part1);
#pragma unroll
            for (int q = 0; q < BN / 2; ++q) acc[q] += part1[q];
            if (lane == 0) mbar_arrive(empty + prev);
          }
          prev = st;
          advance<S>(st, ph, 1);
          if (s + 1 < T.stages) {
            mbar_wait(full + st, ph);
            const uint32_t sa = saddr(ring + st * SB) + a_off, sb = saddr(ring + st * SB) + BM * BKS * 2;
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BKS / 16; ++kk) mma_k<BN, TA, TB>(part1, sa, sb, kk, kk > 0);
            wg_commit();
            wg_wait<1>();
            fence_acc(part0);
#pragma unroll
            for (int q = 0; q < BN / 2; ++q) acc[q] += part0[q];
            if (lane == 0) mbar_arrive(empty + prev);
            prev = st;
            advance<S>(st, ph, 1);
          }
        }
        wg_wait<0>();
        if (T.stages > 0) {
          fence_acc(part0);
          fence_acc(part1);
#pragma unroll
          for (int q = 0; q < BN / 2; ++q) acc[q] += T.stages & 1 ? part0[q] : part1[q];
          if (lane == 0) mbar_arrive(empty + prev);
        }
      } else {
        // one accumulator over the tile's K; the previous stage's group in
        // flight while this one's is issued, then its stage given back
        for (int s = 0; s < T.stages; ++s) {
          mbar_wait(full + st, ph);
          const uint32_t sa = saddr(ring + st * SB) + a_off, sb = saddr(ring + st * SB) + BM * BKS * 2;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < BKS / 16; ++kk) mma_k<BN, TA, TB>(acc, sa, sb, kk, 1);
          wg_commit();
          wg_wait<1>();
          if (s > 0 && lane == 0) mbar_arrive(empty + prev);
          prev = st;
          advance<S>(st, ph, 1);
        }
        wg_wait<0>();
        fence_acc(acc);
        if (T.stages > 0 && lane == 0) mbar_arrive(empty + prev);
      }
      store_block<BN, F32OUT>(p, acc, stg, bias_rows + wg * (BN / 2), in.bias, in.rr, rb,
                              res_ph, wg, m_base, T.n0, T.z);
    }
    if (leader) bulk_wait();  // the stores have left shared memory
  }
}

// a map of rank 2 ([rows, cols]) or 3 ([depth, rows, cols]) over p: cols
// contiguous, rows ld elements apart, the depth rows·ld apart; boxes of
// box_cols x box_rows (x 1), 128-byte swizzled, zero-filled past the edges
inline bool encode(CUtensorMap* m, const void* p, bool f32, int rank, long long cols,
                   long long rows, long long ld, int box_cols, int box_rows,
                   long long depth = 1) {
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * es, (cuuint64_t)ld * es * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return encode_tiled(m, p, f32, rank, dims, strides, box);
}

template <int BN, int TA, int TB, int F32OUT, int PROMO>
cudaError_t run(const vtx::TmaGemm& g, const vtx::Bf16Opts& o, cudaStream_t s) {
  static_assert(compiled<BN, TA, TB, F32OUT, PROMO>(), "a kernel the rule does not take");
  constexpr int SMEM = smem_bytes<BN, F32OUT>();
  static_assert(SMEM <= 227 * 1024, "a block's shared memory");
  auto kernel = gemm_bf16_tma_kernel<BN, TA, TB, F32OUT, PROMO>;
  Params p{};
  // A [M, K] (K-major: one box of 64 k x 128 rows) or its transpose's
  // storage [K, M] (MN-major: boxes of 64 rows x 64 k); B [N, K]
  // (K-major, BN rows) or [K, N] (MN-major, 64 columns a box); out
  // [splits, M, N] (32 f32 or 64 bf16 columns x 64 rows a box); res [M, N]
  const bool ok =
      (TA ? encode(&p.a, g.a, false, 2, g.M, g.K, g.lda, 64, 64)
          : encode(&p.a, g.a, false, 2, g.K, g.M, g.lda, 64, BM)) &&
      (TB ? encode(&p.b, g.b, false, 2, g.N, g.K, g.ldb, 64, 64)
          : encode(&p.b, g.b, false, 2, g.K, g.N, g.ldb, 64, BN)) &&
      encode(&p.out, g.out, F32OUT, 3, g.N, g.M, g.N, F32OUT ? 32 : 64, 64, g.splits) &&
      (!g.res || encode(&p.res, g.res, false, 2, g.N, g.M, g.N, 64, 64));
  if (!ok) return cudaErrorInvalidValue;  // raised by the caller: no other path is taken
  p.bias = g.bias;
  p.rs = g.rs;
  p.rs_rows = g.rs_rows;
  p.M = g.M;
  p.N = g.N;
  p.K = g.K;
  p.k_chunk = g.k_chunk;
  p.silu = g.silu;
  p.has_res = g.res != nullptr;
  static bool sized = false;  // the attribute once per instantiation
  if (!sized) {
    VTX_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
    sized = true;
  }
  int dev, sms;  // persistent blocks: one an SM
  VTX_CHECK(cudaGetDevice(&dev));
  VTX_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const long long tiles = (long long)cdiv(g.N, BN) * cdiv(g.M, BM) * g.splits;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (o.plan) {
    o.plan[0] = 1;
    o.plan[1] = BN;
    o.plan[2] = PROMO ? 1 : 2;
    o.plan[3] = stages<BN, F32OUT>();
  }
  kernel<<<(int)(tiles < sms ? tiles : sms), THREADS, SMEM, s>>>(p, (int)tiles);
  return cudaGetLastError();
}

}  // namespace gtma
}  // namespace

// The launch of one operand layout and output type (TA: A as Aᵀ storage;
// TB: B MN-major; F32OUT: f32 out), by the rule: the forward's products
// (bf16 out, K-major operands) on 192 columns where they pad N no more than
// 128-column tiles, every other call on 128 columns, or 64 where 64-column
// tiles pad N less (phase 3bf's A/B, PERF.md); one accumulator over K, or
// with the thin door's promote = 1 the sums promoted every 64 k (phase
// 3bf's promotion check: f32 out, K-major operands, 64 columns).  Each
// gemm_bf16_*.cu compiles its own layouts.
template <int TA, int TB, int F32OUT>
cudaError_t vtx::gemm_bf16_tma(const TmaGemm& g, const Bf16Opts& o, cudaStream_t s) {
  using namespace gtma;
  if (o.promote < 0 || o.promote > 2) return cudaErrorInvalidValue;
  if (o.promote == 1) {
    if constexpr (compiled<64, TA, TB, F32OUT, 1>())
      return run<64, TA, TB, F32OUT, 1>(g, o, s);
    else
      return cudaErrorInvalidValue;  // the promoted kernel takes only the check's layout
  }
  if constexpr (!TA && !TB && !F32OUT) {
    if (cdiv(g.N, 192) * 192 <= cdiv(g.N, 128) * 128) return run<192, TA, TB, F32OUT, 0>(g, o, s);
  }
  return cdiv(g.N, 64) * 64 < cdiv(g.N, 128) * 128 ? run<64, TA, TB, F32OUT, 0>(g, o, s)
                                                    : run<128, TA, TB, F32OUT, 0>(g, o, s);
}
