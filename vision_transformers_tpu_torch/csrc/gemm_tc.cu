// The port's GEMM core on Hopper's tensor cores (sm_90a), f32-accurate in
// 3xTF32 on wgmma, behind the three launchers that common.cuh declares:
//
//   launch_gemm          out[M, N] = epilogue(A·B), A row-major [M, K]
//   launch_gemm_map<MAP> the same, B9's residual row read (MAP_RES) or output
//                        row written (MAP_OUT) at map_pixel(rows_map, m)
//   launch_gemm_splitk   A as Aᵀ storage (element (m, k) at A[m + k·lda]),
//                        `splits` K-slabs written to part [splits, M, N] and
//                        summed in slab order (splitk_reduce_kernel)
//
// B element (k, n) at B[k·sbk + n·sbn] in every form, so the models' weight
// views (Linear.weight.t()) and their transposes are read in place.  The
// epilogue: + bias[n] → silu (act_fwd's expression, so the saved activation
// and the epilogue's stay bit-identical) → × rs[m / rs_rows] → + res[m, n],
// each optional.  No float atomics anywhere: every result, the split-K
// weight gradients included, is bit-identical from run to run.
//
// Replaces, for the TPU kernels, the projections that the Pallas bodies
// compute on the MXU inside
//   vision_transformers_tpu/ops/fused_layer.py:116 / :183   B1 fwd / bwd
//   vision_transformers_tpu/ops/fused_layer1.py:91 / :181   B2 fwd / bwd
//   vision_transformers_tpu/ops/fused_block.py:57 / :100    B8 fwd / bwd
//   vision_transformers_tpu/ops/fused_swin.py:99 / :200     B9 fwd / bwd
//   vision_transformers_tpu/ops/fused_halo_layer.py:92 / :179  B4 fwd / bwd
// and B7's two FF products (fused_layer.py:701 / :743), which run the same
// launch sequences.
//
// Precision.  Every product is lo·hi + hi·lo + hi·hi of TF32 halves, the
// small terms first (mma_tf32.cuh's scheme): each operand is split as hi =
// cvt.rna(x), lo = cvt.rna(x − hi) ONCE, as its tile is staged into shared
// memory, where every warp of the block reads it.  The tensor cores' own
// f32 accumulation truncates: with one accumulator over K its error grew in
// proportion to K on the H100 and missed the 1e-4 limit at K = 3072 (Swin-S
// stage 4's FF2; PERF.md).  So the wgmmas of PROMOTE slabs (64 k)
// accumulate into part, and part is then added to the sums acc with one f32
// add (round to nearest): within the limit at every K the paths give, at
// ~5% of it (tests/test_torch_port_gemm_tf32x3.py emulates both).
//
// Tiles and the ring.  Output tiles are 128 x BN (BN 128, or 64 where
// 64-column tiles pad N less); one persistent block an SM walks them (tile
// blockIdx.x, + gridDim.x, ..., n fastest) with three warpgroups.  The
// producer loads each 16-deep slab of A [128 x 16] and B [BN x 16] into
// registers one slab ahead, splits it into A_hi, A_lo, B_hi, B_lo and
// stores those K-major into a ring of six stages (192 KB at BN 128); the
// ring runs on across tiles, so the next tile's stages fill while the
// consumers finish a tile and write it out.  The two
// consumer warpgroups (rows 64·w .. 64·w + 63, BN / 2 sums and BN / 2 slab
// products a thread) issue a slab's six wgmma.mma_async.m64nBNk8.tf32 (two
// k steps x three passes) as soon as its stage is full and give a stage back
// once its wgmmas are done, so the tensor cores never wait for the staging.
// Full and empty are named barriers (bar.arrive / bar.sync over all 384
// threads), one pair a stage.  On the H100 the simpler layouts it was
// measured against (all threads staging between barriers, one or two blocks
// an SM, 32-deep slabs, 64-byte swizzled tiles) ran within a few percent of
// it before the persistent walk; the loop without the promotion, two blocks
// an SM, ran ~25% faster (PERF.md): the promoted sums cost the
// registers of the second block.
//
// Operand layouts.  wgmma's tf32 form takes only K-major operands (the
// transpose bits exist for f16 / bf16 alone), so staging writes every tile
// K-major, whatever its layout in device memory: the no-swizzle canonical
// layout of 8-row x 16-byte core matrices, element (r, k) of an R-row tile at
// float 4·((k / 4)·R + r) (a core matrix's 8 rows contiguous, the next 8 rows
// 128 bytes on, the next 4 k R·16 bytes on: the descriptor's stride and
// leading byte offsets).  A K-contiguous operand (the forward's activations
// and weight views) is loaded 16 bytes at a time, a warp covering 8 rows x
// 16 k, and a thread writes each 16-byte row of a core matrix whole, eight
// lanes one core matrix: no bank conflicts.  An M- or N-contiguous one (the
// data gradients' weights, both operands of the split-K weight gradients)
// is loaded 16 bytes at a time along its rows, coalesced (four rows x four
// k a thread, the lanes along the rows), and transposed in registers on
// the way into shared memory; where its rows or strides are not multiples
// of 4, or its tile has 64 rows, by 4-byte loads.  Ragged M, N and K are
// zero-filled.
//
// What bounds it on this card.  The port's projections are 2·M·N·K
// operations against 4·(M·K + K·N + M·N) bytes: at every path's shape (K, N
// ≥ 96, M ≥ 3,136) the f32-accurate tensor-core rate bounds them (495 / 3 =
// 165 TFLOP/s at 700 W, against 3.35 TB/s for the bytes).  What the design
// does about it: the products run on wgmma at the tensor cores' TF32 rate
// (the FMA GEMM it replaces ran at ~22 TFLOP/s, a third of the 67 TFLOP/s
// f32 peak), each operand is split once, and a producer keeps the ring
// full.  It reaches about a quarter of the bound, near torch.matmul's f32
// rate (PERF.md).  The staging does not hold it there (a producer six
// stages ahead did not move it); the likeliest limit is the wgmma stream of
// two warpgroups an SM, which more accumulator chains an SM (fewer
// registers a chain, e.g. bf16 operands) would lift.

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {
namespace gtc {

// two consumer warpgroups (the products), one producer warpgroup (the
// loads, the split, the staging)
constexpr int CONSUMERS = 256, PRODUCERS = 128, THREADS = CONSUMERS + PRODUCERS;
// 128-row tiles, 16-deep slabs in a ring of six stages, the products of four
// slabs (64 k) promoted at a time
constexpr int BM = 128, BK = 16, STAGES = 6, PROMOTE = 4;
static_assert(2 * STAGES < 16, "named barriers 1 .. 2·STAGES");

// An operand tile source: element (r, k) of rows r < rows at
// p[r·s_row + k·s_k].  kmajor: s_k = 1; vec: 16-byte loads along k (kmajor,
// s_row and every k slab boundary a multiple of 4, p 16-byte aligned);
// tvec: 16-byte loads along the rows, transposed in registers (s_row = 1,
// s_k and rows multiples of 4, p 16-byte aligned: the weight gradients'
// operands, the data gradients' weights), in 128-row tiles.
struct Operand {
  const float* p;
  long long s_row, s_k;
  int rows;
  bool kmajor, vec, tvec;
};

struct Args {
  Operand a, b;
  const float* bias;
  const float* rs;
  int rs_rows;
  const float* res;
  float* out;
  int M, N, K, k_chunk, silu;
  MapRows rows_map;
};

// a producer thread's units (4 k of one row) of an R-row x BK tile
template <int R>
__host__ __device__ constexpr int units() {
  return R * BK / (4 * PRODUCERS);
}

// (row, 4-k chunk) of producer thread pt's unit i of an R-row tile: a warp
// takes 8 rows x 4 chunks (K-contiguous source) or 32 rows x 1 chunk
// (otherwise)
template <int R>
__device__ __forceinline__ void unit(bool kmajor, int pt, int i, int& r, int& c) {
  const int lane = pt & 31;
  const int blk = (pt >> 5) + i * (PRODUCERS / 32);  // 0 .. R·BK / 128 − 1
  if (kmajor) {
    r = 8 * (blk % (R / 8)) + (lane & 7);
    c = 4 * (blk / (R / 8)) + (lane >> 3);
  } else {
    r = 32 * (blk % (R / 32)) + lane;
    c = blk / (R / 32);
  }
}

// rows [r0, r0 + R) x k [k0, k0 + BK) of o into v, zero past o.rows and
// past k_end
template <int R>
__device__ __forceinline__ void load_tile(float4 (&v)[units<R>()], const Operand& o, int pt,
                                          int r0, int k0, int k_end) {
  if constexpr (R == 128 && units<R>() == 4) {
    if (o.tvec) {  // rows 4·lane .. + 3 at k 4·warp + i, one 16-byte load each
      const int gr = r0 + 4 * (pt & 31), gk = k0 + 4 * (pt >> 5);
      const float* src = o.p + gr + (long long)gk * o.s_k;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = gr < o.rows && gk + i < k_end
                   ? __ldg(reinterpret_cast<const float4*>(src + i * o.s_k))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < units<R>(); ++i) {
    int r, c;
    unit<R>(o.kmajor, pt, i, r, c);
    const int gr = r0 + r, gk = k0 + 4 * c;
    const float* src = o.p + (long long)gr * o.s_row + (long long)gk * o.s_k;
    if (o.vec) {
      v[i] = gr < o.rows && gk < k_end ? __ldg(reinterpret_cast<const float4*>(src))
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const bool ok = gr < o.rows;
      v[i].x = ok && gk < k_end ? __ldg(src) : 0.f;
      v[i].y = ok && gk + 1 < k_end ? __ldg(src + o.s_k) : 0.f;
      v[i].z = ok && gk + 2 < k_end ? __ldg(src + 2 * o.s_k) : 0.f;
      v[i].w = ok && gk + 3 < k_end ? __ldg(src + 3 * o.s_k) : 0.f;
    }
  }
}


__device__ __forceinline__ float4 halves(float4 x, float4& lo) {
  uint32_t h[4], l[4];
  tc::split(x.x, h[0], l[0]);
  tc::split(x.y, h[1], l[1]);
  tc::split(x.z, h[2], l[2]);
  tc::split(x.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                     __uint_as_float(h[3]));
}

// v split into the K-major tiles Hi / Lo (R rows x BK)
template <int R>
__device__ __forceinline__ void store_tile(float* Hi, float* Lo,
                                           const float4 (&v)[units<R>()], const Operand& o,
                                           int pt) {
  if constexpr (R == 128 && units<R>() == 4) {
    if (o.tvec) {  // v transposed: row 4·lane + i's 4 k of chunk warp
      const float4 rows[4] = {make_float4(v[0].x, v[1].x, v[2].x, v[3].x),
                              make_float4(v[0].y, v[1].y, v[2].y, v[3].y),
                              make_float4(v[0].z, v[1].z, v[2].z, v[3].z),
                              make_float4(v[0].w, v[1].w, v[2].w, v[3].w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = 4 * ((pt >> 5) * R + 4 * (pt & 31) + i);
        float4 lo;
        *reinterpret_cast<float4*>(Hi + off) = halves(rows[i], lo);
        *reinterpret_cast<float4*>(Lo + off) = lo;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < units<R>(); ++i) {
    int r, c;
    unit<R>(o.kmajor, pt, i, r, c);
    const int off = 4 * (c * R + r);
    float4 lo;
    *reinterpret_cast<float4*>(Hi + off) = halves(v[i], lo);
    *reinterpret_cast<float4*>(Lo + off) = lo;
  }
}

// wgmma descriptor of a K-major no-swizzle tile of R rows at p: leading byte
// offset (the next 4 k) R·16, stride byte offset (the next 8 rows) 128
template <int R>
__device__ __forceinline__ uint64_t desc(const float* p) {
  const uint64_t addr = tc::smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((R * 16) >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N of this warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// the shared-memory stores above, made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d[0, 32) = A·B + (scale_d ? d : 0) over k 8, m64n64k8, A and B K-major
// in shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// d[0, 64) = A·B + (scale_d ? d : 0) over k 8, m64n128k8, A and B K-major
// in shared memory
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                      int scale_d = 1) {
  if constexpr (BN == 128)
    wgmma_n128(d, da, db, scale_d);
  else
    wgmma_n64(d, da, db, scale_d);
}

// keeps the compiler from moving accumulator reads or writes across the
// wgmma fences and waits
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN>
__host__ __device__ constexpr int stage_floats() {
  return 2 * (BM + BN) * BK;  // A_hi, A_lo, B_hi, B_lo
}

template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_floats<BN>() * (int)sizeof(float);
}

// one slab's operands in registers, between its loads and its staging
template <int BN>
struct Slab {
  float4 a[units<BM>()], b[units<BN>()];
};

template <int BN>
__device__ __forceinline__ void load_slab(Slab<BN>& r, const Args& a, int pt, int m0,
                                          int n0, int k0, int k_end) {
  load_tile<BM>(r.a, a.a, pt, m0, k0, k_end);
  load_tile<BN>(r.b, a.b, pt, n0, k0, k_end);
}

// split into stage st: A_hi, A_lo, B_hi, B_lo
template <int BN>
__device__ __forceinline__ void store_slab(float* st, const Slab<BN>& r, const Args& a,
                                           int pt) {
  constexpr int AT = BM * BK, BT = BN * BK;
  store_tile<BM>(st, st + AT, r.a, a.a, pt);
  store_tile<BN>(st + 2 * AT, st + 2 * AT + BT, r.b, a.b, pt);
}

// the ring's named barriers (0 is __syncthreads'): stage s full (the
// producer arrives, the consumers wait) and empty (the reverse), each
// counting all THREADS
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + STAGES + s; }
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}

// the wgmmas of the slab in stage st (BK / 8 k steps x three passes, the
// small terms first) into part, the first zeroing it where zero, committed
// as one group
template <int BN>
__device__ __forceinline__ void mma_slab(float (&part)[BN / 2], const float* st, int wg,
                                         bool zero) {
  constexpr int AT = BM * BK, BT = BN * BK;
  // this warpgroup's 64 rows of A: 8 core-matrix rows of 128 bytes on
  const float* a_hi = st + 256 * wg;
  const float* a_lo = a_hi + AT;
  const float* b_hi = st + 2 * AT;
  const float* b_lo = b_hi + BT;
  wg_fence();
#pragma unroll
  for (int s = 0; s < BK / 8; ++s) {  // k 8·s .. 8·s + 7: chunks 2s, 2s + 1
    const uint64_t ah = desc<BM>(a_hi + 8 * s * BM), al = desc<BM>(a_lo + 8 * s * BM);
    const uint64_t bh = desc<BN>(b_hi + 8 * s * BN), bl = desc<BN>(b_lo + 8 * s * BN);
    wgmma<BN>(part, al, bh, !zero || s > 0);
    wgmma<BN>(part, ah, bl);
    wgmma<BN>(part, ah, bh);
  }
  wg_commit();
}

// one output tile: rows m0 .., columns n0 .., split-K slab z (its k range
// [k_begin, k_end) in slabs of BK)
struct Tile {
  int m0, n0, z, k_begin, k_end, slabs;
};

// producer: slab it of tile T (in cur), the block's slab j, into its stage
// once the consumers have left it (slab j − STAGES's), slab it + 1 loaded
// into nxt first so that its loads are in flight meanwhile
template <int BN>
__device__ __forceinline__ void produce(Slab<BN>& cur, Slab<BN>& nxt, float* smem,
                                        const Args& a, int pt, const Tile& T, int it, int j) {
  if (it + 1 < T.slabs)
    load_slab(nxt, a, pt, T.m0, T.n0, T.k_begin + (it + 1) * BK, T.k_end);
  const int st = j % STAGES;
  if (j >= STAGES) bar_sync(empty_bar(st));
  store_slab(smem + st * stage_floats<BN>(), cur, a, pt);
  fence_proxy_async();
  bar_arrive(full_bar(st));
}

// tile t of the cdiv(N, BN) x cdiv(M, BM) x splits tiles, n fastest (the
// blocks at work at a time share A's rows)
template <int BN, bool SPLIT_K>
__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  const int tn = (a.N + BN - 1) / BN, tm = (a.M + BM - 1) / BM;
  Tile T;
  T.n0 = t % tn * BN;
  T.m0 = t / tn % tm * BM;
  T.z = t / (tn * tm);
  T.k_begin = SPLIT_K ? T.z * a.k_chunk : 0;
  T.k_end = SPLIT_K ? min(a.K, T.k_begin + a.k_chunk) : a.K;
  T.slabs = T.k_end > T.k_begin ? (T.k_end - T.k_begin + BK - 1) / BK : 0;
  return T;
}

// the epilogue of tile T from the consumers' sums: d[4j + 2h + e] at row
// 16·warp + lane / 4 + 8h, column 8j + 2·(lane % 4) + e of warpgroup wg's
// 64 x BN
template <int BN, bool SPLIT_K, int MAP>
__device__ __forceinline__ void epilogue(const Args& a, const Tile& T, int wg,
                                         const float (&acc)[BN / 2]) {
  const int lane = threadIdx.x & 31;
  const int row0 = T.m0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int col0 = T.n0 + 2 * (lane & 3);
  const int M = a.M, N = a.N;
  float* out = a.out + (SPLIT_K ? (long long)T.z * M * N : 0LL);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m >= M) continue;
    const long long row_off = (long long)m * N;
    // the map row, once per output row (MAP_NONE: unused, compiled out)
    const long long map_off = MAP == MAP_NONE ? 0 : map_pixel(a.rows_map, m) * N;
    const float r = !SPLIT_K && a.rs ? a.rs[m / a.rs_rows] : 1.f;
    float* orow = out + (MAP == MAP_OUT ? map_off : row_off);
    const float* rrow = a.res ? a.res + (MAP == MAP_RES ? map_off : row_off) : nullptr;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = col0 + 8 * j;  // even: this thread's columns n, n + 1
      if (n >= N) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = acc[4 * j + 2 * h + e];
        if (!SPLIT_K && n + e < N) {
          if (a.bias) v[e] += a.bias[n + e];
          if (a.silu) v[e] = act_fwd<ACT_SILU>(v[e]);
          if (a.rs) v[e] *= r;
          if (rrow) v[e] += rrow[n + e];
        }
      }
      if (N % 2 == 0) {  // every row, and so the pair, 8-byte aligned
        *reinterpret_cast<float2*>(orow + n) = make_float2(v[0], v[1]);
      } else {
        orow[n] = v[0];
        if (n + 1 < N) orow[n + 1] = v[1];
      }
    }
  }
}

// A persistent block (one an SM) takes tiles blockIdx.x, + gridDim.x, ...;
// its slabs run through the ring in one sequence, g counting them, so the
// producer fills the next tile's stages while the consumers finish a tile
// and write it out.
template <int BN, bool SPLIT_K, int MAP>
__global__ void __launch_bounds__(THREADS, 1) gemm_tc_kernel(const Args a, int tiles) {
  extern __shared__ __align__(128) float smem[];
  const int wg = threadIdx.x >> 7;
  int total = 0;  // the block's slabs
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) total += tile_of<BN, SPLIT_K>(a, t).slabs;

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    const int pt = threadIdx.x - CONSUMERS;
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile T = tile_of<BN, SPLIT_K>(a, t);
      Slab<BN> r0, r1;  // two slabs, so that each register set is named statically
      if (T.slabs > 0) load_slab(r0, a, pt, T.m0, T.n0, T.k_begin, T.k_end);
      for (int it = 0; it < T.slabs; it += 2) {
        produce<BN>(r0, r1, smem, a, pt, T, it, g + it);
        if (it + 1 < T.slabs) produce<BN>(r1, r0, smem, a, pt, T, it + 1, g + it + 1);
      }
      g += T.slabs;
    }
    return;
  }

  int g = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile T = tile_of<BN, SPLIT_K>(a, t);
    // acc: the promoted sums, one f32 add (round to nearest) every PROMOTE
    // slabs, since the tensor cores' own accumulation truncates and its
    // error grows with K; part: those slabs' products, which only their
    // wgmmas define (the first zeroes it; any other instruction on it would
    // serialize them)
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // slab it's wgmmas issued once its stage is full; then the previous
    // slab's done (or, at the end of a promotion group, all, and part added
    // to acc), and its stage given back to the producer where it waits
    for (int it = 0; it < T.slabs; ++it) {
      const int j = g + it, st = j % STAGES;
      bar_sync(full_bar(st));
      mma_slab<BN>(part, smem + st * stage_floats<BN>(), wg, it % PROMOTE == 0);
      if ((it + 1) % PROMOTE == 0 || it + 1 == T.slabs) {
        wg_wait<0>();
        fence_acc(part);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      } else {
        wg_wait<1>();
      }
      if (j >= 1 && j - 1 + STAGES < total) bar_arrive(empty_bar((j - 1) % STAGES));
    }
    epilogue<BN, SPLIT_K, MAP>(a, T, wg, acc);
    g += T.slabs;
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// element (r, k) at p[r·s_row + k·s_k]; 16-byte loads where every slab
// boundary (a multiple of BK, or K) is a multiple of 4
inline Operand operand(const float* p, long long s_row, long long s_k, int rows, int K) {
  const bool kmajor = s_k == 1;
  return Operand{p, s_row, s_k, rows, kmajor,
                 kmajor && s_row % 4 == 0 && K % 4 == 0 && aligned16(p),
                 !kmajor && s_row == 1 && s_k % 4 == 0 && rows % 4 == 0 && aligned16(p)};
}

template <int BN, bool SPLIT_K, int MAP>
cudaError_t launch_t(const Args& a, int splits, cudaStream_t s) {
  static_assert(smem_bytes<BN>() <= 227 * 1024, "a block's shared memory");
  static bool sized = false;  // the attribute once per instantiation
  if (!sized) {
    VTX_CHECK(cudaFuncSetAttribute(gemm_tc_kernel<BN, SPLIT_K, MAP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes<BN>()));
    sized = true;
  }
  int dev, sms;  // persistent blocks: one an SM
  VTX_CHECK(cudaGetDevice(&dev));
  VTX_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const long long tiles = (long long)cdiv(a.N, BN) * cdiv(a.M, BM) * splits;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = (int)(tiles < sms ? tiles : sms);
  gemm_tc_kernel<BN, SPLIT_K, MAP><<<blocks, THREADS, smem_bytes<BN>(), s>>>(a, (int)tiles);
  return cudaGetLastError();
}

template <bool SPLIT_K, int MAP>
cudaError_t launch(const Args& a, int splits, cudaStream_t s) {
  if (a.M < 1 || a.N < 1 || a.K < 0 || splits < 1) return cudaErrorInvalidValue;
  // 128-column tiles unless 64-column ones pad N less
  const bool narrow = cdiv(a.N, 64) * 64 < cdiv(a.N, 128) * 128;
  return narrow ? launch_t<64, SPLIT_K, MAP>(a, splits, s)
                : launch_t<128, SPLIT_K, MAP>(a, splits, s);
}

template <int MAP>
cudaError_t launch_rows(const float* A, const float* B, long long sbk, long long sbn,
                        const float* bias, const float* rs, int rs_rows, const float* res,
                        float* out, int M, int N, int K, int silu, MapRows rows_map,
                        cudaStream_t stream) {
  Args a{};
  a.a = operand(A, K, 1, M, K);
  a.b = operand(B, sbn, sbk, N, K);
  a.bias = bias;
  a.rs = rs;
  a.rs_rows = rs_rows;
  a.res = res;
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.k_chunk = K;
  a.silu = silu;
  a.rows_map = rows_map;
  return launch<false, MAP>(a, 1, stream);
}

}  // namespace gtc
}  // namespace

cudaError_t vtx::launch_gemm(const float* A, const float* B, long long sbk, long long sbn,
                             const float* bias, const float* rs, int rs_rows,
                             const float* res, float* out, int M, int N, int K, int silu,
                             cudaStream_t stream) {
  return gtc::launch_rows<MAP_NONE>(A, B, sbk, sbn, bias, rs, rs_rows, res, out, M, N, K,
                                    silu, MapRows{nullptr, 1}, stream);
}

template <int MAP>
cudaError_t vtx::launch_gemm_map(const float* A, const float* B, long long sbk,
                                 long long sbn, const float* bias, const float* rs,
                                 int rs_rows, const float* res, float* out, int M, int N,
                                 int K, int silu, MapRows rows_map, cudaStream_t stream) {
  return gtc::launch_rows<MAP>(A, B, sbk, sbn, bias, rs, rs_rows, res, out, M, N, K, silu,
                               rows_map, stream);
}

template cudaError_t vtx::launch_gemm_map<vtx::MAP_RES>(
    const float*, const float*, long long, long long, const float*, const float*, int,
    const float*, float*, int, int, int, int, MapRows, cudaStream_t);
template cudaError_t vtx::launch_gemm_map<vtx::MAP_OUT>(
    const float*, const float*, long long, long long, const float*, const float*, int,
    const float*, float*, int, int, int, int, MapRows, cudaStream_t);

cudaError_t vtx::launch_gemm_splitk(const float* A, int lda, const float* B, long long sbk,
                                    long long sbn, float* part, int splits, float* out,
                                    long long som, long long son, int M, int N, int K,
                                    cudaStream_t stream) {
  if (splits < 1) return cudaErrorInvalidValue;
  gtc::Args a{};
  a.a = gtc::operand(A, 1, lda, M, K);
  a.b = gtc::operand(B, sbn, sbk, N, K);
  a.rs_rows = 1;
  a.out = part;
  a.M = M;
  a.N = N;
  a.K = K;
  // slabs of whole k steps: every slab boundary but K a multiple of BK
  a.k_chunk = cdiv(cdiv(K, splits), gtc::BK) * gtc::BK;
  a.rows_map = MapRows{nullptr, 1};
  VTX_CHECK((gtc::launch<true, MAP_NONE>(a, splits, stream)));
  return launch_splitk_reduce(part, splits, M, N, out, som, son, stream);
}

// The GEMM core alone, for its checks and timings (chip_smoke.py phase 3m):
// form 0 launch_gemm, 1 launch_gemm_map<MAP_RES>, 2 launch_gemm_map<MAP_OUT>
// (pix [map_hw] the row → pixel table), 3 launch_gemm_splitk (A as Aᵀ
// storage with leading dimension lda, part [splits, M, N] workspace, out
// through (som, son)).  Returns the first cudaError_t met (0 = success).
extern "C" int vtx_gemm_tc(const float* A, int lda, const float* B, long long sbk,
                           long long sbn, const float* bias, const float* rs, int rs_rows,
                           const float* res, float* out, const int* pix, int map_hw,
                           int form, float* part, int splits, long long som, long long son,
                           int M, int N, int K, int silu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MapRows rows_map{pix, map_hw};
  switch (form) {
    case 0:
      return static_cast<int>(
          launch_gemm(A, B, sbk, sbn, bias, rs, rs_rows, res, out, M, N, K, silu, s));
    case 1:
      if (!pix || map_hw < 1) break;
      return static_cast<int>(launch_gemm_map<MAP_RES>(A, B, sbk, sbn, bias, rs, rs_rows,
                                                       res, out, M, N, K, silu, rows_map, s));
    case 2:
      if (!pix || map_hw < 1) break;
      return static_cast<int>(launch_gemm_map<MAP_OUT>(A, B, sbk, sbn, bias, rs, rs_rows,
                                                       res, out, M, N, K, silu, rows_map, s));
    case 3:
      return static_cast<int>(launch_gemm_splitk(A, lda, B, sbk, sbn, part, splits, out,
                                                 som, son, M, N, K, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
