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
// What passes it takes in (GemmExtra, common.cuh), so that the layers'
// [M, C] and [M, F] intermediates are not written and read back:
//   the producer  transforms an operand in registers after its load and
//                 before the TF32 split (each operand is still split once):
//                 on A the LayerNorm apply from saved statistics (the
//                 expression of ln_rows_kernel, so every staged value is
//                 the one the LN pass wrote) or act_fwd; on B a row scale
//                 rs[k / rows].  Both layouts (vec and tvec) take them; in
//                 the split-K form the token is the k index.
//   the epilogue  (row forms) with a same-shaped tile hid: the partials of
//                 Σ v·act_fwd(hid) per row and 64-column group (rpart), then
//                 v ×= rs, v ×= act_grad(hid) (the FF backward's dh); and the
//                 column sums of the final value per 16-row slice (cpart, the
//                 bias gradients), summed in a fixed order: a thread's two
//                 rows, then the lanes by a shuffle tree.  The caller sums
//                 the partials with the ordered reduces.
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
// The bf16 form (launch_gemm_bf16, launch_gemm_splitk_bf16: B1's and B2's
// projections at the JAX package's default precision).  The same tile
// scheduler, ring, barriers and promotion, with the element type a template
// argument (E, common.cuh): operands bf16 in device memory, 8-row x
// 16-byte core matrices, no TF32 split, one wgmma.m64nBNk16.f32.bf16 a
// 16-deep slab where f32 takes six, into f32 sums promoted every 64 k as in
// the f32 form.  Where both operands are 16-byte chunks along K (the
// forward's activations and weight views; the data gradients' weights as
// contiguous copies) or both along their rows (the split-K weight
// gradients' Aᵀ and dY), the producer is a copy: 16-byte cp.async global →
// shared, four slabs (64 k) a stage, CP_LAG stages in flight, the MN-major
// tiles read by wgmma through its transpose bits (produce_copies).  Any
// other bf16 operand (a shape off 8-element chunks) takes the f32 form's
// register path, loaded four elements a unit and stored as they were; the
// bf16 form takes none of the producer's transforms.  The row
// epilogue follows the JAX kernels' rounding points in registers:
// round(acc), + bias rounded, silu rounded, × round(rs) rounded, + res
// rounded (or, out_f32, the raw sums: the backward's dln and dacc₀); the
// split-K form writes f32 partials and their ordered f32 sum.
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
// What a kernel takes in of the passes (GemmExtra): nothing; one of the
// producer's transforms (A's LayerNorm; act on A, with B's row scale where
// set; B's row scale); or the epilogue's options.  A separate instantiation
// each, the activation a template parameter, so that every kernel carries
// only its own code and registers (one with every option and both
// activations inlined at each element was 2-4x the size and ran 2-4x
// slower)
constexpr int XF_NONE = 0, XF_LN = 1, XF_ACT = 2, XF_SCALE = 3, XF_EPILOGUE = 4;

// p points at elements of the kernel's type E (f32 or bf16); cp (bf16):
// K-contiguous in 16-byte chunks of 8 k (s_row and K multiples of 8, p
// 16-byte aligned), cpt (bf16): row-contiguous in 16-byte chunks of 8 rows
// (s_k and rows multiples of 8, p 16-byte aligned), so the producer copies
// it straight into the stage, K-major or MN-major
struct Operand {
  const void* p;
  long long s_row, s_k;
  int rows;
  bool kmajor, vec, tvec, cp, cpt;
};

// bias, res and out in the kernel's element type (out f32 in the split-K
// form and where out_f32 is set)
struct Args {
  Operand a, b;
  GemmExtra x;
  const void* bias;
  const float* rs;
  int rs_rows;
  const void* res;
  void* out;
  int M, N, K, k_chunk, silu, out_f32;
  MapRows rows_map;
};

// four consecutive elements at p[i] as f32 (16 bytes of f32, 8 of bf16,
// aligned), and one
template <int E>
__device__ __forceinline__ float4 ld4(const void* p, long long i) {
  if constexpr (E == F32) {
    return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + i));
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const bf16*>(p) + i));
    return make_float4(lo_f32(u.x), hi_f32(u.x), lo_f32(u.y), hi_f32(u.y));
  }
}

template <int E>
__device__ __forceinline__ float ld1(const void* p, long long i) {
  if constexpr (E == F32)
    return __ldg(static_cast<const float*>(p) + i);
  else
    return __bfloat162float(static_cast<const bf16*>(p)[i]);
}


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
template <int R, int E>
__device__ __forceinline__ void load_tile(float4 (&v)[units<R>()], const Operand& o, int pt,
                                          int r0, int k0, int k_end) {
  if constexpr (R == 128 && units<R>() == 4) {
    if (o.tvec) {  // rows 4·lane .. + 3 at k 4·warp + i, one 16-byte (8-byte) load each
      const int gr = r0 + 4 * (pt & 31), gk = k0 + 4 * (pt >> 5);
      const long long src = gr + (long long)gk * o.s_k;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = gr < o.rows && gk + i < k_end ? ld4<E>(o.p, src + i * o.s_k)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < units<R>(); ++i) {
    int r, c;
    unit<R>(o.kmajor, pt, i, r, c);
    const int gr = r0 + r, gk = k0 + 4 * c;
    const long long src = (long long)gr * o.s_row + (long long)gk * o.s_k;
    if (o.vec) {
      v[i] = gr < o.rows && gk < k_end ? ld4<E>(o.p, src) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const bool ok = gr < o.rows;
      v[i].x = ok && gk < k_end ? ld1<E>(o.p, src) : 0.f;
      v[i].y = ok && gk + 1 < k_end ? ld1<E>(o.p, src + o.s_k) : 0.f;
      v[i].z = ok && gk + 2 < k_end ? ld1<E>(o.p, src + 2 * o.s_k) : 0.f;
      v[i].w = ok && gk + 3 < k_end ? ld1<E>(o.p, src + 3 * o.s_k) : 0.f;
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

// the unit (row r, k 4·c .. 4·c + 3) of an R-row K-major tile at st: f32
// split into the tiles Hi (st) / Lo (st + R·BK floats), float 4·(c·R + r);
// bf16 rounded, element 8·((c / 2)·R + r) + 4·(c mod 2)
template <int R, int E>
__device__ __forceinline__ void store_unit(char* st, int r, int c, float4 x) {
  if constexpr (E == F32) {
    float* Hi = reinterpret_cast<float*>(st);
    const int off = 4 * (c * R + r);
    float4 lo;
    *reinterpret_cast<float4*>(Hi + off) = halves(x, lo);
    *reinterpret_cast<float4*>(Hi + R * BK + off) = lo;
  } else {
    bf16* T = reinterpret_cast<bf16*>(st);
    *reinterpret_cast<uint2*>(T + 8 * ((c >> 1) * R + r) + 4 * (c & 1)) =
        make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
}

// v into the K-major tile(s) at st (R rows x BK)
template <int R, int E>
__device__ __forceinline__ void store_tile(char* st, const float4 (&v)[units<R>()],
                                           const Operand& o, int pt) {
  if constexpr (R == 128 && units<R>() == 4) {
    if (o.tvec) {  // v transposed: row 4·lane + i's 4 k of chunk warp
      const float4 rows[4] = {make_float4(v[0].x, v[1].x, v[2].x, v[3].x),
                              make_float4(v[0].y, v[1].y, v[2].y, v[3].y),
                              make_float4(v[0].z, v[1].z, v[2].z, v[3].z),
                              make_float4(v[0].w, v[1].w, v[2].w, v[3].w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) store_unit<R, E>(st, 4 * (pt & 31) + i, pt >> 5, rows[i]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < units<R>(); ++i) {
    int r, c;
    unit<R>(o.kmajor, pt, i, r, c);
    store_unit<R, E>(st, r, c, v[i]);
  }
}

// wgmma descriptor of a K-major no-swizzle tile of R rows at p: leading byte
// offset (the next 4 k) R·16, stride byte offset (the next 8 rows) 128
template <int R>
__device__ __forceinline__ uint64_t desc(const void* p) {
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

// d[0, 32) = A·B + (scale_d ? d : 0) over k 16, m64n64k16, bf16, A and B
// in shared memory, K-major (TA, TB 0) or MN-major (1: the transpose bits)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB)
      : "memory");
}

// d[0, 64) = A·B + (scale_d ? d : 0) over k 16, m64n128k16, bf16
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB)
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

// a stage: A_hi, A_lo, B_hi, B_lo (f32), or SPS slabs' A, B (bf16: one
// slab on the register path, four where the producer copies them)
template <int BN, int E, int SPS = 1>
__host__ __device__ constexpr int stage_bytes() {
  return E == F32 ? 2 * (BM + BN) * BK * 4 : SPS * (BM + BN) * BK * 2;
}

// A's tile(s) first, then B's
template <int E>
__host__ __device__ constexpr int a_tile_bytes() {
  return E == F32 ? 2 * BM * BK * 4 : BM * BK * 2;
}

template <int BN, int E, int SPS = 1>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<BN, E, SPS>();
}

// one slab's operands in registers, between its loads and its staging; with
// the producer's transforms also the parameters they need at the slab's k,
// loaded with the slab one slab ahead
template <int BN>
struct Slab {
  float4 a[units<BM>()], b[units<BN>()];
  float kp[4], kq[4];  // XF_LN: the LayerNorm's parameters at the slab's k
  // XF_ACT (with b_rs), XF_SCALE: B's row scales over the slab, sc0 below
  // k = kb, sc1 from there (a slab of BK k meets at most two samples where
  // b_rs_rows ≥ BK; below that, the scalar division)
  float sc0, sc1;
  int kb;
};

// XF_LN: the LayerNorm's parameters of the tile's fixed rows
struct Fixed {
  float p[4], q[4];
};

// The producer's transforms.  Where a load puts each element of an operand
// tile: a K-contiguous tile (kmajor) gives unit i row r0 + row_i (the same
// over the tile's slabs) and k = k0 + 4·(lane / 8) + j in component j, the
// same k for every unit; a tvec tile rows r0 + 4·lane + j and k = k0 +
// 4·warp + i; any other (scalar) unit i row r0 + row_i and k = k0 +
// 4·chunk_i + j.  So a thread needs the LayerNorm's parameters of four
// fixed rows (mu, rstd of token rows; g, b of feature rows in the split-K
// form, where the token is k) once a tile, and of four k (g, b; mu, rstd)
// or the row scales of the (at most two) samples it meets once a slab (the
// scalar layout, odd shapes only, reads its LayerNorm k's as it goes).
// Positions past o.rows or k_end stay zero: act(0) = 0 and 0·s = 0, and the
// LayerNorm keeps them by a select.
template <int R>
__device__ __forceinline__ bool along_rows(const Operand& o) {
  if constexpr (R == 128 && units<R>() == 4) return o.tvec;
  return false;
}

// the tile row of the thread's i-th fixed row: unit i's, or the tvec row i
template <int R>
__device__ __forceinline__ int fixed_row(const Operand& o, int pt, int i) {
  if (along_rows<R>(o)) return 4 * (pt & 31) + i;
  int r, c;
  unit<R>(o.kmajor, pt, i < units<R>() ? i : 0, r, c);
  return r;
}

// the thread's i-th k of the slab at k0: tvec k0 + 4·warp + i, kmajor
// k0 + 4·(lane / 8) + i
template <int R>
__device__ __forceinline__ int slab_k(const Operand& o, int pt, int k0, int i) {
  return along_rows<R>(o) ? k0 + 4 * (pt >> 5) + i : k0 + 4 * ((pt & 31) >> 3) + i;
}

// the LayerNorm's arrays by role: of the fixed rows (P, Q) and of k (KP, KQ)
template <bool SPLIT_K>
__device__ __forceinline__ void ln_arrays(const GemmExtra& x, const float*& P,
                                          const float*& Q, const float*& KP,
                                          const float*& KQ) {
  P = SPLIT_K ? x.ln_g : x.ln_mu;
  Q = SPLIT_K ? x.ln_b : x.ln_rstd;
  KP = SPLIT_K ? x.ln_mu : x.ln_g;
  KQ = SPLIT_K ? x.ln_rstd : x.ln_b;
}

template <bool SPLIT_K>
__device__ __forceinline__ void load_fixed(Fixed& f, const Args& a, int pt, int m0) {
  const float *P, *Q, *KP, *KQ;
  ln_arrays<SPLIT_K>(a.x, P, Q, KP, KQ);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + fixed_row<BM>(a.a, pt, i);
    f.p[i] = r < a.a.rows ? __ldg(P + r) : 0.f;
    f.q[i] = r < a.a.rows ? __ldg(Q + r) : 0.f;
  }
}

template <int BN, bool SPLIT_K, int XF>
__device__ __forceinline__ void load_params(Slab<BN>& r, const Args& a, int pt, int k0,
                                            int k_end) {
  if constexpr (XF == XF_LN) {
    const float *P, *Q, *KP, *KQ;
    ln_arrays<SPLIT_K>(a.x, P, Q, KP, KQ);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = slab_k<BM>(a.a, pt, k0, i);
      r.kp[i] = k < k_end ? __ldg(KP + k) : 0.f;
      r.kq[i] = k < k_end ? __ldg(KQ + k) : 0.f;
    }
  }
  if constexpr (XF == XF_ACT || XF == XF_SCALE) {
    if (XF == XF_SCALE || a.x.b_rs) {
      const int rows = a.x.b_rs_rows, smp = k0 / rows, last = (a.K - 1) / rows;
      r.kb = (smp + 1) * rows;
      r.sc0 = __ldg(a.x.b_rs + smp);
      r.sc1 = smp < last ? __ldg(a.x.b_rs + smp + 1) : 1.f;
    }
  }
}

template <int BN, bool SPLIT_K, int XF, int E>
__device__ __forceinline__ void load_slab(Slab<BN>& r, const Args& a, int pt, int m0,
                                          int n0, int k0, int k_end) {
  load_tile<BM, E>(r.a, a.a, pt, m0, k0, k_end);
  load_tile<BN, E>(r.b, a.b, pt, n0, k0, k_end);
  load_params<BN, SPLIT_K, XF>(r, a, pt, k0, k_end);
}

// the LayerNorm apply, ln_rows_kernel's expression ((v − mu)·rstd)·g + b,
// of element e at a valid position (ok), with the token's (mu, rstd) and
// the feature's (g, b) parameters
__device__ __forceinline__ float ln_at(float e, bool ok, float mu, float rstd, float g,
                                       float b) {
  const float u = (e - mu) * rstd * g + b;
  return ok ? u : e;
}

// XF_LN on A (R = BM): the token is the row (fixed: mu, rstd; k: g, b) or,
// in the split-K form, k (k: mu, rstd; fixed: g, b)
template <int BN, bool SPLIT_K>
__device__ __forceinline__ void ln_tile(Slab<BN>& s, const Fixed& f, const Args& a, int pt,
                                        int k0, int k_end, int r0) {
  const Operand& o = a.a;
  auto apply = [&](float& e, bool ok, float fp, float fq, float kp, float kq) {
    e = SPLIT_K ? ln_at(e, ok, kp, kq, fp, fq) : ln_at(e, ok, fp, fq, kp, kq);
  };
  if (along_rows<BM>(o)) {  // rows r0 + 4·lane + j, k = k0 + 4·warp + i
    const int gr = r0 + 4 * (pt & 31);
#pragma unroll
    for (int i = 0; i < units<BM>(); ++i) {
      const bool kv = k0 + 4 * (pt >> 5) + i < k_end;
      apply(s.a[i].x, kv && gr < o.rows, f.p[0], f.q[0], s.kp[i], s.kq[i]);
      apply(s.a[i].y, kv && gr + 1 < o.rows, f.p[1], f.q[1], s.kp[i], s.kq[i]);
      apply(s.a[i].z, kv && gr + 2 < o.rows, f.p[2], f.q[2], s.kp[i], s.kq[i]);
      apply(s.a[i].w, kv && gr + 3 < o.rows, f.p[3], f.q[3], s.kp[i], s.kq[i]);
    }
  } else if (o.kmajor) {  // unit i row r0 + row_i, k = k0 + 4·(lane / 8) + j
    const int kb = k0 + 4 * ((pt & 31) >> 3);
#pragma unroll
    for (int i = 0; i < units<BM>(); ++i) {
      const bool rv = r0 + fixed_row<BM>(o, pt, i) < o.rows;
      apply(s.a[i].x, rv && kb < k_end, f.p[i], f.q[i], s.kp[0], s.kq[0]);
      apply(s.a[i].y, rv && kb + 1 < k_end, f.p[i], f.q[i], s.kp[1], s.kq[1]);
      apply(s.a[i].z, rv && kb + 2 < k_end, f.p[i], f.q[i], s.kp[2], s.kq[2]);
      apply(s.a[i].w, rv && kb + 3 < k_end, f.p[i], f.q[i], s.kp[3], s.kq[3]);
    }
  } else {  // scalar: unit i row r0 + row_i, k = k0 + 4·chunk_i + j, read here
    const float *P, *Q, *KP, *KQ;
    ln_arrays<SPLIT_K>(a.x, P, Q, KP, KQ);
#pragma unroll
    for (int i = 0; i < units<BM>(); ++i) {
      int r, c;
      unit<BM>(false, pt, i, r, c);
      const bool rv = r0 + r < o.rows;
      const int kb = k0 + 4 * c;
      float kp[4], kq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kp[j] = kb + j < k_end ? __ldg(KP + kb + j) : 0.f;
        kq[j] = kb + j < k_end ? __ldg(KQ + kb + j) : 0.f;
      }
      apply(s.a[i].x, rv && kb < k_end, f.p[i], f.q[i], kp[0], kq[0]);
      apply(s.a[i].y, rv && kb + 1 < k_end, f.p[i], f.q[i], kp[1], kq[1]);
      apply(s.a[i].z, rv && kb + 2 < k_end, f.p[i], f.q[i], kp[2], kq[2]);
      apply(s.a[i].w, rv && kb + 3 < k_end, f.p[i], f.q[i], kp[3], kq[3]);
    }
  }
}

// B's row scale at k (XF_ACT with b_rs, XF_SCALE): sc0 below s.kb, sc1 from
// there (b_rs_rows ≥ BK), else rs[k / rows] read here
template <int BN>
__device__ __forceinline__ void scale_tile(Slab<BN>& s, const Args& a, int pt, int k0) {
  const Operand& o = a.b;
  const bool two = a.x.b_rs_rows >= BK;
  auto sc = [&](int k) {
    return two ? (k < s.kb ? s.sc0 : s.sc1)
               : __ldg(a.x.b_rs + min(k, a.K - 1) / a.x.b_rs_rows);
  };
#pragma unroll
  for (int i = 0; i < units<BN>(); ++i) {
    if (along_rows<BN>(o)) {  // the unit's four rows at k = k0 + 4·warp + i
      const float c = sc(k0 + 4 * (pt >> 5) + i);
      s.b[i] = make_float4(s.b[i].x * c, s.b[i].y * c, s.b[i].z * c, s.b[i].w * c);
    } else {  // component j at k = k0 + 4·chunk + j
      int r, c;
      unit<BN>(o.kmajor, pt, i, r, c);
      const int kb = k0 + 4 * c;
      s.b[i] = make_float4(s.b[i].x * sc(kb), s.b[i].y * sc(kb + 1), s.b[i].z * sc(kb + 2),
                           s.b[i].w * sc(kb + 3));
    }
  }
}

// the producer's transform of slab s (XF_LN: A's LayerNorm; XF_ACT: act on
// A, and B's row scale with b_rs; XF_SCALE: B's row scale)
template <int BN, bool SPLIT_K, int XF, int ACT, int E>
__device__ __forceinline__ void transform_slab(Slab<BN>& s, const Fixed& f, const Args& a,
                                               int pt, int k0, int k_end, int r0) {
  if constexpr (XF == XF_LN) ln_tile<BN, SPLIT_K>(s, f, a, pt, k0, k_end, r0);
  if constexpr (XF == XF_ACT) {
#pragma unroll
    for (int i = 0; i < units<BM>(); ++i)
      s.a[i] = make_float4(act_fwd<ACT>(s.a[i].x), act_fwd<ACT>(s.a[i].y),
                           act_fwd<ACT>(s.a[i].z), act_fwd<ACT>(s.a[i].w));
    if (a.x.b_rs) scale_tile<BN>(s, a, pt, k0);
  }
  if constexpr (XF == XF_SCALE) scale_tile<BN>(s, a, pt, k0);
}

// into stage st: A's tile(s), then B's (f32 split into hi / lo, bf16
// rounded)
template <int BN, int E>
__device__ __forceinline__ void store_slab(char* st, const Slab<BN>& r, const Args& a,
                                           int pt) {
  store_tile<BM, E>(st, r.a, a.a, pt);
  store_tile<BN, E>(st + a_tile_bytes<E>(), r.b, a.b, pt);
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

// the wgmmas of the nq ≤ SPS slabs in stage st into part, the first
// zeroing it where zero, committed as one group: f32 BK / 8 k steps x three
// passes, the small terms first; bf16 one k16 step a slab, A MN-major where
// TRANS & 1, B where TRANS & 2
template <int BN, int E, int SPS = 1, int TRANS = 0>
__device__ __forceinline__ void mma_slab(float (&part)[BN / 2], const char* st, int wg,
                                         bool zero, int nq = 1) {
  wg_fence();
  if constexpr (E == F32) {
    constexpr int AT = BM * BK, BT = BN * BK;
    // this warpgroup's 64 rows of A: 8 core-matrix rows of 128 bytes on
    const float* a_hi = reinterpret_cast<const float*>(st) + 256 * wg;
    const float* a_lo = a_hi + AT;
    const float* b_hi = reinterpret_cast<const float*>(st) + 2 * AT;
    const float* b_lo = b_hi + BT;
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {  // k 8·s .. 8·s + 7: chunks 2s, 2s + 1
      const uint64_t ah = desc<BM>(a_hi + 8 * s * BM), al = desc<BM>(a_lo + 8 * s * BM);
      const uint64_t bh = desc<BN>(b_hi + 8 * s * BN), bl = desc<BN>(b_lo + 8 * s * BN);
      wgmma<BN>(part, al, bh, !zero || s > 0);
      wgmma<BN>(part, ah, bl);
      wgmma<BN>(part, ah, bh);
    }
  } else {
#pragma unroll
    for (int q = 0; q < SPS; ++q) {
      if (q < nq) {
        const char* sq = st + q * stage_bytes<BN, E>();
        // the warpgroup's 64 rows: 1024 bytes on, as in f32 (the 8-row
        // core-matrix groups are 128 bytes apart in either layout)
        const uint64_t da = desc<BM>(sq + 1024 * wg), db = desc<BN>(sq + a_tile_bytes<E>());
        if constexpr (BN == 128)
          wgmma_bf16_n128<TRANS & 1, (TRANS >> 1)>(part, da, db, !zero || q > 0);
        else
          wgmma_bf16_n64<TRANS & 1, (TRANS >> 1)>(part, da, db, !zero || q > 0);
      }
    }
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
// into nxt first so that its loads are in flight meanwhile; (XF) cur
// transformed (GemmExtra) on the way
template <int BN, bool SPLIT_K, int XF, int ACT, int E>
__device__ __forceinline__ void produce(Slab<BN>& cur, Slab<BN>& nxt, char* smem,
                                        const Args& a, int pt, const Tile& T, int it, int j,
                                        const Fixed& f) {
  if (it + 1 < T.slabs)
    load_slab<BN, SPLIT_K, XF, E>(nxt, a, pt, T.m0, T.n0, T.k_begin + (it + 1) * BK,
                                  T.k_end);
  const int st = j % STAGES;
  transform_slab<BN, SPLIT_K, XF, ACT, E>(cur, f, a, pt, T.k_begin + it * BK, T.k_end, T.m0);
  if (j >= STAGES) bar_sync(empty_bar(st));
  store_slab<BN, E>(smem + st * stage_bytes<BN, E>(), cur, a, pt);
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
// The bf16 row form's epilogue: the JAX kernels' rounding points (or, with
// out_f32, the raw f32 sums); columns n, n + 1 of row m
__device__ __forceinline__ void epilogue_bf16(const Args& a, int m, int n, float r,
                                              const float (&d)[2]) {
  const int N = a.N;
  const long long row_off = (long long)m * N;
  if (a.out_f32) {
    float* orow = static_cast<float*>(a.out) + row_off;
    if (N % 2 == 0) {
      *reinterpret_cast<float2*>(orow + n) = make_float2(d[0], d[1]);
    } else {
      orow[n] = d[0];
      if (n + 1 < N) orow[n + 1] = d[1];
    }
    return;
  }
  const bf16* bias = static_cast<const bf16*>(a.bias);
  const bf16* res = static_cast<const bf16*>(a.res);
  float v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    v[e] = rnd<bf16>(d[e]);
    if (n + e < N) {
      if (bias) v[e] = rnd<bf16>(v[e] + __bfloat162float(bias[n + e]));
      if (a.silu) v[e] = rnd<bf16>(act_fwd<ACT_SILU>(v[e]));
      if (a.rs) v[e] = rnd<bf16>(v[e] * r);
      if (res) v[e] = v[e] + __bfloat162float(res[row_off + n + e]);  // rounded as stored
    }
  }
  bf16* orow = static_cast<bf16*>(a.out) + row_off;
  if (N % 2 == 0) {  // every row, and so the pair, 4-byte aligned
    *reinterpret_cast<uint32_t*>(orow + n) = pack_bf16(v[0], v[1]);
  } else {
    orow[n] = __float2bfloat16_rn(v[0]);
    if (n + 1 < N) orow[n + 1] = __float2bfloat16_rn(v[1]);
  }
}

template <int BN, bool SPLIT_K, int MAP, int E>
__device__ __forceinline__ void epilogue(const Args& a, const Tile& T, int wg,
                                         const float (&acc)[BN / 2]) {
  const int lane = threadIdx.x & 31;
  const int row0 = T.m0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int col0 = T.n0 + 2 * (lane & 3);
  const int M = a.M, N = a.N;
  if constexpr (E == BF16 && !SPLIT_K) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= M) continue;
      const float r = a.rs ? rnd<bf16>(a.rs[m / a.rs_rows]) : 1.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = col0 + 8 * j;
        if (n >= N) continue;
        const float d[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
        epilogue_bf16(a, m, n, r, d);
      }
    }
    return;
  }
  const float* bias = static_cast<const float*>(a.bias);
  const float* res = static_cast<const float*>(a.res);
  float* out = static_cast<float*>(a.out) + (SPLIT_K ? (long long)T.z * M * N : 0LL);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m >= M) continue;
    const long long row_off = (long long)m * N;
    // the map row, once per output row (MAP_NONE: unused, compiled out)
    const long long map_off = MAP == MAP_NONE ? 0 : map_pixel(a.rows_map, m) * N;
    const float r = !SPLIT_K && a.rs ? a.rs[m / a.rs_rows] : 1.f;
    float* orow = out + (MAP == MAP_OUT ? map_off : row_off);
    const float* rrow = res ? res + (MAP == MAP_RES ? map_off : row_off) : nullptr;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = col0 + 8 * j;  // even: this thread's columns n, n + 1
      if (n >= N) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = acc[4 * j + 2 * h + e];
        if (!SPLIT_K && n + e < N) {
          if (bias) v[e] += bias[n + e];
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

// act(h) and act'(h) at once, one exponential (silu) or tanh (gelu) for
// both: act_fwd's and act_grad's expressions, so the values are theirs
template <int ACT>
__device__ __forceinline__ void act_and_grad(float h, float& f, float& g) {
  if constexpr (ACT == ACT_SILU) {
    const float s = sigmoid(h);
    f = h * s;
    g = s + h * s * (1.f - s);
  } else {
    const float t = tanhf(GELU_C * (h + 0.044715f * h * h * h));
    f = 0.5f * h * (1.f + t);
    const float dt = (1.f - t * t) * GELU_C * (1.f + 3.f * 0.044715f * h * h);
    g = 0.5f * (1.f + t) + 0.5f * h * dt;
  }
}

// The row form's epilogue with the passes' options (XF_EPILOGUE, 64-column
// tiles): + bias → silu → with hid the row partials of v·act(hid), v ×= rs,
// v ×= act'(hid) → + res; the column partials of the final value, one row
// of cpart per 16-row warp slice.  The tile's hid values are loaded first,
// so that their latencies overlap; then column pairs outer (j), the
// thread's two rows inner, each pair's column sums down the lane tree and
// written by lanes 0-3 (no shared memory, no barrier).
template <int BN, int ACT>
__device__ __forceinline__ void epilogue_x(const Args& a, const Tile& T, int wg,
                                           const float (&acc)[BN / 2]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;  // w: 0 .. 7
  const int row0 = T.m0 + 64 * wg + 16 * (w & 3) + (lane >> 2);
  const int col0 = T.n0 + 2 * (lane & 3);
  const int M = a.M, N = a.N;
  const GemmExtra& x = a.x;
  const float* bias = static_cast<const float*>(a.bias);
  const float* res = static_cast<const float*>(a.res);
  float* out = static_cast<float*>(a.out);
  // the passes' partials (uniform across the block: kernel arguments)
  const bool rsum_on = x.rpart != nullptr, csum_on = x.cpart != nullptr;
  bool row_ok[2];
  float r[2];
  long long row_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    row_ok[h] = m < M;
    r[h] = a.rs && row_ok[h] ? a.rs[m / a.rs_rows] : 1.f;
    row_off[h] = (long long)m * N;
  }
  float rsum[2][BN / RPART_COLS];  // Σ v·act(hid) over each row's 64-column groups
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < BN / RPART_COLS; ++i) rsum[h][i] = 0.f;
  float hg[BN / 8][2][2];  // the tile's hid values, loaded first
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = col0 + 8 * j;
      if (x.hid && row_ok[h] && n + 1 < N && N % 2 == 0) {  // 8-byte aligned
        const float2 p = *reinterpret_cast<const float2*>(x.hid + row_off[h] + n);
        hg[j][h][0] = p.x;
        hg[j][h][1] = p.y;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          hg[j][h][e] = x.hid && row_ok[h] && n + e < N ? x.hid[row_off[h] + n + e] : 0.f;
      }
    }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = col0 + 8 * j;  // even: this thread's columns n, n + 1
    float c[2] = {0.f, 0.f};     // the pair's sums over the thread's rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = acc[4 * j + 2 * h + e];
        if (row_ok[h] && n + e < N) {
          if (bias) v[e] += bias[n + e];
          if (a.silu) v[e] = act_fwd<ACT_SILU>(v[e]);
          float fh = 0.f, gh = 1.f;
          if (x.hid) act_and_grad<ACT>(hg[j][h][e], fh, gh);
          if (rsum_on) rsum[h][j / 8] += v[e] * fh;
          if (a.rs) v[e] *= r[h];
          if (x.hid) v[e] *= gh;
          if (res) v[e] += res[row_off[h] + n + e];
          c[e] += v[e];
        }
      }
      if (row_ok[h] && n < N) {
        float* orow = out + row_off[h];
        if (N % 2 == 0) {
          *reinterpret_cast<float2*>(orow + n) = make_float2(v[0], v[1]);
        } else {
          orow[n] = v[0];
          if (n + 1 < N) orow[n + 1] = v[1];
        }
      }
    }
    if (csum_on) {  // the warp's 8 row groups
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        c[e] += __shfl_xor_sync(0xffffffffu, c[e], 4);
        c[e] += __shfl_xor_sync(0xffffffffu, c[e], 8);
        c[e] += __shfl_xor_sync(0xffffffffu, c[e], 16);
      }
      // the warp's 16-row slice (lanes 0-3 hold its sums of columns n, n + 1)
      const int slice = (T.m0 + 64 * wg + 16 * (w & 3)) / CPART_ROWS;
      if (lane < 4 && slice * CPART_ROWS < M) {
        float* crow = x.cpart + (long long)slice * N;
        if (n < N) crow[n] = c[0];
        if (n + 1 < N) crow[n + 1] = c[1];
      }
    }
  }
  if (rsum_on) {  // each row's four lanes, then one writes each group's sum
    const int T64 = (N + RPART_COLS - 1) / RPART_COLS;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < BN / RPART_COLS; ++i) {
        float s = rsum[h][i];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        const int grp = T.n0 / RPART_COLS + i;
        if (row_ok[h] && (lane & 3) == 0 && grp < T64)
          x.rpart[(long long)(row0 + 8 * h) * T64 + grp] = s;
      }
  }
}

// The bf16 producer where both operands are 16-byte chunks along K
// (Operand::cp) or both along their rows (Operand::cpt), with no
// transform: a stage holds CP_SLABS slabs (64 k), its tiles copied global →
// shared with 16-byte cp.async (copy_tile), zero-filled past the rows and
// K, and reported full CP_LAG stages later, once its copies have landed, so
// up to CP_LAG + 1 stages (320 k) are in flight where the register path
// keeps one slab.  CP_LAG ≤ STAGES − 2 keeps the ring from waiting on
// itself.  (With one 16-deep slab a stage the copies' latency stayed
// exposed: ViT-S/16's qkv product took 0.431 ms on the H100, 0.390 with
// four; PERF.md.)
constexpr int CP_LAG = STAGES - 2, CP_SLABS = 4;
static_assert(PROMOTE % CP_SLABS == 0, "a stage inside one promotion group");

// An R-row x BK tile's 2·R 16-byte chunks.  K-major (o.cp): chunk (row r,
// k half c) — 8 k of one row, a core-matrix row — at byte 16·(c·R + r).
// MN-major (o.cpt, MN): chunk (row group g of 8 rows, k) — 8 rows of one k
// — at byte 128·g + 16·((k / 8)·R + k mod 8): the same 8 x 16-byte core
// matrices at the same offsets, each holding rows along its 16 bytes and k
// down its 8 lines, which wgmma reads with the transpose bit
template <int R, bool MN>
__device__ __forceinline__ void copy_tile(char* dst, const Operand& o, int pt, int r0, int k0,
                                          int k_end) {
  const bf16* p = static_cast<const bf16*>(o.p);
#pragma unroll
  for (int i = pt; i < 2 * R; i += PRODUCERS) {
    int off, gr, gk;
    long long src;
    if constexpr (MN) {  // neighbouring threads: neighbouring row groups of one k
      const int g = i % (R / 8), k = i / (R / 8);
      off = 128 * g + 16 * ((k >> 3) * R + (k & 7));
      gr = r0 + 8 * g;
      gk = k0 + k;
      src = gr + (long long)gk * o.s_k;
    } else {
      const int r = i >> 1, c = i & 1;
      off = 16 * (c * R + r);
      gr = r0 + r;
      gk = k0 + 8 * c;
      src = (long long)gr * o.s_row + gk;
    }
    const bool ok = gr < o.rows && gk < k_end;
    tc::cp_async16(reinterpret_cast<float*>(dst + off),
                   reinterpret_cast<const float*>(ok ? p + src : p), ok);
  }
}

template <int BN, bool SPLIT_K, int TRANS>
__device__ __forceinline__ void produce_copies(char* smem, const Args& a, int pt, int tiles,
                                               int total) {
  int j = 0;  // the block's stage
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile T = tile_of<BN, SPLIT_K>(a, t);
    for (int it = 0; it < T.slabs; it += CP_SLABS, ++j) {
      const int st = j % STAGES;
      if (j >= STAGES) bar_sync(empty_bar(st));
      char* stage = smem + st * stage_bytes<BN, BF16, CP_SLABS>();
      for (int q = 0; q < CP_SLABS && it + q < T.slabs; ++q) {
        char* slab = stage + q * stage_bytes<BN, BF16>();
        const int k0 = T.k_begin + (it + q) * BK;
        copy_tile<BM, (TRANS & 1) != 0>(slab, a.a, pt, T.m0, k0, T.k_end);
        copy_tile<BN, (TRANS & 2) != 0>(slab + a_tile_bytes<BF16>(), a.b, pt, T.n0, k0,
                                        T.k_end);
      }
      tc::cp_async_commit();
      if (j >= CP_LAG) {  // slab j − CP_LAG has landed: full
        tc::cp_async_wait<CP_LAG>();
        fence_proxy_async();
        bar_arrive(full_bar((j - CP_LAG) % STAGES));
      }
    }
  }
  tc::cp_async_wait<0>();
  fence_proxy_async();
  for (int i = max(0, total - CP_LAG); i < total; ++i) bar_arrive(full_bar(i % STAGES));
}

// A persistent block (one an SM) takes tiles blockIdx.x, + gridDim.x, ...;
// its slabs run through the ring in one sequence, g counting them, so the
// producer fills the next tile's stages while the consumers finish a tile
// and write it out.
// SPS slabs a stage: 1, or CP_SLABS where the bf16 producer copies both
// operands (produce_copies; TRANS: which of them are MN-major)
template <int BN, bool SPLIT_K, int MAP, int XF, int ACT, int E, int SPS, int TRANS>
__global__ void __launch_bounds__(THREADS, 1) gemm_tc_kernel(const Args a, int tiles) {
  extern __shared__ __align__(128) char smem[];
  const int wg = threadIdx.x >> 7;
  int total = 0;  // the block's stages
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    total += (tile_of<BN, SPLIT_K>(a, t).slabs + SPS - 1) / SPS;

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    const int pt = threadIdx.x - CONSUMERS;
    if constexpr (SPS > 1) {
      produce_copies<BN, SPLIT_K, TRANS>(smem, a, pt, tiles, total);
      return;
    }
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile T = tile_of<BN, SPLIT_K>(a, t);
      Slab<BN> r0, r1;  // two slabs, so that each register set is named statically
      if (T.slabs > 0)
        load_slab<BN, SPLIT_K, XF, E>(r0, a, pt, T.m0, T.n0, T.k_begin, T.k_end);
      Fixed f;  // XF_LN: the tile's fixed rows' parameters
      if constexpr (XF == XF_LN) load_fixed<SPLIT_K>(f, a, pt, T.m0);
      for (int it = 0; it < T.slabs; it += 2) {
        produce<BN, SPLIT_K, XF, ACT, E>(r0, r1, smem, a, pt, T, it, g + it, f);
        if (it + 1 < T.slabs)
          produce<BN, SPLIT_K, XF, ACT, E>(r1, r0, smem, a, pt, T, it + 1, g + it + 1, f);
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
    // stage is's slabs' wgmmas issued once it is full; then the previous
    // stage's done (or, at the end of a promotion group, all, and part
    // added to acc), and its stage given back to the producer where it
    // waits
    const int stages = (T.slabs + SPS - 1) / SPS;
    for (int is = 0; is < stages; ++is) {
      const int j = g + is, st = j % STAGES, it = is * SPS;
      bar_sync(full_bar(st));
      mma_slab<BN, E, SPS, TRANS>(part, smem + st * stage_bytes<BN, E, SPS>(), wg,
                           it % PROMOTE == 0, min(SPS, T.slabs - it));
      if ((it + SPS) % PROMOTE == 0 || it + SPS >= T.slabs) {
        wg_wait<0>();
        fence_acc(part);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      } else {
        wg_wait<1>();
      }
      if (j >= 1 && j - 1 + STAGES < total) bar_arrive(empty_bar((j - 1) % STAGES));
    }
    if constexpr (XF == XF_EPILOGUE)
      epilogue_x<BN, ACT>(a, T, wg, acc);
    else
      epilogue<BN, SPLIT_K, MAP, E>(a, T, wg, acc);
    g += stages;
  }
}

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// element (r, k) at p[r·s_row + k·s_k] (elements of ``bytes`` each); loads
// of four elements where every slab boundary (a multiple of BK, or K) is a
// multiple of 4
inline Operand operand(const void* p, long long s_row, long long s_k, int rows, int K,
                       int bytes = 4) {
  const bool kmajor = s_k == 1;
  return Operand{p, s_row, s_k, rows, kmajor,
                 kmajor && s_row % 4 == 0 && K % 4 == 0 && aligned(p, 4 * bytes),
                 !kmajor && s_row == 1 && s_k % 4 == 0 && rows % 4 == 0 &&
                     aligned(p, 4 * bytes),
                 bytes == 2 && kmajor && s_row % 8 == 0 && K % 8 == 0 && aligned(p, 16),
                 bytes == 2 && !kmajor && s_row == 1 && s_k % 8 == 0 && rows % 8 == 0 &&
                     aligned(p, 16)};
}

template <int BN, bool SPLIT_K, int MAP, int XF, int ACT, int E = F32, int SPS = 1,
          int TRANS = 0>
cudaError_t launch_t(const Args& a, int splits, cudaStream_t s) {
  static_assert(smem_bytes<BN, E, SPS>() <= 227 * 1024, "a block's shared memory");
  static bool sized = false;  // the attribute once per instantiation
  if (!sized) {
    VTX_CHECK(cudaFuncSetAttribute(gemm_tc_kernel<BN, SPLIT_K, MAP, XF, ACT, E, SPS, TRANS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes<BN, E, SPS>()));
    sized = true;
  }
  int dev, sms;  // persistent blocks: one an SM
  VTX_CHECK(cudaGetDevice(&dev));
  VTX_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const long long tiles = (long long)cdiv(a.N, BN) * cdiv(a.M, BM) * splits;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = (int)(tiles < sms ? tiles : sms);
  gemm_tc_kernel<BN, SPLIT_K, MAP, XF, ACT, E, SPS, TRANS>
      <<<blocks, THREADS, smem_bytes<BN, E, SPS>(), s>>>(a, (int)tiles);
  return cudaGetLastError();
}

// the bf16 form: the row form and the split-K form, neither with a map or
// a producer transform (B1's backward scales dY by a pass)
template <bool SPLIT_K>
cudaError_t launch_bf16(const Args& a, int splits, cudaStream_t s) {
  if (a.M < 1 || a.N < 1 || a.K < 0 || splits < 1) return cudaErrorInvalidValue;
  const GemmExtra& x = a.x;
  if (x.ln_mu || x.a_act != ACT_NONE || x.b_rs || x.hid || x.rpart || x.cpart)
    return cudaErrorInvalidValue;
  if (!SPLIT_K && a.out_f32 && (a.bias || a.rs || a.res || a.silu))
    return cudaErrorInvalidValue;
  const bool narrow = cdiv(a.N, 64) * 64 < cdiv(a.N, 128) * 128;
  if constexpr (SPLIT_K) {
    if (a.a.cpt && a.b.cpt)  // both operands copied MN-major (the weight gradients)
      return narrow
                 ? launch_t<64, true, MAP_NONE, XF_NONE, ACT_SILU, BF16, CP_SLABS, 3>(a, splits,
                                                                                   s)
                 : launch_t<128, true, MAP_NONE, XF_NONE, ACT_SILU, BF16, CP_SLABS, 3>(a, splits,
                                                                                    s);
  } else if (a.a.cp && a.b.cp) {  // both operands copied, CP_SLABS slabs a stage
    return narrow ? launch_t<64, false, MAP_NONE, XF_NONE, ACT_SILU, BF16, CP_SLABS>(a, 1, s)
                  : launch_t<128, false, MAP_NONE, XF_NONE, ACT_SILU, BF16, CP_SLABS>(a, 1, s);
  }
  return narrow ? launch_t<64, SPLIT_K, MAP_NONE, XF_NONE, ACT_SILU, BF16>(a, splits, s)
                : launch_t<128, SPLIT_K, MAP_NONE, XF_NONE, ACT_SILU, BF16>(a, splits, s);
}

template <bool SPLIT_K, int MAP>
cudaError_t launch(const Args& a, int splits, cudaStream_t s) {
  if (a.M < 1 || a.N < 1 || a.K < 0 || splits < 1) return cudaErrorInvalidValue;
  const GemmExtra& x = a.x;
  // the epilogue's options: row forms without the map; a row scale's rows
  if ((x.hid || x.rpart || x.cpart) && (SPLIT_K || MAP != MAP_NONE))
    return cudaErrorInvalidValue;
  if ((x.rpart && !x.hid) || (x.ln_mu && !(x.ln_rstd && x.ln_g && x.ln_b)) ||
      (x.b_rs && x.b_rs_rows < 1) || x.a_act < ACT_NONE || x.a_act > ACT_GELU ||
      x.hid_act < ACT_SILU || x.hid_act > ACT_GELU)
    return cudaErrorInvalidValue;
  // 128-column tiles unless 64-column ones pad N less
  const bool narrow = cdiv(a.N, 64) * 64 < cdiv(a.N, 128) * 128;
  // the passes' instantiations only where an option is set: the producer's
  // transforms or the epilogue's options (not both), the activation theirs
  const bool prod = x.ln_mu || x.a_act != ACT_NONE || x.b_rs;
  const bool epi = x.hid || x.rpart || x.cpart;
  if constexpr (MAP == MAP_NONE) {
    if (prod && epi) return cudaErrorInvalidValue;
    // A's LayerNorm, or act (with B's row scale where set), or B's row
    // scale alone: the paths never ask for two of them on A
    if (x.ln_mu && (x.a_act != ACT_NONE || x.b_rs)) return cudaErrorInvalidValue;
    if (x.ln_mu)
      return narrow ? launch_t<64, SPLIT_K, MAP, XF_LN, ACT_SILU>(a, splits, s)
                    : launch_t<128, SPLIT_K, MAP, XF_LN, ACT_SILU>(a, splits, s);
    if (x.a_act == ACT_GELU)
      return narrow ? launch_t<64, SPLIT_K, MAP, XF_ACT, ACT_GELU>(a, splits, s)
                    : launch_t<128, SPLIT_K, MAP, XF_ACT, ACT_GELU>(a, splits, s);
    if (x.a_act == ACT_SILU)
      return narrow ? launch_t<64, SPLIT_K, MAP, XF_ACT, ACT_SILU>(a, splits, s)
                    : launch_t<128, SPLIT_K, MAP, XF_ACT, ACT_SILU>(a, splits, s);
    if (prod)
      return narrow ? launch_t<64, SPLIT_K, MAP, XF_SCALE, ACT_SILU>(a, splits, s)
                    : launch_t<128, SPLIT_K, MAP, XF_SCALE, ACT_SILU>(a, splits, s);
    // the epilogue's options on 64-column tiles: at 128 its registers spill
    // into the main loop (the H100 ran it 3x slower)
    if constexpr (!SPLIT_K) {
      if (epi && x.hid_act == ACT_GELU)
        return launch_t<64, false, MAP, XF_EPILOGUE, ACT_GELU>(a, splits, s);
      if (epi) return launch_t<64, false, MAP, XF_EPILOGUE, ACT_SILU>(a, splits, s);
    }
  } else if (prod || epi) {
    return cudaErrorInvalidValue;
  }
  return narrow ? launch_t<64, SPLIT_K, MAP, XF_NONE, ACT_SILU>(a, splits, s)
                : launch_t<128, SPLIT_K, MAP, XF_NONE, ACT_SILU>(a, splits, s);
}

template <int MAP>
cudaError_t launch_rows(const float* A, const float* B, long long sbk, long long sbn,
                        const float* bias, const float* rs, int rs_rows, const float* res,
                        float* out, int M, int N, int K, int silu, MapRows rows_map,
                        const GemmExtra& x, cudaStream_t stream) {
  Args a{};
  a.x = x;
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
                                    silu, MapRows{nullptr, 1}, GemmExtra{}, stream);
}

cudaError_t vtx::launch_gemm_x(const float* A, const float* B, long long sbk, long long sbn,
                               const float* bias, const float* rs, int rs_rows,
                               const float* res, float* out, int M, int N, int K, int silu,
                               const GemmExtra& x, cudaStream_t stream) {
  return gtc::launch_rows<MAP_NONE>(A, B, sbk, sbn, bias, rs, rs_rows, res, out, M, N, K,
                                    silu, MapRows{nullptr, 1}, x, stream);
}

template <int MAP>
cudaError_t vtx::launch_gemm_map(const float* A, const float* B, long long sbk,
                                 long long sbn, const float* bias, const float* rs,
                                 int rs_rows, const float* res, float* out, int M, int N,
                                 int K, int silu, MapRows rows_map, cudaStream_t stream) {
  return gtc::launch_rows<MAP>(A, B, sbk, sbn, bias, rs, rs_rows, res, out, M, N, K, silu,
                               rows_map, GemmExtra{}, stream);
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
  return launch_gemm_splitk_x(A, lda, B, sbk, sbn, part, splits, out, som, son, M, N, K,
                              GemmExtra{}, stream);
}

cudaError_t vtx::launch_gemm_splitk_x(const float* A, int lda, const float* B, long long sbk,
                                      long long sbn, float* part, int splits, float* out,
                                      long long som, long long son, int M, int N, int K,
                                      const GemmExtra& x, cudaStream_t stream) {
  if (splits < 1) return cudaErrorInvalidValue;
  gtc::Args a{};
  a.x = x;
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

cudaError_t vtx::launch_gemm_bf16(const bf16* A, const bf16* B, long long sbk, long long sbn,
                                  const bf16* bias, const float* rs, int rs_rows,
                                  const bf16* res, void* out, int out_f32, int M, int N, int K,
                                  int silu, cudaStream_t stream) {
  gtc::Args a{};
  a.a = gtc::operand(A, K, 1, M, K, 2);
  a.b = gtc::operand(B, sbn, sbk, N, K, 2);
  a.bias = bias;
  a.rs = rs;
  a.rs_rows = rs_rows;
  a.res = res;
  a.out = out;
  a.out_f32 = out_f32;
  a.M = M;
  a.N = N;
  a.K = K;
  a.k_chunk = K;
  a.silu = silu;
  a.rows_map = MapRows{nullptr, 1};
  return gtc::launch_bf16<false>(a, 1, stream);
}

cudaError_t vtx::launch_gemm_splitk_bf16(const bf16* A, int lda, const bf16* B, long long sbk,
                                         long long sbn, float* part, int splits, float* out,
                                         long long som, long long son, int M, int N, int K,
                                         cudaStream_t stream) {
  if (splits < 1) return cudaErrorInvalidValue;
  gtc::Args a{};
  a.a = gtc::operand(A, 1, lda, M, K, 2);
  a.b = gtc::operand(B, sbn, sbk, N, K, 2);
  a.rs_rows = 1;
  a.out = part;
  a.M = M;
  a.N = N;
  a.K = K;
  a.k_chunk = cdiv(cdiv(K, splits), gtc::BK) * gtc::BK;
  a.rows_map = MapRows{nullptr, 1};
  VTX_CHECK(gtc::launch_bf16<true>(a, splits, stream));
  return launch_splitk_reduce(part, splits, M, N, out, som, son, stream);
}

// The GEMM core alone, for its checks and timings (chip_smoke.py phase 3m):
// form 0 launch_gemm_x, 1 launch_gemm_map<MAP_RES>, 2 launch_gemm_map<MAP_OUT>
// (pix [map_hw] the row → pixel table), 3 launch_gemm_splitk_x (A as Aᵀ
// storage with leading dimension lda, part [splits, M, N] workspace, out
// through (som, son)).  ln_mu … cpart are GemmExtra's fields (common.cuh):
// the producer's transforms in forms 0 and 3, the epilogue's options in
// form 0; the map forms take none.  Returns the first cudaError_t met (0 =
// success).
extern "C" int vtx_gemm_tc(const float* A, int lda, const float* B, long long sbk,
                           long long sbn, const float* bias, const float* rs, int rs_rows,
                           const float* res, float* out, const int* pix, int map_hw,
                           int form, float* part, int splits, long long som, long long son,
                           int M, int N, int K, int silu, const float* ln_mu,
                           const float* ln_rstd, const float* ln_g, const float* ln_b,
                           int a_act, const float* b_rs, int b_rs_rows, const float* hid,
                           int hid_act, float* rpart, float* cpart, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MapRows rows_map{pix, map_hw};
  GemmExtra x;
  x.ln_mu = ln_mu;
  x.ln_rstd = ln_rstd;
  x.ln_g = ln_g;
  x.ln_b = ln_b;
  x.a_act = a_act;
  x.b_rs = b_rs;
  x.b_rs_rows = b_rs_rows;
  x.hid = hid;
  x.hid_act = hid_act;
  x.rpart = rpart;
  x.cpart = cpart;
  const bool extra = ln_mu || a_act != ACT_NONE || b_rs || hid || rpart || cpart;
  switch (form) {
    case 0:
      return static_cast<int>(
          launch_gemm_x(A, B, sbk, sbn, bias, rs, rs_rows, res, out, M, N, K, silu, x, s));
    case 1:
      if (!pix || map_hw < 1 || extra) break;
      return static_cast<int>(launch_gemm_map<MAP_RES>(A, B, sbk, sbn, bias, rs, rs_rows,
                                                       res, out, M, N, K, silu, rows_map, s));
    case 2:
      if (!pix || map_hw < 1 || extra) break;
      return static_cast<int>(launch_gemm_map<MAP_OUT>(A, B, sbk, sbn, bias, rs, rs_rows,
                                                       res, out, M, N, K, silu, rows_map, s));
    case 3:
      return static_cast<int>(launch_gemm_splitk_x(A, lda, B, sbk, sbn, part, splits, out,
                                                   som, son, M, N, K, x, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 form alone (chip_smoke.py phase 3bf, the card's tests): form 0
// launch_gemm_bf16 (out bf16, or f32 with out_f32), 3 launch_gemm_splitk_bf16
// (A as Aᵀ storage with leading dimension lda, part [splits, M, N], out f32
// through (som, son)).
extern "C" int vtx_gemm_tc_bf16(const bf16* A, int lda, const bf16* B, long long sbk,
                                long long sbn, const bf16* bias, const float* rs, int rs_rows,
                                const bf16* res, void* out, int out_f32, int form, float* part,
                                int splits, long long som, long long son, int M, int N, int K,
                                int silu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0:
      return static_cast<int>(launch_gemm_bf16(A, B, sbk, sbn, bias, rs, rs_rows, res, out,
                                               out_f32, M, N, K, silu, s));
    case 3:
      if (bias || rs || res || silu || out_f32) break;
      return static_cast<int>(launch_gemm_splitk_bf16(A, lda, B, sbk, sbn, part, splits,
                                                      static_cast<float*>(out), som, son, M,
                                                      N, K, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
