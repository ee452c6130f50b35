// Tensor-core building blocks for f32-accurate products on Hopper (sm_90a):
// the 3xTF32 split, mma.sync m16n8k8 TF32 with f32 accumulators, fragment
// loads from shared memory and cp.async staging.
//
// 3xTF32.  A TF32 product keeps 10 mantissa bits of each operand, too few
// for the port's f32 limits (1e-4 on a forward, 1e-3 relative on a
// gradient).  Each operand is split as x = hi + lo with hi = tf32(x) and
// lo = tf32(x − hi), both rounded by cvt.rna.tf32.f32, and a product takes
// three tensor-core passes, the small terms first:
//   d += a_lo·b_hi;  d += a_hi·b_lo;  d += a_hi·b_hi
// (a_lo·b_lo, below 2^-22 of the product, is dropped).  That is CUTLASS's
// OpMultiplyAddFastF32 scheme and keeps f32 accuracy at a third of the
// TF32 rate: 495 / 3 = 165 TFLOP/s of f32-accurate products at 700 W,
// 2.5x the f32 FMA peak.
//
// mma.sync, not wgmma.  The attention tiles here are 16 rows per warp, and
// TF32 wgmma would need V transposed K-major in shared memory; mma.sync
// takes every operand layout the attention products need.  It is a step
// toward wgmma, not the end.
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A 16x8 row-major:  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B 8x8 (k, n):      b0 (t, g)   b1 (t+4, g)
//   C 16x8:            c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// A product whose A operand is a C fragment (P·V, dS·K, Pᵀ·dO) permutes its
// k index inside each step of 8: logical k = t is column 2t and k = t + 4
// is column 2t + 1, so A = {c0, c2, c1, c3} with no shuffle, and the B rows
// are read in the same order (rows 2t and 2t + 1: the "kperm" loads).
// Shared-memory tiles have a row stride ≡ 4 (mod 32) floats, so every
// fragment load below is free of bank conflicts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

// x rounded to TF32: 10 mantissa bits, to nearest, ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a·b on the tensor cores, m16n8k8, TF32 in, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// d += a·b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// A from an f32 row-major tile, T at (r0, k0), split as it loads
__device__ __forceinline__ void load_a(FragA& f, const float* T, int ld, int g, int t) {
  split(T[g * ld + t], f.hi[0], f.lo[0]);
  split(T[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  split(T[g * ld + t + 4], f.hi[2], f.lo[2]);
  split(T[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
}

// A from pre-split row-major tiles Hi / Lo at (r0, k0)
__device__ __forceinline__ void load_a_split(FragA& f, const float* Hi, const float* Lo,
                                             int ld, int g, int t) {
  const int o[4] = {g * ld + t, (g + 8) * ld + t, g * ld + t + 4, (g + 8) * ld + t + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = __float_as_uint(Hi[o[i]]);
    f.lo[i] = __float_as_uint(Lo[o[i]]);
  }
}

// A (r, k) = T[k][r] from an f32 tile stored transposed, T at (k0, r0),
// k permuted (rows 2t and 2t + 1), split as it loads
__device__ __forceinline__ void load_a_tperm(FragA& f, const float* T, int ld, int g,
                                             int t) {
  split(T[2 * t * ld + g], f.hi[0], f.lo[0]);
  split(T[2 * t * ld + g + 8], f.hi[1], f.lo[1]);
  split(T[(2 * t + 1) * ld + g], f.hi[2], f.lo[2]);
  split(T[(2 * t + 1) * ld + g + 8], f.hi[3], f.lo[3]);
}

// A from a C fragment (k permuted), split
__device__ __forceinline__ void a_from_c(FragA& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// B (k, n) = T[n][k] from pre-split tiles stored n-major (K for q·kᵀ), at (n0, k0)
__device__ __forceinline__ void load_b_nmajor(FragB& f, const float* Hi, const float* Lo,
                                              int ld, int g, int t) {
  f.hi[0] = __float_as_uint(Hi[g * ld + t]);
  f.hi[1] = __float_as_uint(Hi[g * ld + t + 4]);
  f.lo[0] = __float_as_uint(Lo[g * ld + t]);
  f.lo[1] = __float_as_uint(Lo[g * ld + t + 4]);
}

// B (k, n) = T[k][n] from pre-split tiles stored k-major, k permuted (V for
// p·v), at (k0, n0)
__device__ __forceinline__ void load_b_kperm(FragB& f, const float* Hi, const float* Lo,
                                             int ld, int g, int t) {
  f.hi[0] = __float_as_uint(Hi[2 * t * ld + g]);
  f.hi[1] = __float_as_uint(Hi[(2 * t + 1) * ld + g]);
  f.lo[0] = __float_as_uint(Lo[2 * t * ld + g]);
  f.lo[1] = __float_as_uint(Lo[(2 * t + 1) * ld + g]);
}

// the max / sum over the quad of lanes that holds one row of a C fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// cp.async staging: 16- or 4-byte copies global → shared that zero-fill
// when ``ok`` is false (src is then not read, but must be a valid,
// aligned address), grouped by commit and waited on by group
// ---------------------------------------------------------------------------

// a pointer a 16-byte copy may take
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The split the attention kernels use (halo_attention_tc.cuh,
// window_attention_tc.cuh): one conversion an element, lo left for the
// tensor core to truncate, and the fragment loads that split with it
// ---------------------------------------------------------------------------

// the warps of group ``grp`` (``warps`` of them) meet: a named barrier, or
// the warp alone
__device__ __forceinline__ void group_sync(int grp, int warps) {
  if (warps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(warps * 32) : "memory");
}

// x = hi + lo: hi rounded to TF32, lo = x − hi left for the tensor core to
// truncate (an error below 2⁻²¹·|x|, as CUTLASS's fast 3xTF32 takes it)
__device__ __forceinline__ void split_lo(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the fragment loads with this split: A from an f32 row-major tile at
// (r0, k0) ...
__device__ __forceinline__ void ld_a(FragA& f, const float* T, int ld, int g, int t) {
  split_lo(T[g * ld + t], f.hi[0], f.lo[0]);
  split_lo(T[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  split_lo(T[g * ld + t + 4], f.hi[2], f.lo[2]);
  split_lo(T[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
}

// ... A (r, k) = T[k][r] from a tile stored transposed, k permuted ...
__device__ __forceinline__ void ld_a_tperm(FragA& f, const float* T, int ld, int g,
                                           int t) {
  split_lo(T[2 * t * ld + g], f.hi[0], f.lo[0]);
  split_lo(T[2 * t * ld + g + 8], f.hi[1], f.lo[1]);
  split_lo(T[(2 * t + 1) * ld + g], f.hi[2], f.lo[2]);
  split_lo(T[(2 * t + 1) * ld + g + 8], f.hi[3], f.lo[3]);
}

// ... A from a C fragment (k permuted) ...
__device__ __forceinline__ void c_to_a(FragA& f, const float (&c)[4]) {
  split_lo(c[0], f.hi[0], f.lo[0]);
  split_lo(c[2], f.hi[1], f.lo[1]);
  split_lo(c[1], f.hi[2], f.lo[2]);
  split_lo(c[3], f.hi[3], f.lo[3]);
}

// ... B (k, n) = T[n][k] from a tile stored n-major (K for q·kᵀ) ...
__device__ __forceinline__ void ld_b_nmajor(FragB& f, const float* T, int ld, int g,
                                            int t) {
  split_lo(T[g * ld + t], f.hi[0], f.lo[0]);
  split_lo(T[g * ld + t + 4], f.hi[1], f.lo[1]);
}

// ... B (k, n) = T[k][n] from a tile stored k-major, k permuted (rows 2t and
// 2t + 1: the A operand is a C fragment or a tperm load) ...
__device__ __forceinline__ void ld_b_kperm(FragB& f, const float* T, int ld, int g,
                                           int t) {
  split_lo(T[2 * t * ld + g], f.hi[0], f.lo[0]);
  split_lo(T[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
}

// ... and the pair forms of q·kᵀ in the forward: the k index of a step of 8
// relabelled for both operands (hardware k = t is column 2t, k = t + 4 is
// 2t + 1), so a thread's two columns are adjacent and load as one float2;
// tiles with a row stride ≡ 8 (mod 32) floats, conflict-free.  A from a
// row-major tile at (r0, k0) ...
__device__ __forceinline__ void ld_a_pairs(FragA& f, const float* T, int ld, int g,
                                           int t) {
  const float2 x0 = *reinterpret_cast<const float2*>(T + g * ld + 2 * t);
  const float2 x1 = *reinterpret_cast<const float2*>(T + (g + 8) * ld + 2 * t);
  split_lo(x0.x, f.hi[0], f.lo[0]);
  split_lo(x1.x, f.hi[1], f.lo[1]);
  split_lo(x0.y, f.hi[2], f.lo[2]);
  split_lo(x1.y, f.hi[3], f.lo[3]);
}

// ... B (k, n) = T[n][k] from a tile stored n-major
__device__ __forceinline__ void ld_b_pairs(FragB& f, const float* T, int ld, int g,
                                           int t) {
  const float2 x = *reinterpret_cast<const float2*>(T + g * ld + 2 * t);
  split_lo(x.x, f.hi[0], f.lo[0]);
  split_lo(x.y, f.hi[1], f.lo[1]);
}

}  // namespace tc
}  // namespace
