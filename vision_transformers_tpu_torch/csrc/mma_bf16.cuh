// Tensor-core building blocks for bf16 products on Hopper (sm_90a): mma.sync
// m16n8k16 with bf16 operands and f32 accumulators, and its fragment loads
// from shared memory: 32-bit loads of element pairs where a fragment's pair
// is contiguous, ldmatrix (.trans) where it is not, and A fragments packed
// straight from the accumulators of a previous product.  The bf16 form of
// the packed-row attention core (attention_tc.cuh) is built from them.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4; a register
// holds two bf16, the lower column / row in its low half):
//   A 16x16 row-major:  a0 (g, 2t..2t+1)   a1 (g+8, 2t..2t+1)
//                       a2 (g, 2t+8..+9)   a3 (g+8, 2t+8..+9)
//   B 16x8 (k, n):      b0 (k 2t..2t+1, n g)   b1 (k 2t+8..2t+9, n g)
//   C 16x8:             c0 c1 (g, 2t..2t+1)    c2 c3 (g+8, 2t..2t+1)
// So the C fragments of two adjacent 8-column tiles are, packed in pairs,
// the A fragment of the 16 columns they cover (P·V, Pᵀ·dO, dSᵀ·Q): no
// shuffle.  Shared-memory tiles have a row stride ≡ 16 bytes (mod 128), so
// the pair loads and ldmatrix's 16-byte rows are free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {
namespace tc {

// d += a·b on the tensor cores, m16n8k16, bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A from a row-major tile at (r0, k0)
__device__ __forceinline__ void ldb_a(uint32_t (&a)[4], const bf16* T, int ld, int g, int t) {
  a[0] = ld_pair(T + g * ld + 2 * t);
  a[1] = ld_pair(T + (g + 8) * ld + 2 * t);
  a[2] = ld_pair(T + g * ld + 2 * t + 8);
  a[3] = ld_pair(T + (g + 8) * ld + 2 * t + 8);
}

// B (k, n) = T[n][k] from a tile stored n-major (K for q·kᵀ, q and dO for
// k·qᵀ and v·doᵀ), at (n0, k0)
__device__ __forceinline__ void ldb_b_nmajor(uint32_t (&b)[2], const bf16* T, int ld, int g,
                                             int t) {
  b[0] = ld_pair(T + g * ld + 2 * t);
  b[1] = ld_pair(T + g * ld + 2 * t + 8);
}

// A from the C fragments of two adjacent 8-column tiles (columns 0-7, 8-15),
// rounded to bf16
__device__ __forceinline__ void a_from_c2(uint32_t (&a)[4], const float (&c0)[4],
                                          const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// four 8x8 matrices, transposed, from shared memory: lane l gives the row
// address of row l mod 8 of matrix l / 8; register i gets matrix i's
// transpose in the C-like layout (thread (g, t): M[2t][g], M[2t + 1][g])
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

// B (k, n) = T[k][n] from a tile stored k-major (V for p·v, dO for pᵀ·do, Q
// for dsᵀ·q, K for ds·k), at (k0, n0): the B fragments of the two 8-column
// tiles n0 .. n0 + 7 (b0) and n0 + 8 .. n0 + 15 (b1) over k0 .. k0 + 15
__device__ __forceinline__ void ldb_b_kmajor_x2(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                                const bf16* T, int ld, int lane) {
  const int m = lane >> 3, r = lane & 7;
  uint32_t x[4];
  ldmatrix_x4_trans(x, T + (r + 8 * (m & 1)) * ld + 8 * (m >> 1));
  b0[0] = x[0];
  b0[1] = x[1];
  b1[0] = x[2];
  b1[1] = x[3];
}

// A (r, k) = T[k][r] from a tile stored transposed (dS [keys][queries] for
// ds·k), at (k0, r0)
__device__ __forceinline__ void ldb_a_trans(uint32_t (&a)[4], const bf16* T, int ld,
                                            int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(a, T + (r + 8 * (m >> 1)) * ld + 8 * (m & 1));
}

}  // namespace tc
}  // namespace
