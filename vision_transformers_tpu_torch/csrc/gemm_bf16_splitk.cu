// The bf16 GEMM's TMA kernels for the split-K weight gradients: Aᵀ's
// storage [K, M] and dY [K, N], MN-major (or B K-major, a transposed view)
// (gemm_bf16_tma.cuh; a source of their own, so that nvcc builds them
// beside the others).

#include "gemm_bf16_tma.cuh"

template cudaError_t vtx::gemm_bf16_tma<1, 1, 1>(const TmaGemm&, const Bf16Opts&,
                                                 cudaStream_t);
template cudaError_t vtx::gemm_bf16_tma<1, 0, 1>(const TmaGemm&, const Bf16Opts&,
                                                 cudaStream_t);
