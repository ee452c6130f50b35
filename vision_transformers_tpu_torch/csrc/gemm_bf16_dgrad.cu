// The bf16 GEMM's TMA kernels for the data gradients: dY [M, K] K-major
// and the weight [K, N] read in place, MN-major (gemm_bf16_tma.cuh; a
// source of their own, so that nvcc builds them beside the others).

#include "gemm_bf16_tma.cuh"

template cudaError_t vtx::gemm_bf16_tma<0, 1, 0>(const TmaGemm&, const Bf16Opts&,
                                                 cudaStream_t);
template cudaError_t vtx::gemm_bf16_tma<0, 1, 1>(const TmaGemm&, const Bf16Opts&,
                                                 cudaStream_t);
