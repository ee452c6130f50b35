// The bf16 GEMM's TMA kernels for the forward's products: the activations
// [M, K] and the weight views [N, K], both K-major (gemm_bf16_tma.cuh; a
// source of their own, so that nvcc builds them beside the others).

#include "gemm_bf16_tma.cuh"

template cudaError_t vtx::gemm_bf16_tma<0, 0, 0>(const TmaGemm&, const Bf16Opts&,
                                                 cudaStream_t);
template cudaError_t vtx::gemm_bf16_tma<0, 0, 1>(const TmaGemm&, const Bf16Opts&,
                                                 cudaStream_t);
