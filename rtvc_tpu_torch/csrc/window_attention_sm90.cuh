// K1 for bfloat16 on the tensor cores (window_attention_sm90.cu).
// window_attention.cu's entry point hands every bfloat16 call here;
// float32 calls keep the CUDA-core kernel there.
#pragma once

#include <cuda_runtime.h>

namespace rtvc {

// q/k/v/out contiguous [windows, H, N, 32] bfloat16, bias [H, N, N]
// float32, N <= 256. Launches on `stream`; returns a cudaError_t code
// (0 = launched).
int window_attention_sm90(const void* q, const void* k, const void* v,
                          const void* bias, void* out, int windows, int H,
                          int N, float scale, int scores_in_input_dtype,
                          cudaStream_t stream);

// SMs of the current device, asked once: both K1 kernels, K2, K3 and K7
// size their grids by it
int device_sm_count();

}  // namespace rtvc
