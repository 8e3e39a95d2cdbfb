// K4/K5 forward for bfloat16 on Hopper tensor cores (flash_attention_sm90.cu).
// flash_attention.cu's two forward entry points hand every bfloat16 call
// here; float32 calls keep the CUDA-core kernel there.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace rtvc {

struct Sm90Attention {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const uint8_t* kv_mask;  // [B, Lkv], nonzero = attend; may be null
  int B, H, Lq, Lkv, D;
  // element strides per batch, head and row of q, k, v and out (D contiguous)
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, ob, oh, ol;
  float scale;
  int causal, prefix_len;
  uint32_t seed, thresh;
  float keep;  // 1 - rate
  int dropout;
};

// Launches the kernel on `stream`; returns a cudaError_t code (0 = launched).
int attention_sm90(const Sm90Attention& a, cudaStream_t stream);

}  // namespace rtvc
