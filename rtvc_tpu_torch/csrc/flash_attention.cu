// K4: fused multi-head attention (flash forward), and K5: BLHD attention.
//
// K4 replaces the Pallas kernel rtvc_tpu/ops/attention.py _pallas_attention
// (kernel bodies _make_kernel / _block_probs, native_score_dot and
// softmax_native off, no dropout):
//   out = softmax(mask(q k^T * scale)) v   per (batch, head),
// with float32 score products, the prefix-causal mask k < P or k <= q built
// from indices, an optional [B, Lkv] key mask, masked scores set to the
// finite sentinel -1e30 (a row whose keys are all masked averages V
// uniformly, as the TPU kernel does, instead of giving NaN), float32
// probabilities times float32 V, and the output in the input dtype. It
// serves the GIT joint attention ([8, 12, 1582, 64], prefix 1542) and the
// beam's visual prefill ([B * beams, 12, 1542, 64], every key visible).
//
// K5 replaces rtvc_tpu/ops/attention.py blhd_attention (_make_blhd_kernel):
// the same arithmetic with no mask, reading q/k/v in place from the QKV
// GEMM's [B, L, H, D] view through strides and writing [B, L, H, D], so no
// head transpose is copied around it. It serves the CLIP tower's 24
// attention layers ([B * 6, 257, 16, 64]). Both entry points run the one
// kernel below; only their strides and masks differ.
//
// What bounds it on an H100: float32 arithmetic. The TPU kernel holds one
// head's whole K and V in VMEM (1582 x 64 x 4 B each); a block's shared
// memory cannot, so K and V stream through it in 64-key tiles with an
// online softmax (running float32 max and sum per row, rescaling the
// accumulator when the max grows). The products stay in float32 on the
// CUDA cores, as the TPU kernel's f32 dots are: bf16 tensor cores would
// round the probabilities and TF32 the scores. A block of 256 threads owns
// 64 query rows; thread (ty, tx) holds the scores and output columns
// tx + 16 j of rows ty + 16 i in registers (a 4 x 4 register tile: 16 FMAs
// per 8 shared-memory loads). K is staged transposed and every tile row is
// padded by one float, so the loads are free of bank conflicts. Probabilities
// go through shared memory to the P.V product. Keys past Lkv contribute
// nothing; masked keys contribute exp(-1e30 - max), which is 0 unless the
// whole row is masked.

#include "common.cuh"

namespace rtvc {
namespace {

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per shared-memory tile
constexpr int kHeadDim = 64;   // largest D; smaller D is zero-padded
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdQ = kHeadDim + 1;
constexpr int kLdK = kBlockK + 1;  // sK is [D][keys]
constexpr int kLdP = kBlockK + 1;
constexpr float kMasked = -1e30f;

constexpr size_t smem_bytes() {
  return (size_t)(kBlockQ * kLdQ + kHeadDim * kLdK + kBlockK * kHeadDim +
                  kBlockQ * kLdP) * sizeof(float);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const uint8_t* kv_mask;  // [B, Lkv], nonzero = attend; may be null
  int H, Lq, Lkv, D;
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, ob, oh, ol;  // elements
  float scale;
  int causal, prefix_len;
};

// reduce over the 16 lanes that share a row (lane bits 0-3 are tx)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_kernel(Args a) {
  extern __shared__ float smem[];
  float* sQ = smem;                      // [kBlockQ][kLdQ]
  float* sK = sQ + kBlockQ * kLdQ;       // [kHeadDim][kLdK], transposed
  float* sV = sK + kHeadDim * kLdK;      // [kBlockK][kHeadDim]
  float* sP = sV + kBlockK * kHeadDim;   // [kBlockQ][kLdP]
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int q0 = blockIdx.x * kBlockQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* qp = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + h * a.kh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + h * a.vh;
  T* op = static_cast<T*>(a.out) + b * a.ob + h * a.oh;
  const uint8_t* mask =
      a.kv_mask == nullptr ? nullptr : a.kv_mask + (size_t)b * a.Lkv;

  for (int i = threadIdx.x; i < kBlockQ * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, c = i - r * kHeadDim;
    float val = 0.f;
    if (q0 + r < a.Lq && c < a.D) val = to_f(qp[(q0 + r) * a.ql + c]);
    sQ[r * kLdQ + c] = val;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < a.Lkv; k0 += kBlockK) {
    __syncthreads();  // sQ staged; the previous tile's readers are done
    for (int i = threadIdx.x; i < kBlockK * kHeadDim; i += kThreads) {
      const int r = i / kHeadDim, c = i - r * kHeadDim;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < a.Lkv && c < a.D) {
        kv = to_f(kp[key * a.kl + c]);
        vv = to_f(vp[key * a.vl + c]);
      }
      sK[c * kLdK + r] = kv;
      sV[r * kHeadDim + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < kHeadDim; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * kLdQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[d * kLdK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float sc = -INFINITY;  // past Lkv: not a key at all
        if (key < a.Lkv) {
          sc = s[i][j] * a.scale;
          bool ok = !a.causal || key < a.prefix_len || key <= qi;
          if (mask != nullptr) ok = ok && mask[key] != 0;
          if (!ok) sc = kMasked;
        }
        s[i][j] = sc;
        mx = fmaxf(mx, sc);
      }
      // the tile holds at least one key below Lkv, so m_new is finite
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pa[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sP[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vb[j] = sV[kk * kHeadDim + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.Lq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c < a.D) op[qi * a.ol + c] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  cudaFuncSetAttribute(attention_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes());
  const dim3 grid((a.Lq + kBlockQ - 1) / kBlockQ, B * a.H);
  attention_kernel<T><<<grid, kThreads, smem_bytes(), stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int B, int dtype, void* stream) {
  if (a.D < 1 || a.D > kHeadDim || a.Lkv < 1 || (long long)B * a.H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, B, s);
  return launch<float>(a, B, s);
}

}  // namespace
}  // namespace rtvc

// q/k/v/out indexed [b, h, row, d] through the given element strides (d
// contiguous); kv_mask [B, Lkv] bytes or null.
extern "C" int rtvc_flash_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* kv_mask, int B, int H, int Lq, int Lkv, int D, long long qb,
    long long qh, long long ql, long long kb, long long kh, long long kl,
    long long vb, long long vh, long long vl, long long ob, long long oh,
    long long ol, float scale, int causal, int prefix_len, int dtype,
    void* stream) {
  const rtvc::Args a{q, k, v, out, static_cast<const uint8_t*>(kv_mask),
                     H, Lq, Lkv, D, qb, qh, ql, kb, kh, kl, vb, vh, vl,
                     ob, oh, ol, scale, causal, prefix_len};
  return rtvc::dispatch(a, B, dtype, stream);
}

// q/k/v [B, L, H, D] views (strides per batch, row and head; d contiguous),
// out [B, L, H, D] contiguous; no mask.
extern "C" int rtvc_blhd_attention(
    const void* q, const void* k, const void* v, void* out, int B, int L,
    int H, int D, long long qb, long long ql, long long qh, long long kb,
    long long kl, long long kh, long long vb, long long vl, long long vh,
    float scale, int dtype, void* stream) {
  const long long ol = (long long)H * D;
  const rtvc::Args a{q, k, v, out, nullptr, H, L, L, D, qb, qh, ql, kb, kh,
                     kl, vb, vh, vl, (long long)L * ol, D, ol, scale, 0, 0};
  return rtvc::dispatch(a, B, dtype, stream);
}
