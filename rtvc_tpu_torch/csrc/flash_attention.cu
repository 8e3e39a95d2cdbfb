// K4: fused multi-head attention (flash forward) with in-kernel dropout,
// K5: BLHD attention, and K8: the flash backward.
//
// K4 replaces the Pallas kernel rtvc_tpu/ops/attention.py _pallas_attention
// (kernel bodies _make_kernel / _block_probs, native_score_dot and
// softmax_native off):
//   out = drop(softmax(mask(q k^T * scale))) v   per (batch, head),
// with float32 score products, the prefix-causal mask k < P or k <= q built
// from indices, an optional [B, Lkv] key mask, masked scores set to the
// finite sentinel -1e30 (a row whose keys are all masked averages V
// uniformly, as the TPU kernel does, instead of giving NaN), float32
// probabilities times float32 V, and the output in the input dtype. Dropout
// keeps a probability where dropout_bits(seed, b, h, row, key) >= thresh
// and divides it by keep = 1 - rate; the softmax normaliser still sums
// every key, kept or dropped, as the TPU kernel's does. It serves the GIT
// joint attention ([8, 12, 1582, 64], prefix 1542) and the beam's visual
// prefill ([B * beams, 12, 1542, 64], every key visible).
//
// The forward kernel below serves float32 inputs only: both entry points
// hand bfloat16 calls to the tensor-core kernel of
// flash_attention_sm90.cu, which computes the same function.
//
// K5 replaces rtvc_tpu/ops/attention.py blhd_attention (_make_blhd_kernel):
// the same arithmetic with no mask, reading q/k/v in place from the QKV
// GEMM's [B, L, H, D] view through strides and writing [B, L, H, D], so no
// head transpose is copied around it. It serves the CLIP tower's 24
// attention layers ([B * 6, 257, 16, 64]). For float32, both entry points
// run the one forward kernel below; only their strides and masks differ.
//
// What bounds the forward on an H100: float32 arithmetic. The TPU kernel
// holds one head's whole K and V in VMEM (1582 x 64 x 4 B each); a block's
// shared memory cannot, so K and V stream through it in 64-key tiles with
// an online softmax (running float32 max and sum per row, rescaling the
// accumulator when the max grows). The products stay in float32 on the
// CUDA cores, as the TPU kernel's f32 dots are: TF32 tensor cores would
// round float32 inputs, and no tensor-core product is exact for them (bf16
// inputs are exact in a bf16 product). A block of 256 threads owns
// 64 query rows; thread (ty, tx) holds the scores and output columns
// tx + 16 j of rows ty + 16 i in registers (a 4 x 4 register tile: 16 FMAs
// per 8 shared-memory loads). K is staged transposed and every tile row is
// padded by one float, so the loads are free of bank conflicts. Probabilities
// go through shared memory to the P.V product. Keys past Lkv contribute
// nothing; masked keys contribute exp(-1e30 - max), which is 0 unless the
// whole row is masked.
//
// K8 replaces rtvc_tpu/ops/attention.py _pallas_attention_bwd
// (_make_bwd_kernel): dQ, dK, dV of the forward above for the output
// gradient dO, with P recomputed from Q and K, the kept mask recovered as
// drop(P) > 0 from the same hash (no mask tensor), dP = dO V^T (divided by
// keep where kept, 0 where dropped), dS = P o (dP - rowsum(P o dP)), float32
// accumulation, and the gradients written in the input dtype. The TPU
// kernel accumulates dK/dV in a VMEM block revisited by the sequential
// q-block axis; blocks of a GPU grid run in no order, so the backward is two
// kernels, deterministic and free of atomics:
//   1. per 64-row q block: one sweep over the keys for the row max and the
//      normaliser z, one for Delta = rowsum(P o dP) from the recomputed P
//      and dP (as JAX takes it; dO.O would use the rounded O), one for
//      dQ = dS K * scale; (max, z, Delta) per row go to a float32 scratch;
//   2. per 64-key block: a loop over the q blocks that rebuilds P and dS
//      from those row statistics and accumulates dV += drop(P)^T dO and
//      dK += dS^T Q * scale in registers.
// Bound on an H100: float32 CUDA-core FMAs again, ten 64-deep products per
// (row, key) against the forward's two; the tiles and the padded
// conflict-free shared-memory layout are the forward's. These two kernels
// serve float32 inputs only: the entry point hands bfloat16 calls to the
// tensor-core kernels of flash_attention_bwd_sm90.cu, which compute the
// same function.

#include "common.cuh"
#include "flash_attention_sm90.cuh"

namespace rtvc {
namespace {

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per shared-memory tile
constexpr int kHeadDim = 64;   // largest D; smaller D is zero-padded
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLd = kHeadDim + 1;  // padded row of every [64][64] tile
constexpr float kMasked = -1e30f;

constexpr size_t fwd_smem_bytes() {  // sQ, sK^T, sV, sP
  return (size_t)(3 * kBlockQ * kLd + kBlockK * kHeadDim) * sizeof(float);
}
constexpr size_t dq_smem_bytes() {  // sQ, sG, sK^T, sV^T, sP
  return (size_t)(5 * kBlockQ * kLd) * sizeof(float);
}
constexpr size_t dkv_smem_bytes() {  // sK, sV, sQ^T, sG^T, sPu, sDs, stats
  return (size_t)(6 * kBlockQ * kLd + 3 * kBlockQ) * sizeof(float);
}

struct Dropout {
  uint32_t seed, thresh;
  float keep;  // 1 - rate
  int on;
};

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
  Dropout drop;
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;  // dO
  void* dq;       // [B, H, Lq, D] contiguous
  void* dk;       // [B, H, Lkv, D] contiguous
  void* dv;
  float* stats;   // [3, B * H * Lq]: row max, z, Delta
  const uint8_t* kv_mask;
  int H, Lq, Lkv, D;
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, gb, gh, gl;
  float scale;
  int causal, prefix_len;
  Dropout drop;
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

// The score of (row, key) from its raw dot product, as _block_probs makes
// it: scaled; -1e30 where the mask forbids the key; -inf past Lkv (not a
// key at all).
__device__ __forceinline__ float score(float dot, int row, int key, int lkv,
                                       float scale, int causal,
                                       int prefix_len, const uint8_t* mask) {
  if (key >= lkv) return -INFINITY;
  bool ok = !causal || key < prefix_len || key <= row;
  if (mask != nullptr) ok = ok && mask[key] != 0;
  return ok ? dot * scale : kMasked;
}

// drop(p): p / keep where the hash keeps (row, key), 0 where it drops it
__device__ __forceinline__ float dropped(float p, const Dropout& d, int b,
                                         int h, int row, int key) {
  if (!d.on) return p;
  return dropout_bits(d.seed, b, h, row, key) >= d.thresh ? p / d.keep : 0.f;
}

// acc[i][j] += sum_d A[(ty + 16 i) * lda + d] * B(d, tx + 16 j) over
// d < 64, B(d, c) = B[d * ldb + c], or B[c * ldb + d] when kBT.
template <bool kBT>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         int lda, const float* B, int ldb,
                                         int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < kHeadDim; ++d) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      bv[j] = kBT ? B[c * ldb + d] : B[d * ldb + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&t)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) t[i][j] = 0.f;
  }
}

// rows [r0, r0 + 64) of a strided [rows, D] matrix into shared memory as
// float32, zero past n_rows and D: row-major s[r * kLd + c], or transposed
// s[c * kLd + r] when kT
template <bool kT, typename T>
__device__ __forceinline__ void stage(float* s, const T* src, long long ld,
                                      int r0, int n_rows, int D) {
  for (int i = threadIdx.x; i < kBlockQ * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, c = i - r * kHeadDim;
    float val = 0.f;
    if (r0 + r < n_rows && c < D) val = to_f(src[(r0 + r) * ld + c]);
    s[kT ? c * kLd + r : r * kLd + c] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_kernel(Args a) {
  extern __shared__ float smem[];
  float* sQ = smem;                      // [kBlockQ][kLd]
  float* sK = sQ + kBlockQ * kLd;        // [kHeadDim][kLd], transposed
  float* sP = sK + kHeadDim * kLd;       // [kBlockQ][kLd]
  float* sV = sP + kBlockQ * kLd;        // [kBlockK][kHeadDim]
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

  stage<false>(sQ, qp, a.ql, q0, a.Lq, a.D);

  float m[4], l[4], acc[4][4];
  zero(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int k0 = 0; k0 < a.Lkv; k0 += kBlockK) {
    __syncthreads();  // sQ staged; the previous tile's readers are done
    stage<true>(sK, kp, a.kl, k0, a.Lkv, a.D);
    for (int i = threadIdx.x; i < kBlockK * kHeadDim; i += kThreads) {
      const int r = i / kHeadDim, c = i - r * kHeadDim;
      sV[i] = (k0 + r < a.Lkv && c < a.D) ? to_f(vp[(k0 + r) * a.vl + c])
                                          : 0.f;
    }
    __syncthreads();

    float s[4][4];
    zero(s);
    tile_dot<false>(s, sQ, kLd, sK, kLd, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(s[i][j], qi, k0 + tx + 16 * j, a.Lkv, a.scale,
                        a.causal, a.prefix_len, mask);
        mx = fmaxf(mx, s[i][j]);
      }
      // the tile holds at least one key below Lkv, so m_new is finite
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * kLd + tx + 16 * j] =
            dropped(p, a.drop, b, h, qi, k0 + tx + 16 * j);
        ps += p;  // z sums every key, kept or dropped
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    tile_dot<false>(acc, sP, kLd, sV, kHeadDim, ty, tx);
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

// K8, kernel 1: one block per (64 query rows, batch x head)
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(
    BwdArgs a) {
  extern __shared__ float smem[];
  float* sQ = smem;                 // [kBlockQ][kLd]
  float* sG = sQ + kBlockQ * kLd;   // [kBlockQ][kLd]
  float* sK = sG + kBlockQ * kLd;   // [kHeadDim][kLd], transposed
  float* sV = sK + kHeadDim * kLd;  // [kHeadDim][kLd], transposed
  float* sP = sV + kHeadDim * kLd;  // [kBlockQ][kLd]: dS of the tile
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int q0 = blockIdx.x * kBlockQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* qp = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + h * a.kh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + h * a.vh;
  const T* gp = static_cast<const T*>(a.g) + b * a.gb + h * a.gh;
  const uint8_t* mask =
      a.kv_mask == nullptr ? nullptr : a.kv_mask + (size_t)b * a.Lkv;

  stage<false>(sQ, qp, a.ql, q0, a.Lq, a.D);
  stage<false>(sG, gp, a.gl, q0, a.Lq, a.D);

  // sweep 1: the row max m and the normaliser z over all keys
  float m[4], z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    z[i] = 0.f;
  }
  for (int k0 = 0; k0 < a.Lkv; k0 += kBlockK) {
    __syncthreads();
    stage<true>(sK, kp, a.kl, k0, a.Lkv, a.D);
    __syncthreads();
    float s[4][4];
    zero(s);
    tile_dot<false>(s, sQ, kLd, sK, kLd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(s[i][j], qi, k0 + tx + 16 * j, a.Lkv, a.scale,
                        a.causal, a.prefix_len, mask);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float es = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) es += expf(s[i][j] - m_new);
      z[i] = z[i] * expf(m[i] - m_new) + row_sum(es);
      m[i] = m_new;
    }
  }

  // sweeps 2 and 3: Delta = rowsum(P o dP), then dQ = dS K
  float delta[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][4];
  zero(acc);
  for (int sweep = 2; sweep <= 3; ++sweep) {
    for (int k0 = 0; k0 < a.Lkv; k0 += kBlockK) {
      __syncthreads();
      stage<true>(sK, kp, a.kl, k0, a.Lkv, a.D);
      stage<true>(sV, vp, a.vl, k0, a.Lkv, a.D);
      __syncthreads();
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      tile_dot<false>(s, sQ, kLd, sK, kLd, ty, tx);
      tile_dot<false>(dp, sG, kLd, sV, kLd, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          const float p = expf(score(s[i][j], qi, key, a.Lkv, a.scale,
                                     a.causal, a.prefix_len, mask) -
                               m[i]) / z[i];
          float d = dp[i][j];
          if (a.drop.on)
            d = dropped(p, a.drop, b, h, qi, key) > 0.f ? d / a.drop.keep
                                                         : 0.f;
          if (sweep == 2) {
            delta[i] += p * d;
          } else {
            sP[(ty + 16 * i) * kLd + tx + 16 * j] = p * (d - delta[i]);
          }
        }
      }
      if (sweep == 3) {
        __syncthreads();
        tile_dot<true>(acc, sP, kLd, sK, kLd, ty, tx);  // dS (tile) x K
      }
    }
    if (sweep == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) delta[i] = row_sum(delta[i]);
    }
  }

  T* dqp = static_cast<T*>(a.dq) + ((size_t)b * a.H + h) * a.Lq * a.D;
  const size_t rows = (size_t)gridDim.y * a.Lq;
  float* stat = a.stats + ((size_t)b * a.H + h) * a.Lq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c < a.D) dqp[(size_t)qi * a.D + c] = from_f<T>(acc[i][j] * a.scale);
    }
    if (tx == 0) {
      stat[qi] = m[i];
      stat[rows + qi] = z[i];
      stat[2 * rows + qi] = delta[i];
    }
  }
}

// K8, kernel 2: one block per (64 keys, batch x head); thread (ty, tx)
// holds dK and dV of keys ty + 16 i, columns tx + 16 j
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkv_kernel(
    BwdArgs a) {
  extern __shared__ float smem[];
  float* sK = smem;                  // [kBlockK][kLd]
  float* sV = sK + kBlockK * kLd;    // [kBlockK][kLd]
  float* sQ = sV + kBlockK * kLd;    // [kHeadDim][kLd], transposed
  float* sG = sQ + kHeadDim * kLd;   // [kHeadDim][kLd], transposed
  float* sPu = sG + kHeadDim * kLd;  // [kBlockK][kLd]: drop(P)^T
  float* sDs = sPu + kBlockK * kLd;  // [kBlockK][kLd]: dS^T
  float* sStat = sDs + kBlockK * kLd;  // [3][kBlockQ]: m, z, Delta
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int k0 = blockIdx.x * kBlockK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* qp = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + h * a.kh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + h * a.vh;
  const T* gp = static_cast<const T*>(a.g) + b * a.gb + h * a.gh;
  const uint8_t* mask =
      a.kv_mask == nullptr ? nullptr : a.kv_mask + (size_t)b * a.Lkv;
  const size_t rows = (size_t)gridDim.y * a.Lq;
  const float* stat = a.stats + ((size_t)b * a.H + h) * a.Lq;

  stage<false>(sK, kp, a.kl, k0, a.Lkv, a.D);
  stage<false>(sV, vp, a.vl, k0, a.Lkv, a.D);

  float dk[4][4], dv[4][4];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < a.Lq; q0 += kBlockQ) {
    __syncthreads();
    stage<true>(sQ, qp, a.ql, q0, a.Lq, a.D);
    stage<true>(sG, gp, a.gl, q0, a.Lq, a.D);
    for (int r = threadIdx.x; r < kBlockQ; r += kThreads) {
      const bool in = q0 + r < a.Lq;
      sStat[r] = in ? stat[q0 + r] : 0.f;
      sStat[kBlockQ + r] = in ? stat[rows + q0 + r] : 1.f;
      sStat[2 * kBlockQ + r] = in ? stat[2 * rows + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];  // [key i][row j] of the tile
    zero(s);
    zero(dp);
    tile_dot<false>(s, sK, kLd, sQ, kLd, ty, tx);
    tile_dot<false>(dp, sV, kLd, sG, kLd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, qi = q0 + r;
        float p = 0.f, pu = 0.f, ds = 0.f;
        if (qi < a.Lq) {  // rows past Lq add nothing
          p = expf(score(s[i][j], qi, key, a.Lkv, a.scale, a.causal,
                         a.prefix_len, mask) -
                   sStat[r]) / sStat[kBlockQ + r];
          pu = dropped(p, a.drop, b, h, qi, key);
          float d = dp[i][j];
          if (a.drop.on) d = pu > 0.f ? d / a.drop.keep : 0.f;
          ds = p * (d - sStat[2 * kBlockQ + r]);
        }
        sPu[(ty + 16 * i) * kLd + r] = pu;
        sDs[(ty + 16 * i) * kLd + r] = ds;
      }
    }
    __syncthreads();
    tile_dot<true>(dv, sPu, kLd, sG, kLd, ty, tx);  // drop(P)^T dO
    tile_dot<true>(dk, sDs, kLd, sQ, kLd, ty, tx);  // dS^T Q
  }

  const size_t base = ((size_t)b * a.H + h) * a.Lkv * a.D;
  T* dkp = static_cast<T*>(a.dk) + base;
  T* dvp = static_cast<T*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Lkv) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c < a.D) {
        dkp[(size_t)key * a.D + c] = from_f<T>(dk[i][j] * a.scale);
        dvp[(size_t)key * a.D + c] = from_f<T>(dv[i][j]);
      }
    }
  }
}

bool bad_shape(int B, int H, int D, int Lq, int Lkv) {
  return D < 1 || D > kHeadDim || Lq < 1 || Lkv < 1 ||
         (long long)B * H > 65535;
}

template <typename T>
int forward(const Args& a, int B, cudaStream_t stream) {
  cudaFuncSetAttribute(attention_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)fwd_smem_bytes());
  const dim3 grid((a.Lq + kBlockQ - 1) / kBlockQ, B * a.H);
  attention_kernel<T><<<grid, kThreads, fwd_smem_bytes(), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const BwdArgs& a, int B, cudaStream_t stream) {
  cudaFuncSetAttribute(attention_bwd_dq_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)dq_smem_bytes());
  cudaFuncSetAttribute(attention_bwd_dkv_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)dkv_smem_bytes());
  const dim3 grid_q((a.Lq + kBlockQ - 1) / kBlockQ, B * a.H);
  attention_bwd_dq_kernel<T>
      <<<grid_q, kThreads, dq_smem_bytes(), stream>>>(a);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid_k((a.Lkv + kBlockK - 1) / kBlockK, B * a.H);
  attention_bwd_dkv_kernel<T>
      <<<grid_k, kThreads, dkv_smem_bytes(), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rtvc

// q/k/v/out indexed [b, h, row, d] through the given element strides (d
// contiguous); kv_mask [B, Lkv] bytes or null; dropout on when `dropout`;
// `native` (bfloat16 only) takes the input-dtype softmax, K4n.
extern "C" int rtvc_flash_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* kv_mask, int B, int H, int Lq, int Lkv, int D, long long qb,
    long long qh, long long ql, long long kb, long long kh, long long kl,
    long long vb, long long vh, long long vl, long long ob, long long oh,
    long long ol, float scale, int causal, int prefix_len, unsigned seed,
    unsigned thresh, float keep, int dropout, int native, int dtype,
    void* stream) {
  if (rtvc::bad_shape(B, H, D, Lq, Lkv)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16) {
    const rtvc::Sm90Attention a{
        q, k, v, out, static_cast<const uint8_t*>(kv_mask), B, H, Lq, Lkv, D,
        qb, qh, ql, kb, kh, kl, vb, vh, vl, ob, oh, ol, scale, causal,
        prefix_len, seed, thresh, keep, dropout, native};
    return rtvc::attention_sm90(a, s);
  }
  // the input-dtype softmax is a no-op for float32 (the wrapper demotes it)
  if (native) return (int)cudaErrorInvalidValue;
  const rtvc::Args a{q, k, v, out, static_cast<const uint8_t*>(kv_mask),
                     H, Lq, Lkv, D, qb, qh, ql, kb, kh, kl, vb, vh, vl,
                     ob, oh, ol, scale, causal, prefix_len,
                     {seed, thresh, keep, dropout}};
  return rtvc::forward<float>(a, B, s);
}

// q/k/v [B, L, H, D] views (strides per batch, row and head; d contiguous),
// out [B, L, H, D] contiguous; no mask, no dropout.
extern "C" int rtvc_blhd_attention(
    const void* q, const void* k, const void* v, void* out, int B, int L,
    int H, int D, long long qb, long long ql, long long qh, long long kb,
    long long kl, long long kh, long long vb, long long vl, long long vh,
    float scale, int dtype, void* stream) {
  if (rtvc::bad_shape(B, H, D, L, L)) return (int)cudaErrorInvalidValue;
  const long long ol = (long long)H * D;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16) {
    const rtvc::Sm90Attention a{
        q, k, v, out, nullptr, B, H, L, L, D, qb, qh, ql, kb, kh, kl, vb, vh,
        vl, (long long)L * ol, D, ol, scale, 0, 0, 0u, 0u, 1.f, 0, 0};
    return rtvc::attention_sm90(a, s);
  }
  const rtvc::Args a{q, k, v, out, nullptr, H, L, L, D, qb, qh, ql, kb, kh,
                     kl, vb, vh, vl, (long long)L * ol, D, ol, scale, 0, 0,
                     {0u, 0u, 1.f, 0}};
  return rtvc::forward<float>(a, B, s);
}

// K8: q/k/v/g indexed [b, h, row, d] through element strides (d
// contiguous); dq [B, H, Lq, D] and dk/dv [B, H, Lkv, D] contiguous in the
// input dtype; stats a float32 scratch of 3 * B * H * ceil(Lq / 64) * 64
// values. bfloat16 calls go to the tensor-core kernels of
// flash_attention_bwd_sm90.cu (K8n with `native`), float32 calls to the
// two kernels above.
extern "C" int rtvc_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* g, void* dq,
    void* dk, void* dv, void* stats, const void* kv_mask, int B, int H,
    int Lq, int Lkv, int D, long long qb, long long qh, long long ql,
    long long kb, long long kh, long long kl, long long vb, long long vh,
    long long vl, long long gb, long long gh, long long gl, float scale,
    int causal, int prefix_len, unsigned seed, unsigned thresh, float keep,
    int dropout, int native, int dtype, void* stream) {
  if (rtvc::bad_shape(B, H, D, Lq, Lkv)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16) {
    const rtvc::Sm90AttentionBwd a{
        q, k, v, g, dq, dk, dv, static_cast<float*>(stats),
        static_cast<const uint8_t*>(kv_mask), B, H, Lq, Lkv, D, qb, qh, ql,
        kb, kh, kl, vb, vh, vl, gb, gh, gl, scale, causal, prefix_len, seed,
        thresh, keep, dropout, native};
    return rtvc::attention_bwd_sm90(a, s);
  }
  if (native) return (int)cudaErrorInvalidValue;
  const rtvc::BwdArgs a{q, k, v, g, dq, dk, dv, static_cast<float*>(stats),
                        static_cast<const uint8_t*>(kv_mask), H, Lq, Lkv, D,
                        qb, qh, ql, kb, kh, kl, vb, vh, vl, gb, gh, gl,
                        scale, causal, prefix_len,
                        {seed, thresh, keep, dropout}};
  return rtvc::backward<float>(a, B, s);
}
