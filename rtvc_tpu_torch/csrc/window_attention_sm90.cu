// K1 (TinyViT window attention with the learned relative-position bias)
// for bfloat16 inputs, on Hopper's tensor cores.
//
// Replaces, as window_attention.cu's float32 kernel does, the Pallas kernel
// rtvc_tpu/ops/attention.py _window_attention_fwd_pallas (kernel body
// _make_window_kernel), and computes its function exactly:
//   out = softmax(q k^T * scale + bias[h]) v   per (window, head),
// q/k/v [B*nW, H, N, 32] contiguous, bias [H, N, N] float32; float32 score
// products; with scores_in_input_dtype (the TinyViT mode) the scaled score
// and the bias are rounded to bfloat16 and so is their sum, else they add
// in float32; float32 max, exponentials and sum; the probabilities rounded
// to bfloat16 times V with float32 accumulation; the output bfloat16.
// The softmax is float32 where the TPU kernel's native mode takes max, exp,
// sum and divide in bf16 (rtvc_tpu/ops/attention.py:754-757): float32 is
// the more exact, and the TPU's own rounding of that arithmetic under
// --xla_allow_excess_precision is uncertain (:739-748). Against the JAX
// kernel it costs 6.2e-3 of max|out| at N = 196, 80% of the 2^-7 limit
// (window_attention_plain, tests/test_torch_ops.py).
//
// What bounds it on an H100: bytes. At stage 1 of a batch-8 caption step
// ([768, 6, 49, 32]) q, k, v and out are 57.8 MB, 17.3 us at 3.35 TB/s,
// against 1.4 GFLOP of products (1.4 us at the bf16 tensor-core peak). The
// float32 kernel ran the products on the CUDA cores, one query row per warp
// at a time, and restaged K and V as float32 for every chunk of rows.
// Design:
// - Products by mma.sync m16n8k16 (bf16 in, float32 accumulate): a warp
//   owns a strip of 16 query rows of one (window, head). S = Q K^T takes
//   D = 32 as two k-steps, Q and K fragments by ldmatrix (K rows, D
//   contiguous, are the "col" B layout). The S accumulator's fragment is
//   repacked in registers as P's bf16 A fragment (FlashAttention-2's
//   layout trick), and V comes by ldmatrix.trans as the B of P V. A bf16
//   P is exactly the A operand, so no hi/lo split is needed: both products
//   are exact up to the summation order. Not wgmma: its 64-row tiles and
//   asynchrony buy nothing when the tensor cores are < 10% busy at the
//   bound, and N = 49 fills a 64-row tile no better.
// - The whole score row stays in registers (no online softmax), so P is
//   normalised before it is rounded, as the TPU kernel does: 16 x 16
//   kChunks scores a strip (kChunks = 4 at N = 49, 13 at N = 196). In the
//   native mode with the bias in shared memory (below) a score is a bf16
//   value and is held as packed bf16 pairs, 4 kChunks registers a thread
//   where float32 takes 8 kChunks; each exponential is then taken twice,
//   for the sum and for P.
// - A block owns one head and has one warp per strip of 16 query rows (4
//   warps at N = 49, 13 at N = 196), so a window's strips run side by
//   side and batch 1 (6 windows x 12 heads at stage 2) still fills the
//   card. In the native mode the block first copies its head's bias into
//   shared memory as bf16, which that mode rounds it to anyway (9.6 KB of
//   float32 at stage 1, 153.7 KB at stage 2; rows padded so a read of 8
//   rows' key pairs hits distinct banks), with 16 independent loads a
//   thread in flight. Read from L2 per window instead, the bias is about
//   as many bytes as q, k and v at stage 1 and 4x theirs at stage 2, and a
//   strip's 104 loads a lane at N = 196 form a chain of L2 round trips.
//   The copy pays only where a block walks two windows or more (batch 8,
//   not batch 1: on an H100 stage 2 at batch 1 takes 15.8 us reading the
//   bias from L2 and 20.1 us copying it first, PERF.md section 6) and fits
//   only up to N = 208; elsewhere, and without the native mode (no
//   default path), the bias is read from L2.
// - Persistent blocks with a two-stage ring: about (SMs x blocks per SM)
//   blocks walk their head's windows gridDim.x apart; the copies of the
//   next window fly while the current one computes.
// - Loads by cp.async in 16-byte pieces: a window's Q, K and V (N x 64 B
//   each, one contiguous run) go into shared memory rows of 64 B whose
//   16-byte chunks are XOR-swizzled by row, so ldmatrix reads are free of
//   bank conflicts. Rows past N are zero-filled by the copy (src-size 0):
//   a key past N scores -inf and gets P = 0, but 0 x NaN from stale shared
//   memory would be NaN.
// - Epilogue: each warp writes its 16 x 32 output strip into its own rows
//   of the Q tile it no longer needs, then stores the rows < N in 16-byte
//   pieces (64 B per row).

#include "common.cuh"
#include "flash_attention_sm90.cuh"  // smem_u32, pack_bf16, unpack_bf16, ex2
#include "window_attention_sm90.cuh"

namespace rtvc {
namespace {

constexpr int kD = 32;             // the only head dim TinyViT uses
constexpr int kRowBytes = kD * 2;  // 64 B: four 16-byte chunks

// byte offset of 16-byte chunk c (0-3) of row r in a swizzled [rows][64 B]
// tile: 8 consecutive rows' chunk c land in 8 distinct 16-byte bank groups
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kRowBytes + ((c ^ ((r >> 1) & 3)) << 4);
}

// 16 bytes global -> shared; zero-filled where !valid (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group (the next window's) is in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += A B, m16 n8 k16, bf16 operands, float32 accumulator
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr uint32_t kNegInf2 = 0xff80ff80u;  // bf16 (-inf, -inf)
constexpr float kLog2e = 1.4426950408889634f;

// the larger of each half of two packed bf16 pairs
__device__ __forceinline__ uint32_t hmax2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Row stride, in bf16 elements, of the head's bias copy in shared memory:
// 16 kChunks keys plus 8, so that the 8 rows of one read of a key pair hit
// distinct banks
template <int kChunks>
__host__ __device__ constexpr int bias_stride() {
  return 16 * kChunks + 8;
}

// The bias of (row, key) and (row, key + 1) as floats, rounded to bf16 in
// the native mode: from the head's bf16 copy in shared memory (kStaged),
// or from the float32 tensor in L2, where a key past N reads key N - 1
// (the caller masks it)
template <int kChunks, bool kNative, bool kStaged>
__device__ __forceinline__ float2 bias_pair(const float* __restrict__ bias_h,
                                            const __nv_bfloat16* sB, int row,
                                            int key, int N) {
  if constexpr (kStaged) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        sB + row * bias_stride<kChunks>() + key));
  } else {
    const float* p = bias_h + row * N;
    const float2 b = make_float2(__ldg(p + min(key, N - 1)),
                                 __ldg(p + min(key + 1, N - 1)));
    if constexpr (kNative) {
      return make_float2(round_to<__nv_bfloat16>(b.x),
                         round_to<__nv_bfloat16>(b.y));
    } else {
      return b;
    }
  }
}

// The head's [N, N] float32 bias into shared memory as bf16 rows of
// 16 kChunks keys (zero past N), 16 independent loads a thread in flight
template <int kChunks>
__device__ __forceinline__ void stage_bias(__nv_bfloat16* sB,
                                           const float* __restrict__ bias_h,
                                           int N) {
  constexpr int kWidth = 16 * kChunks, kBatch = 16;
  const int total = N * kWidth;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    float val[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x, r = i / kWidth, c = i - r * kWidth;
      val[u] = i < total && c < N ? __ldg(bias_h + r * N + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x, r = i / kWidth, c = i - r * kWidth;
      if (i < total)
        sB[r * bias_stride<kChunks>() + c] = __float2bfloat16(val[u]);
    }
  }
}

// One warp: query rows r0 + [0, 16) of the window whose Q, K and V tiles
// are at sQ, sK, sV; output to op ([N, 32] bf16). Lane (g, t) = (lane / 4,
// lane % 4) holds rows r0 + g and r0 + g + 8, keys 8 j + 2 t and + 1 of
// each 8-key group j (the m16n8 accumulator layout). With kStaged the
// scores are held as packed bf16 pairs (52 registers at N = 196 instead of
// 104) and each exponential is taken twice, for the sum and for P.
template <int kChunks, bool kNative, bool kStaged>
__device__ __forceinline__ void attend_strip(
    uint32_t sQ, uint32_t sK, uint32_t sV, const __nv_bfloat16* sB,
    const float* __restrict__ bias_h, __nv_bfloat16* op, int r0, int N,
    float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // Q's A fragments for the two 16-column k-steps: lanes 0-7 address rows
  // 0-7, 8-15 rows 8-15 (chunk 2 ks), 16-31 the same rows' next chunk
  uint32_t qa[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldmatrix_x4(qa[ks], sQ + swz(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 2 * ks + (lane >> 4)));

  // S = Q K^T: per 8-key group, one ldmatrix of its 8 rows x 4 chunks
  // gives the B fragments of both k-steps; then the scores: scaled,
  // biased (rounded to bf16 in the native mode), -inf past N. Rows past N
  // read row N - 1's bias and are never stored.
  const int rows[2] = {min(r0 + g, N - 1), min(r0 + g + 8, N - 1)};
  // the staged native kernel holds the scores as packed bf16 pairs; the
  // others as float32 (packed, the kernel that reads the bias from L2
  // spilled at N = 196)
  constexpr bool kPacked = kStaged;
  float s[kPacked ? 1 : 2 * kChunks][4];    // float32 scores
  uint32_t sp[kPacked ? 2 * kChunks : 1][2];  // packed bf16 scores
  float mx[2] = {-INFINITY, -INFINITY};
  uint32_t mxp[2] = {kNegInf2, kNegInf2};  // packed running max
#pragma unroll
  for (int j = 0; j < 2 * kChunks; ++j) {
    uint32_t kb[4];
    ldmatrix_x4(kb, sK + swz(8 * j + (lane & 7), lane >> 3));
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma16816(c, qa[0], kb[0], kb[1]);
    mma16816(c, qa[1], kb[2], kb[3]);
    const int key = 8 * j + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 b =
          bias_pair<kChunks, kNative, kStaged>(bias_h, sB, rows[hf], key, N);
      if constexpr (kPacked) {
        // both scaled scores rounded to bf16 by one instruction, their sums
        // with the bias (a bf16 value already) by another; the max taken on
        // the packed pair
        const float2 a =
            unpack_bf16(pack_bf16(c[2 * hf] * scale, c[2 * hf + 1] * scale));
        uint32_t x = pack_bf16(a.x + b.x, a.y + b.y);
        if (key >= N) x = (x & 0xffff0000u) | (kNegInf2 & 0xffffu);
        if (key + 1 >= N) x = (x & 0xffffu) | (kNegInf2 & 0xffff0000u);
        sp[j][hf] = x;
        mxp[hf] = hmax2(mxp[hf], x);
      } else {
        float x0 = c[2 * hf] * scale, x1 = c[2 * hf + 1] * scale;
        if constexpr (kNative) {
          x0 = round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(x0) + b.x);
          x1 = round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(x1) + b.y);
        } else {
          x0 += b.x;
          x1 += b.y;
        }
        x0 = key < N ? x0 : -INFINITY;
        x1 = key + 1 < N ? x1 : -INFINITY;
        s[j][2 * hf] = x0;
        s[j][2 * hf + 1] = x1;
        mx[hf] = fmaxf(mx[hf], fmaxf(x0, x1));
      }
    }
  }
  if constexpr (kPacked) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 m = unpack_bf16(mxp[hf]);
      mx[hf] = fmaxf(m.x, m.y);
    }
  }
  // the four lanes of a row hold its keys: reduce across them
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    inv[i] = 0.f;
  }
  // e = exp(x - max) = 2^(x log2(e) - max log2(e)) of 8-key group j, row
  // half hf
  const float m2[2] = {mx[0] * kLog2e, mx[1] * kLog2e};
  auto ex = [&](int j, int hf) -> float2 {
    float2 x;
    if constexpr (kPacked) {
      x = unpack_bf16(sp[j][hf]);
    } else {
      x = make_float2(s[j][2 * hf], s[j][2 * hf + 1]);
    }
    return make_float2(ex2(fmaf(x.x, kLog2e, -m2[hf])),
                       ex2(fmaf(x.y, kLog2e, -m2[hf])));
  };
#pragma unroll
  for (int j = 0; j < 2 * kChunks; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 e = ex(j, hf);
      inv[hf] += e.x + e.y;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    inv[i] += __shfl_xor_sync(0xffffffffu, inv[i], 1);
    inv[i] += __shfl_xor_sync(0xffffffffu, inv[i], 2);
    inv[i] = 1.f / inv[i];
  }

  // O = P V over 4 column groups of 8: P normalised and rounded to bf16 as
  // the A fragment of 16 keys (8-key groups 2 kk and 2 kk + 1); one
  // ldmatrix.trans gives the B fragments of two column groups
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < kChunks; ++kk) {
    uint32_t pa[4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 e = ex(2 * kk + u, hf);
        pa[2 * u + hf] = pack_bf16(e.x * inv[hf], e.y * inv[hf]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; n += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, sV + swz(16 * kk + (lane & 7) +
                                         ((lane >> 3) & 1) * 8,
                                     n + (lane >> 4)));
      mma16816(o[n], pa, vb[0], vb[1]);
      mma16816(o[n + 1], pa, vb[2], vb[3]);
    }
  }

  // epilogue: the strip through this warp's own Q rows, then 16-byte
  // stores of the rows < N
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t v = pack_bf16(o[n][2 * hf], o[n][2 * hf + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       sQ + swz(r0 + g + 8 * hf, n) + 4 * t),
                   "r"(v)
                   : "memory");
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 4; i += 32) {
    const int row = r0 + (i >> 2), c = i & 3;
    if (row < N) {
      uint4 val;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                   : "r"(sQ + swz(row, c))
                   : "memory");
      *reinterpret_cast<uint4*>(op + row * kD + c * 8) = val;
    }
  }
}

// kChunks 16-key chunks cover N: the tiles hold 16 kChunks rows, and the
// block has kChunks warps, one per strip of 16 query rows. Block (x, h)
// works on head h and walks windows x, x + gridDim.x, ...; with kStaged
// (native mode only) it first copies the head's bias into shared memory.
template <int kChunks, bool kNative, bool kStaged>
__global__ void __launch_bounds__(32 * kChunks) window_attention_sm90_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int windows, int H, int N,
    float scale) {
  static_assert(kNative || !kStaged, "the bias copy is bf16: native only");
  constexpr int kRows = 16 * kChunks;
  constexpr int kThreads = 32 * kChunks;
  constexpr uint32_t kTile = kRows * kRowBytes;
  constexpr uint32_t kStage = 3 * kTile;  // Q, K, V
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  // [N][bias_stride] bf16 after the two stages, with kStaged
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + 2 * kStage);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const size_t pair_elems = (size_t)N * kD;
  const float* bias_h = bias + (size_t)h * N * N;

  // window w's Q, K and V tiles into stage `st`, 16 bytes a thread per
  // step, neighbouring threads on neighbouring addresses; rows past N
  // zero-filled
  auto load = [&](int w, int st) {
    const size_t off = ((size_t)w * H + h) * pair_elems;
    const __nv_bfloat16* src[3] = {q + off, k + off, v + off};
    const uint32_t dst = base + st * kStage;
    for (int i = threadIdx.x; i < 3 * kRows * 4; i += kThreads) {
      const int m = i / (kRows * 4), rc = i - m * (kRows * 4);
      const int r = rc >> 2, c = rc & 3;
      const bool valid = r < N;
      cp_async16(dst + m * kTile + swz(r, c),
                 src[m] + (valid ? r * kD + c * 8 : 0), valid);
    }
  };

  int w = blockIdx.x;  // the grid's x never exceeds the windows
  load(w, 0);
  cp_async_commit();
  if constexpr (kStaged) stage_bias<kChunks>(sB, bias_h, N);
  for (int it = 0; w < windows; ++it, w += gridDim.x) {
    const int st = it & 1;
    if (w + (int)gridDim.x < windows) load(w + gridDim.x, st ^ 1);
    cp_async_commit();  // an empty group at the end keeps the count
    cp_async_wait1();
    __syncthreads();
    const uint32_t sQ = base + st * kStage;
    if (16 * warp < N)
      attend_strip<kChunks, kNative, kStaged>(
          sQ, sQ + kTile, sQ + 2 * kTile, sB, bias_h,
          out + ((size_t)w * H + h) * pair_elems, 16 * warp, N, scale, lane);
    __syncthreads();  // every warp is done with this stage
  }
}

template <int kChunks, bool kStaged>
constexpr int smem_bytes() {  // two stages, then the bias copy
  return 2 * 3 * 16 * kChunks * kRowBytes +
         (kStaged ? 16 * kChunks * bias_stride<kChunks>() * 2 : 0);
}

// blocks per SM of an instance, asked once (0 where it cannot launch)
template <int kChunks, bool kNative, bool kStaged>
int blocks_per_sm() {
  static const int n = [] {
    auto kernel = window_attention_sm90_kernel<kChunks, kNative, kStaged>;
    constexpr int smem = smem_bytes<kChunks, kStaged>();
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return 0;
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                  32 * kChunks, smem);
    return blocks;
  }();
  return n;
}

// blocks per head: enough to fill the card, at most one per window
int blocks_per_head(int per_sm, int windows, int H) {
  return min(windows, max(1, per_sm * device_sm_count() / H));
}

template <int kChunks, bool kNative, bool kStaged>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int windows, int H, int N, float scale, int per_head,
           cudaStream_t stream) {
  window_attention_sm90_kernel<kChunks, kNative, kStaged>
      <<<dim3(per_head, H), 32 * kChunks, smem_bytes<kChunks, kStaged>(),
         stream>>>(static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v),
                   static_cast<const float*>(bias),
                   static_cast<__nv_bfloat16*>(out), windows, H, N, scale);
  return (int)cudaGetLastError();
}

// The native mode copies the bias into shared memory where a block walks
// at least two windows (the copy costs more than it saves on one: +0.5 to
// +4.3 us at the batch-1 stages) and where the copy fits (N <= 208)
template <int kChunks, bool kNative>
int launch_chunks(const void* q, const void* k, const void* v,
                  const void* bias, void* out, int windows, int H, int N,
                  float scale, cudaStream_t stream) {
  if constexpr (kNative && kChunks <= 13) {
    const int staged = blocks_per_sm<kChunks, true, true>();
    const int per_head = blocks_per_head(staged, windows, H);
    if (staged > 0 && windows >= 2 * per_head)
      return launch<kChunks, true, true>(q, k, v, bias, out, windows, H, N,
                                         scale, per_head, stream);
  }
  const int per_sm = blocks_per_sm<kChunks, kNative, false>();
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  return launch<kChunks, kNative, false>(
      q, k, v, bias, out, windows, H, N, scale,
      blocks_per_head(per_sm, windows, H), stream);
}

template <bool kNative>
int dispatch(const void* q, const void* k, const void* v, const void* bias,
             void* out, int windows, int H, int N, float scale,
             cudaStream_t stream) {
  const int chunks = (N + 15) / 16;
#define RTVC_K1_CASE(c)                                                   \
  if (chunks <= c)                                                        \
    return launch_chunks<c, kNative>(q, k, v, bias, out, windows, H, N,  \
                                     scale, stream);
  RTVC_K1_CASE(4)  // N <= 64: TinyViT's 7 x 7 windows; smaller N too
  RTVC_K1_CASE(8)
  RTVC_K1_CASE(13)
  RTVC_K1_CASE(16)
#undef RTVC_K1_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

int device_sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

int window_attention_sm90(const void* q, const void* k, const void* v,
                          const void* bias, void* out, int windows, int H,
                          int N, float scale, int scores_in_input_dtype,
                          cudaStream_t stream) {
  if (windows < 1 || H < 1 || H > 65535 || N < 1 || N > 256)
    return (int)cudaErrorInvalidValue;
  return scores_in_input_dtype
             ? dispatch<true>(q, k, v, bias, out, windows, H, N, scale,
                              stream)
             : dispatch<false>(q, k, v, bias, out, windows, H, N, scale,
                               stream);
}

}  // namespace rtvc
