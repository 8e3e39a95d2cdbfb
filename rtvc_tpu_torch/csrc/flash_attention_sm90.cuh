// K4/K5 forward (flash_attention_sm90.cu) and K8 (flash_attention_bwd_sm90.cu)
// for bfloat16 on Hopper tensor cores: flash_attention.cu's entry points
// hand every bfloat16 call there; float32 calls keep its CUDA-core kernels.
// Below the entry points, the Hopper helpers both sources use: mbarriers,
// TMA loads through 4-d tensor maps (64 rows x 64 columns, 128-byte
// swizzle), wgmma descriptors and products, bf16 packing (the last also
// used by K1's window_attention_sm90.cu; the mbarriers, tensor-map encoder
// and descriptors also by K7's w8a8_matmul_sm90.cu).
#pragma once

#include <cuda.h>  // CUtensorMap (CUDA driver API, found at run time)
#include <cuda_bf16.h>
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

// The backward: dq [B, H, Lq, D], dk and dv [B, H, Lkv, D] contiguous;
// stats a float32 scratch of B * H * ceil(Lq / 64) * 192 values (per
// 64-row tile: the rows' max, 1 / normaliser and Delta). q, k, v and g
// (dO) are read through the element strides, as the forward's are.
struct Sm90AttentionBwd {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* stats;
  const uint8_t* kv_mask;
  int B, H, Lq, Lkv, D;
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, gb, gh, gl;
  float scale;
  int causal, prefix_len;
  uint32_t seed, thresh;
  float keep;
  int dropout;
};

int attention_bwd_sm90(const Sm90AttentionBwd& a, cudaStream_t stream);

constexpr int kTmaRows = 64;  // rows of a TMA box (one head)
constexpr int kTmaCols = 64;  // columns: D < 64 is zero-filled

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// wait past ~2^32 cycles (a pipeline fault) traps, so it fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// 4-d TMA load of one box into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// rows [row, row + 64) of head h, batch b: the map's dims are (D, L, H, B),
// or (D, H, L, B) where the head stride is the smaller
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head_inner,
                                         int row, int h, int b) {
  if (head_inner) {
    tma_load(dst, map, bar, 0, h, row, b);
  } else {
    tma_load(dst, map, bar, 0, row, h, b);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until every product this warpgroup committed is done
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of a wgmma's accumulator
// or A fragment across the fence, commit and wait around it
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile whose 8-row
// groups lie 1024 B apart (the tile base 1024-aligned). K-major (Q, K):
// advancing 16 columns adds 32 B; MN-major (V): advancing 16 keys adds
// 2048 B. The leading offset is unused for these shapes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The descriptors of a tile's four 16-deep k-steps (kStep = 2 for K-major
// Q and K, 32 B; 128 for MN-major V, 2048 B)
template <int kStep>
__device__ __forceinline__ void tile_descs(uint64_t (&d)[4], uint32_t tile) {
  const uint64_t base = sw128_desc(tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) d[kk] = base + kk * kStep;
}

#define RTVC_ACC32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define RTVC_ACC32_STR                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B, m64 n64 k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTVC_ACC32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RTVC_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64 n64 k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTVC_ACC32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTVC_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// S = Q K^T for one 64-key tile (any A B^T of two K-major 64 x 64 tiles):
// 4 wgmma m64n64k16, committed as one group (issued, not waited)
__device__ __forceinline__ void issue_s(float (&sc)[32],
                                        const uint64_t (&dq)[4],
                                        const uint64_t (&dk)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, dq[kk], dk[kk], kk > 0);
  wgmma_commit();
}

// O += P_hi V + P_lo V for one 64-key tile (any A B with A from registers
// as two bf16 terms and B MN-major): 8 wgmma m64n64k16, committed as one
// group (issued, not waited)
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&phi)[16],
                                         const uint32_t (&plo)[16],
                                         const uint64_t (&dv)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(o, phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
             phi[4 * kk + 3], dv[kk]);
    wgmma_rs(o, plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
             plo[4 * kk + 3], dv[kk]);
  }
  wgmma_commit();
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-d map over a [B, H, L, D]-indexed bf16 tensor with element strides
// (sb, sh, sl), boxes of 64 rows x 64 columns of one head, 128-byte
// swizzle, zero fill out of bounds. Dims (D, L, H, B), or (D, H, L, B)
// where the head stride is the smaller (a packed QKV view).
inline bool make_map(CUtensorMap* map, int* head_inner, const void* ptr, int D,
              int L, int H, int B, long long sb, long long sh,
              long long sl) {
  *head_inner = sh < sl;
  const cuuint64_t dims[4] = {
      (cuuint64_t)D, (cuuint64_t)(*head_inner ? H : L),
      (cuuint64_t)(*head_inner ? L : H), (cuuint64_t)B};
  const cuuint64_t strides[3] = {
      (cuuint64_t)((*head_inner ? sh : sl) * 2),
      (cuuint64_t)((*head_inner ? sl : sh) * 2), (cuuint64_t)(sb * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)kTmaCols,
                             (cuuint32_t)(*head_inner ? 1 : kTmaRows),
                             (cuuint32_t)(*head_inner ? kTmaRows : 1), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


}  // namespace rtvc
