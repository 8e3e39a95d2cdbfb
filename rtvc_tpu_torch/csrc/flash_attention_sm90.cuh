// K4/K5 forward (flash_attention_sm90.cu) and K8 (flash_attention_bwd_sm90.cu)
// for bfloat16 on Hopper tensor cores, with K4n and K8n, their input-dtype
// softmax variants: flash_attention.cu's entry points
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

#include "common.cuh"  // round_to

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
  int native;  // the input-dtype (bf16) softmax: K4n
  // K4n: where not null, the rows' (max, bf16(1 / z)) as float32, per
  // 64-row tile of each (batch, head) 64 maxima then 64 reciprocals
  float* stats;
  int stats_only;  // K4n's first two sweeps alone: stats, no out
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
  int native;  // the input-dtype (bf16) softmax: K8n
  // K8n: stats holds the forward's (max, bf16(1 / z)) in K4n's layout, and
  // delta a float32 scratch of B * H * ceil(Lq / 64) * 64 values
  float* delta;
};

int attention_bwd_sm90(const Sm90AttentionBwd& a, cudaStream_t stream);

// Runs native_exp and native_div (below) on every input of their bf16 domains,
// beside the per-score bf16r(expf(d)) and bf16r(p / bf16(keep)); `out` (8 ints
// on the card, zeroed) receives: exponential inputs, mismatches, pairs that
// took expf, inputs whose normal expf(d) the bracket misses, the largest |y
// 2^-kExpShift / expf(d) - 1| (float32 bits) over those; division inputs,
// mismatches, pairs that divided.
int native_probe_sm90(int* out, float keep, cudaStream_t stream);

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

// wait until at most the N newest committed product groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// One sweep of K4n or K8n over the key tiles of ring slots u0 + [0,
// tiles), each tile's products (kGroups committed groups) into one of two
// buffers in turn: those of tile t + 1 are in flight while tile t's
// arithmetic (`tile(buf, t)`, which fences what it reads) runs. Every turn
// issues (`issue(buf, u, real)`); where no tile is left it issues products
// of resident tiles that nothing reads, as ptxas serialises the products
// of a stage it cannot follow, so no product is issued under a condition.
template <int kGroups, class Buf, class Issue, class Release, class Tile>
__device__ __forceinline__ void pipelined_sweep(Buf& ba, Buf& bb, int u0,
                                                int tiles, Issue& issue,
                                                Release& release,
                                                Tile& tile) {
  issue(ba, u0, true);
  for (int t = 0; t < tiles; t += 2) {
    issue(bb, u0 + t + 1, t + 1 < tiles);
    wgmma_wait_n<kGroups>();
    tile(ba, t);
    release(u0 + t);
    issue(ba, u0 + t + 2, t + 2 < tiles);
    wgmma_wait_n<kGroups>();
    if (t + 1 < tiles) {
      tile(bb, t + 1);
      release(u0 + t + 1);
    }
  }
  wgmma_wait();
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

// x rounded to bfloat16 (nearest even) and widened back
__device__ __forceinline__ float bf16r(float x) {
  return round_to<__nv_bfloat16>(x);
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

// O += P V for one 64-key tile with P already bfloat16 (the input-dtype
// softmax's probabilities): 4 wgmma m64n64k16, committed as one group
__device__ __forceinline__ void issue_pv1(float (&o)[32],
                                          const uint32_t (&p)[16],
                                          const uint64_t (&dv)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             dv[kk]);
  wgmma_commit();
}

// ---- the input-dtype softmax (K4n, K8n) in packed bf16 pairs ----
// A pair holds two bf16 values, the first in the low half. mul.rn and
// sub.rn of two bf16 operands round the exact product or difference once
// to bf16, which is what the per-score bf16r(float32 op) gives: a product
// of two bf16 values (8 significant bits each) is exact in float32; so is a
// difference where the exponents differ by at most 15 (at most 24 bits,
// a carry included). Where they differ by 16 or more, the smaller operand
// is below 2^-6 of the larger's bf16 half-ulp (on either side of a power
// of two), so the exact difference and its float32 rounding both lie
// nearer the larger operand than any bf16 midpoint and both round to it
// (tests/test_torch_native_redesign.py holds both on seeded pairs, exponent
// gaps up to 80 included).

__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a bf16 value held in a float (its low 16 bits zero) in both halves
__device__ __forceinline__ uint32_t bcast2(float x) {
  const uint32_t u = __float_as_uint(x) >> 16;
  return u | (u << 16);
}

// The exact fast exponential: bf16(expf(d)) for each bf16 d <= 0 (or -inf) of
// N pairs, bit for bit, where the per-score form took bf16r(expf(d)).
// ex2.approx of x = d log2(e) + kExpShift gives y ~ 2^kExpShift exp(d); the
// shift keeps y a normal float32 down to d = -93, where bf16(exp(d)) becomes 0
// (an unshifted ex2.approx.ftz would flush what expf keeps as a subnormal). y
// times 2^-kExpShift (1 -+ eps) brackets expf(d) on every input of the domain
// where expf(d) is a normal float32 (the largest relative error of y
// 2^-kExpShift was 3.34e-6 on an H100; eps = 2^-18 = 3.8e-6); rounding is
// monotone, so where both ends round to the same bf16 value, so does expf(d).
// Where they do not (a bf16 rounding midpoint lies within eps of y: 3 of the
// 32642 inputs), that pair takes expf itself. Below, where expf(d) is
// subnormal, the bracket can miss by a float32 ulp; there, as everywhere, the
// probe (native_probe_sm90) checks the bits of every input of the domain. The
// N pairs are formed first and the fallback, one branch, after: a branch a
// pair cut the unrolled pairs' instruction-level parallelism (K4n joint 718 ->
// 467 us on an H100).
constexpr float kExpShift = 10.f;
constexpr uint32_t kMaskedBf16 = 0xF14Au;  // bf16(-1e30)
constexpr uint32_t kNegInfBf16 = 0xFF80u;  // -inf
constexpr float kExpLo = 0x1p-10f * (1.f - 0x1p-18f);  // 2^-10 (1 - eps)
constexpr float kExpHi = 0x1p-10f * (1.f + 0x1p-18f);  // 2^-10 (1 + eps)

__device__ __forceinline__ float lo_half(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_half(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// `slow`, where given, counts the pairs that took expf (the probe's count)
template <int N>
__device__ __forceinline__ void native_exp(const uint32_t (&d2)[N],
                                           uint32_t (&e2)[N],
                                           int* slow = nullptr) {
  uint32_t redo = 0;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float y0 = ex2(fmaf(lo_half(d2[q]), 1.4426950408889634f,
                              kExpShift));
    const float y1 = ex2(fmaf(hi_half(d2[q]), 1.4426950408889634f,
                              kExpShift));
    const uint32_t lo = pack_bf16(y0 * kExpLo, y1 * kExpLo);
    const uint32_t hi = pack_bf16(y0 * kExpHi, y1 * kExpHi);
    e2[q] = lo;
    redo |= (lo != hi ? 1u : 0u) << q;
  }
  if (__builtin_expect(redo != 0, 0)) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      if (redo & (1u << q)) {
        e2[q] = pack_bf16(expf(lo_half(d2[q])), expf(hi_half(d2[q])));
        if (slow != nullptr) ++*slow;
      }
    }
  }
}

// The exact fast dropout division: bf16(p / keep_b) for each bf16 p in [0, 1]
// of N pairs, bit for bit, where the per-score form took bf16r(p / keep_b) (an
// IEEE float32 division, then the rounding). inv_lo and inv_hi are 1 / keep_b
// rounded down and up (__fdiv_rd, __fdiv_ru), so p inv_lo <= p / keep_b <= p
// inv_hi exactly, and the float32 roundings keep that order: where both
// products round to one bf16 value, so does the quotient; elsewhere (a
// midpoint between them: none of the 16257 inputs at rate 0.1 on an H100) the
// pair divides.
template <int N>
__device__ __forceinline__ void native_div(uint32_t (&p2)[N], float inv_lo,
                                           float inv_hi, float keep_b,
                                           int* slow = nullptr) {
  uint32_t redo = 0;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float p0 = lo_half(p2[q]), p1 = hi_half(p2[q]);
    const uint32_t lo = pack_bf16(p0 * inv_lo, p1 * inv_lo);
    redo |= (lo != pack_bf16(p0 * inv_hi, p1 * inv_hi) ? 1u : 0u) << q;
    p2[q] = redo & (1u << q) ? p2[q] : lo;
  }
  if (__builtin_expect(redo != 0, 0)) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      if (redo & (1u << q)) {
        p2[q] = pack_bf16(lo_half(p2[q]) / keep_b, hi_half(p2[q]) / keep_b);
        if (slow != nullptr) ++*slow;
      }
    }
  }
}

// The thread's kept keys of the tile at keys k0 + [0, 64) (k0 a multiple
// of 64), from the batch row's key mask as bits in shared memory (`bits`,
// bit k of word k / 32 for key k): bit 8 j + c of the result for key k0 +
// 8 j + cq + c. All ones without a mask.
__device__ __forceinline__ uint64_t kept_bits(const uint32_t* bits, int k0,
                                              int cq) {
  if (bits == nullptr) return ~0ull;
  return *reinterpret_cast<const uint64_t*>(bits + k0 / 32) >> cq;
}

// The batch row's [Lkv] byte key mask into shared-memory bits (words of
// 32 keys, two a 64-key tile; keys past Lkv 0), by the consumer
// warpgroup's four warps; the caller syncs the warpgroup after.
__device__ __forceinline__ void load_kept_bits(uint32_t* bits,
                                               const uint8_t* mask, int lkv,
                                               int warp, int lane) {
  const int words = 2 * ((lkv + 63) / 64);
#pragma unroll 4
  for (int w = warp; w < words; w += 4) {
    const int key = 32 * w + lane;
    const uint32_t word = __ballot_sync(0xffffffffu,
                                        key < lkv && mask[key] != 0);
    if (lane == 0) bits[w] = word;
  }
}

// sync the consumer warpgroup (128 threads) alone, on named barrier 1
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The input-dtype softmax's scores of one 64-key S tile (keys k0 + [0,
// 64)) for the thread of the m64 fragment that `r` places (rows r.row0 and
// r.row1, first columns r.cq of its 8-column groups, the warpgroup's first
// row r.row_min, the batch row's key mask r.mask or null), as _block_probs
// takes them with softmax_native: bf16(bf16(s) * scale_b), scale_b the
// bf16 scale; bf16(-1e30) where the key is disallowed; -inf past Lkv.
template <class Rows, class Args>
__device__ __forceinline__ void native_scores(const float (&sc)[32],
                                              float (&x)[32], int k0,
                                              const Rows& r, const Args& a,
                                              float scale_b) {
  const bool whole = r.mask == nullptr && k0 + 64 <= a.Lkv &&
                     (!a.causal || k0 + 64 <= a.prefix_len ||
                      k0 + 63 <= r.row_min);
  const float masked_b = bf16r(-1e30f);
  bool kept[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int key = k0 + 8 * (j / 2) + r.cq + (j & 1);
    kept[j] = r.mask == nullptr || r.mask[min(key, a.Lkv - 1)] != 0;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float y = bf16r(bf16r(sc[i]) * scale_b);
    if (whole) {
      x[i] = y;
    } else {
      const int row = (i & 2) ? r.row1 : r.row0;
      const int key = k0 + 8 * (i / 4) + r.cq + (i & 1);
      const bool ok = kept[2 * (i / 4) + (i & 1)] &&
                      (!a.causal || key < a.prefix_len || key <= row);
      x[i] = key < a.Lkv ? (ok ? y : masked_b) : -INFINITY;
    }
  }
}

// whether every (row, key) of the warpgroup's 64-row tile at keys k0 +
// [0, 64) is allowed (no key mask, no key past Lkv, none above the causal
// edge), `r` and `a` as for native_scores
template <class Rows, class Args>
__device__ __forceinline__ bool native_whole(int k0, const Rows& r,
                                             const Args& a) {
  return r.mask == nullptr && k0 + 64 <= a.Lkv &&
         (!a.causal || k0 + 64 <= a.prefix_len || k0 + 63 <= r.row_min);
}

// The allowed keys of a thread's two rows in the tile at keys k0 + [0, 64)
// (k0 a multiple of 64) below Lkv: bit 8 j + c of ok[row] for key k0 + 8 j
// + cq + c (the thread's keys; other bits are other threads'): the key
// mask's bits (r.bits, from load_kept_bits, or null), the causal edge
// (key < prefix or key <= row) and Lkv, each a word a tile, not a test a
// score.
template <class Rows, class Args>
__device__ __forceinline__ void tile_allowed(const Rows& r, const Args& a,
                                             int k0, uint64_t (&ok)[2]) {
  uint64_t w = kept_bits(r.bits, k0, r.cq);
  const int n = a.Lkv - k0 - r.cq;  // key k0 + cq + i < Lkv: i < n
  if (n < 64) w &= n <= 0 ? 0ull : ~0ull >> (64 - n);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int lim = max(a.prefix_len - 1, j ? r.row1 : r.row0) - k0 - r.cq;
    ok[j] = !a.causal || lim >= 63 ? w
            : lim < 0             ? 0ull
                                  : w & (~0ull >> (63 - lim));
  }
}

// the pair of 16-bit lanes selected by bits `pos` and `pos + 1` of w: each
// lane all ones where its bit is set
__device__ __forceinline__ uint32_t pair_lanes(uint64_t w, int pos) {
  const uint32_t t = static_cast<uint32_t>(w >> pos);
  return ((t & 1u) | ((t & 2u) << 15)) * 0xFFFFu;
}

// native_scores in packed pairs: pair q holds the thread's row (q & 1 ?
// row1 : row0) at keys k0 + 8 (q / 2) + cq + {0, 1}, each bf16(bf16(s) *
// scale_b) (scale2: scale_b in both halves), bf16(-1e30) where the key is
// disallowed, -inf past Lkv; r.bits the key mask's bits (load_kept_bits)
// or null.
template <class Rows, class Args>
__device__ __forceinline__ void native_pairs(const float (&sc)[32],
                                             uint32_t (&x2)[16], int k0,
                                             const Rows& r, const Args& a,
                                             uint32_t scale2) {
#pragma unroll
  for (int q = 0; q < 16; ++q)
    x2[q] = bmul2(pack_bf16(sc[2 * q], sc[2 * q + 1]), scale2);
  if (native_whole(k0, r, a)) return;
  uint64_t ok[2];
  tile_allowed(r, a, k0, ok);
  constexpr uint32_t kMasked2 = kMaskedBf16 | (kMaskedBf16 << 16);
  if (k0 + 64 <= a.Lkv) {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const uint32_t keep = pair_lanes(ok[q & 1], 8 * (q / 2));
      x2[q] = (x2[q] & keep) | (kMasked2 & ~keep);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    uint32_t out = 0;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * (q / 2) + r.cq + c;
      const uint32_t h = (x2[q] >> (16 * c)) & 0xFFFFu;
      out |= (key >= a.Lkv ? kNegInfBf16
              : (ok[q & 1] >> (8 * (q / 2) + c)) & 1 ? h : kMaskedBf16)
             << (16 * c);
    }
    x2[q] = out;
  }
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
