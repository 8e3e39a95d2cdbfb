// K4 (fused multi-head attention, flash forward, in-kernel dropout) and K5
// (BLHD attention) for bfloat16 inputs, on Hopper's tensor cores.
//
// Replaces, as flash_attention.cu's float32 kernel does, the Pallas kernels
// rtvc_tpu/ops/attention.py _pallas_attention (_make_kernel /
// _block_probs, native_score_dot and softmax_native off) and blhd_attention
// (_make_blhd_kernel), and computes their function exactly:
//   out = drop(softmax(mask(q k^T * scale))) v   per (batch, head),
// float32 scores; a disallowed key (prefix-causal k < P or k <= q, and the
// optional [B, Lkv] key mask) scores the finite sentinel -1e30, so a row
// with no allowed key averages V uniformly; a key past Lkv scores -inf; the
// float32 normaliser sums every key, kept or dropped; dropout keeps a
// probability where dropout_bits(seed, b, h, row, key) >= thresh (the hash
// K8 regenerates) and divides it by 1 - rate; the output is bfloat16.
//
// What bounds it on an H100. At the GIT joint shape [8, 12, 1582, 64] the
// two products take 60 GFLOP, 60.6 us at the bf16 tensor-core peak, and the
// 234 M exponentials about as long on the special-function units; the
// CLIP shape [48, 257, 16, 64] is bound by its 101 MB of q/k/v/out (30 us).
// The float32 kernel ran both products on the CUDA cores at ~21 TFLOP/s.
// Design:
// - S = Q K^T runs as wgmma m64n64k16 with both operands in shared memory
//   (Q and K tiles are rows with D contiguous: K-major for A and B). A
//   bf16 x bf16 product is exact in float32, so S is the TPU kernel's f32
//   dot up to the summation order.
// - O += P V takes P from registers as the A operand (the S accumulator's
//   fragment is A's fragment layout, so no shared-memory round trip) and V
//   from shared memory as an MN-major B (transpose bit set). P is float32
//   in the TPU kernel: it goes in as two bf16 terms, hi = bf16(P) and
//   lo = bf16(P - hi), two products into one float32 accumulator, which
//   carries P to ~2^-17 relative, far below the bf16 output's rounding.
// - K and V tiles (64 keys x 64 columns, 128 B rows) arrive by TMA with the
//   128-byte swizzle into a 3-stage ring, with full/empty mbarriers. TMA
//   zero-fills rows past L and columns past D (D < 64 is zero-padded); the
//   kernel still scores keys past Lkv -inf by index. The tensor maps are
//   built on the host from the strides the entry point receives, so the
//   [B, L, H, D] views of a packed QKV product are read in place.
// - One producer warp issues the loads; one consumer warpgroup owns the
//   block's 64 query rows. Three such blocks fit an SM, so the softmax of
//   one overlaps the products of another. Two consumer warpgroups of 64
//   rows taking turns at the tensor cores on named barriers (128 rows a
//   block) were slower at both shapes: a 288-thread block at this register
//   count leaves room for one block per SM, two warpgroups against three.
//   The K/V reloads of 64-row blocks are not what bounds it: three
//   warpgroups sharing each tile did no better. No setmaxnreg: the
//   consumer fits its accumulators in the registers every thread gets,
//   and a lone producer warp cannot take part in the warpgroup-wide
//   setmaxnreg.
// - Online softmax in the log2 domain (ex2.approx), row max and sum kept per
//   thread for its two rows, reduced across the four lanes of a row. The
//   mask is applied by selects, never by a branch per score.

#include <cuda.h>  // CUtensorMap (CUDA driver API, found at run time)

#include "common.cuh"
#include "flash_attention_sm90.cuh"

namespace rtvc {
namespace {

constexpr int kRows = 64;    // query rows per consumer warpgroup
constexpr int kKeys = 64;    // keys per K/V tile
constexpr int kDim = 64;     // head dim of a tile; D < 64 is zero-padded
constexpr int kStages = 3;   // K/V ring depth
constexpr int kThreads = 160;  // one consumer warpgroup + one producer warp
constexpr uint32_t kTile = kRows * kDim * 2;  // 8 KB: 64 rows of 128 B
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

struct KernelArgs {
  __nv_bfloat16* out;
  const uint8_t* kv_mask;
  int H, Lq, Lkv, D;
  long long ob, oh, ol;
  float scale_log2;  // scale * log2(e)
  int causal, prefix_len;
  uint32_t seed, thresh;
  float inv_keep;    // 1 / (1 - rate), or 1
  int q_head_inner, k_head_inner, v_head_inner;  // tensor-map dim order
};

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

// the score x of (row, key) in the log2 domain, as _block_probs masks it;
// `kept` is the key mask's verdict. Selects, no branch: a branch per score
// costs more than the rest of the softmax.
__device__ __forceinline__ float masked(float x, int row, int key, bool kept,
                                        const KernelArgs& a) {
  const bool ok = kept && (!a.causal || key < a.prefix_len || key <= row);
  return key < a.Lkv ? (ok ? x : kMasked) : -INFINITY;
}

// What a consumer thread knows of its place: rows row0 and row1 (= row0 +
// 8) of the m64 accumulator fragment, the first column cq of each of its
// 8-column groups, the warpgroup's first row, its batch and head.
struct Rows {
  int row0, row1, row_min, cq, b, h;
  const uint8_t* mask;  // this batch row's [Lkv] key mask, or null
};

// The online softmax of one score tile (keys k0 + [0, 64)): scores to the
// log2 domain, masked by index where the tile needs it; the new row
// maxima m; P = exp2(S - m), summed into l (every key, kept or dropped),
// then dropped and split into bf16 hi + lo as the A fragments of P V.
// Returns in al the factors by which O must be rescaled. A tile with every
// key allowed (and a positive scale) keeps the raw scores: the scale goes
// into the max and into one fma per exponent, saving a multiply a score.
template <bool kDrop>
__device__ __forceinline__ void softmax_tile(
    const float (&sc)[32], uint32_t (&phi)[16], uint32_t (&plo)[16],
    float (&m)[2], float (&l)[2], float (&al)[2], int k0, const Rows& r,
    const KernelArgs& a) {
  const bool whole = r.mask == nullptr && k0 + kKeys <= a.Lkv &&
                     (!a.causal || k0 + kKeys <= a.prefix_len ||
                      k0 + kKeys - 1 <= r.row_min);
  const bool raw = whole && a.scale_log2 > 0.f;
  const float xs = raw ? a.scale_log2 : 1.f;  // x * xs: the log2 domain
  float x[32];
  if (raw) {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = sc[i];
  } else {
    // the key mask's verdict on this thread's 16 keys, read once
    bool kept[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int key = k0 + 8 * (j / 2) + r.cq + (j & 1);
      kept[j] = r.mask == nullptr || r.mask[min(key, a.Lkv - 1)] != 0;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      x[i] = masked(sc[i] * a.scale_log2, (i & 2) ? r.row1 : r.row0,
                    k0 + 8 * (i / 4) + r.cq + (i & 1),
                    kept[2 * (i / 4) + (i & 1)], a);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
  float ps[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
    // the tile holds a key below Lkv, so the new maxima are finite
    const float mn = fmaxf(m[j], mx[j] * xs);
    al[j] = ex2(m[j] - mn);
    m[j] = mn;
    ps[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int j = (i >> 1) & 1;
    float p0 = ex2(fmaf(x[i], xs, -m[j]));
    float p1 = ex2(fmaf(x[i + 1], xs, -m[j]));
    ps[j] += p0 + p1;
    if (kDrop) {
      const int row = j ? r.row1 : r.row0;
      const int key = k0 + 8 * (i / 4) + r.cq;
      if (dropout_bits(a.seed, r.b, r.h, row, key) < a.thresh) p0 = 0.f;
      if (dropout_bits(a.seed, r.b, r.h, row, key + 1) < a.thresh) p1 = 0.f;
    }
    phi[i / 2] = pack_bf16(p0, p1);
    const float2 hf = unpack_bf16(phi[i / 2]);
    plo[i / 2] = pack_bf16(p0 - hf.x, p1 - hf.y);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] = l[j] * al[j] + ps[j];
}

// S = Q K^T for one 64-key tile: 4 wgmma m64n64k16 (issued, not waited)
__device__ __forceinline__ void issue_s(float (&sc)[32],
                                        const uint64_t (&dq)[4],
                                        const uint64_t (&dk)[4]) {
#pragma unroll
  for (int kk = 0; kk < kDim / 16; ++kk) wgmma_ss(sc, dq[kk], dk[kk], kk > 0);
  wgmma_commit();
}

// O += P_hi V + P_lo V for one 64-key tile: 8 wgmma m64n64k16 with P from
// registers (issued, not waited)
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&phi)[16],
                                         const uint32_t (&plo)[16],
                                         const uint64_t (&dv)[4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    wgmma_rs(o, phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
             phi[4 * kk + 3], dv[kk]);
    wgmma_rs(o, plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
             plo[4 * kk + 3], dv[kk]);
  }
  wgmma_commit();
}

// One consumer warpgroup (64 query rows) + one producer warp. Up to three
// blocks share an SM (124 registers a thread), so one block's softmax runs
// while another's products do.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 3)
    attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const KernelArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                      // [64][64] bf16
  const uint32_t sK = sQ + kTile;                // [kStages][64][64]
  const uint32_t sV = sK + kStages * kTile;      // [kStages][64][64]
  const uint32_t q_full = sV + kStages * kTile;  // then full[], empty[]
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int q0 = blockIdx.x * kRows;
  const int tiles = (a.Lkv + kKeys - 1) / kKeys;
  // the warp index broadcast from lane 0: warp-uniform to ptxas, so the
  // role branch below is uniform and the shared-memory descriptors stay in
  // uniform registers (without it ptxas moves them over one at a time)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: Q once, then the K/V ring ----
    if (lane == 0) {
      mbar_expect_tx(q_full, kTile);
      tma_rows(sQ, &tq, q_full, a.q_head_inner, q0, h, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * kTile);
        tma_rows(sK + s * kTile, &tk, full0 + 8 * s, a.k_head_inner,
                 t * kKeys, h, b);
        tma_rows(sV + s * kTile, &tv, full0 + 8 * s, a.v_head_inner,
                 t * kKeys, h, b);
      }
    }
  } else {
    // ---- consumer warpgroup: rows q0 + [0, 64) ----
    // this thread's rows and the first column of each 8-column group of
    // the m64 accumulator fragment
    Rows r;
    r.row_min = q0;
    r.row0 = q0 + 16 * warp + lane / 4;
    r.row1 = r.row0 + 8;
    r.cq = 2 * (lane % 4);
    r.b = b;
    r.h = h;
    r.mask = a.kv_mask == nullptr ? nullptr : a.kv_mask + (size_t)b * a.Lkv;
    const int row0 = r.row0, row1 = r.row1, cq = r.cq;
    uint64_t dq[4], dk[4], dv[4];

    float o[32], sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, al[2];
    uint32_t phi[16], plo[16];
    mbar_wait(q_full, 0);

    // S of tile 0, then its softmax (O is still zero: al is not needed)
    mbar_wait(full0, 0);
    tile_descs<2>(dq, sQ);
    tile_descs<2>(dk, sK);
    wgmma_fence();
    issue_s(sc, dq, dk);
    wgmma_wait();
    fence_regs(sc);
    softmax_tile<kDrop>(sc, phi, plo, m, l, al, 0, r, a);

    // Tile t: S of tile t + 1 and P V of tile t go to the tensor cores
    // together, then the softmax of tile t + 1 runs while another block's
    // products do. A softmax that writes the next P fragments while this
    // warpgroup's own P V is in flight makes ptxas serialise every product
    // of the kernel (C7513, "non wgmma instructions defining input
    // registers"), though the PTX writes none of P V's registers; one that
    // works in place in S's registers and packs P after the wait overlaps
    // without that, but was no faster than three blocks per SM and cost
    // registers. So each step waits for all of its products. (No product
    // is issued under a condition: ptxas serialises the products of a
    // stage it cannot follow.)
    for (int t = 0; t + 1 < tiles; ++t) {
      const int s = t % kStages, s1 = (t + 1) % kStages;
      mbar_wait(full0 + 8 * s1, ((t + 1) / kStages) & 1);
      fence_regs(sc);
      fence_regs(o);
      fence_regs(phi);
      fence_regs(plo);
      tile_descs<2>(dq, sQ);
      tile_descs<2>(dk, sK + s1 * kTile);
      tile_descs<128>(dv, sV + s * kTile);
      wgmma_fence();
      issue_s(sc, dq, dk);
      issue_pv(o, phi, plo, dv);
      wgmma_wait();
      fence_regs(sc);
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      softmax_tile<kDrop>(sc, phi, plo, m, l, al, (t + 1) * kKeys, r, a);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= al[(i >> 1) & 1];
    }
    // the last tile: P V alone
    fence_regs(o);
    fence_regs(phi);
    fence_regs(plo);
    tile_descs<128>(dv, sV + (tiles - 1) % kStages * kTile);
    wgmma_fence();
    issue_pv(o, phi, plo, dv);
    wgmma_wait();
    fence_regs(o);

    // epilogue: O / l (and / (1 - rate)), rounded to bf16
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
    }
    const float f0 = a.inv_keep / l[0], f1 = a.inv_keep / l[1];
    __nv_bfloat16* op = a.out + b * a.ob + h * a.oh;
    const bool pairs = (a.D % 2) == 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= a.D) continue;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int row = k ? row1 : row0;
        if (row >= a.Lq) continue;
        const float f = k ? f1 : f0;
        const float x0 = o[4 * j + 2 * k] * f, x1 = o[4 * j + 2 * k + 1] * f;
        __nv_bfloat16* dst = op + row * a.ol + col;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          dst[0] = __float2bfloat16(x0);
          if (col + 1 < a.D) dst[1] = __float2bfloat16(x1);
        }
      }
    }
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

EncodeTiled encode_tiled() {
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
bool make_map(CUtensorMap* map, int* head_inner, const void* ptr, int D,
              int L, int H, int B, long long sb, long long sh,
              long long sl) {
  *head_inner = sh < sl;
  const cuuint64_t dims[4] = {
      (cuuint64_t)D, (cuuint64_t)(*head_inner ? H : L),
      (cuuint64_t)(*head_inner ? L : H), (cuuint64_t)B};
  const cuuint64_t strides[3] = {
      (cuuint64_t)((*head_inner ? sh : sl) * 2),
      (cuuint64_t)((*head_inner ? sl : sh) * 2), (cuuint64_t)(sb * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)kDim,
                             (cuuint32_t)(*head_inner ? 1 : kRows),
                             (cuuint32_t)(*head_inner ? kRows : 1), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kDrop>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const KernelArgs& ka, int B,
           cudaStream_t stream) {
  const int smem = (1 + 2 * kStages) * kTile + 8 * (1 + 2 * kStages) + 1024;
  auto kernel = attention_sm90_kernel<kDrop>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((ka.Lq + kRows - 1) / kRows, B * ka.H);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, ka);
  return (int)cudaGetLastError();
}

}  // namespace

int attention_sm90(const Sm90Attention& a, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  KernelArgs ka{static_cast<__nv_bfloat16*>(a.out), a.kv_mask, a.H, a.Lq,
                a.Lkv, a.D, a.ob, a.oh, a.ol, a.scale * kLog2e, a.causal,
                a.prefix_len, a.seed, a.thresh,
                a.dropout ? 1.f / a.keep : 1.f, 0, 0, 0};
  if (!make_map(&tq, &ka.q_head_inner, a.q, a.D, a.Lq, a.H, a.B, a.qb, a.qh,
                a.ql) ||
      !make_map(&tk, &ka.k_head_inner, a.k, a.D, a.Lkv, a.H, a.B, a.kb, a.kh,
                a.kl) ||
      !make_map(&tv, &ka.v_head_inner, a.v, a.D, a.Lkv, a.H, a.B, a.vb, a.vh,
                a.vl))
    return (int)cudaErrorInvalidValue;
  return a.dropout ? launch<true>(tq, tk, tv, ka, a.B, stream)
                   : launch<false>(tq, tk, tv, ka, a.B, stream);
}

}  // namespace rtvc
