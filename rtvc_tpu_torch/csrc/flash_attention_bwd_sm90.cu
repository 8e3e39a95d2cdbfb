// K8 (the flash backward, with in-kernel dropout) for bfloat16 inputs, on
// Hopper's tensor cores.
//
// Replaces, as flash_attention.cu's float32 kernels do, the Pallas kernel
// rtvc_tpu/ops/attention.py _pallas_attention_bwd (_make_bwd_kernel,
// native_score_dot and softmax_native off), and computes its function
// exactly: for the output gradient dO of
//   out = drop(softmax(mask(q k^T * scale))) v   per (batch, head),
// P is recomputed from Q and K with the forward's masks (prefix-causal
// k < P or k <= q, the optional [B, Lkv] key mask, the finite sentinel
// -1e30 so that a row with no allowed key averages V uniformly, -inf past
// Lkv); the kept mask comes from the same dropout_bits(seed, b, h, row, key)
// hash K4 draws, kept values divided by keep = 1 - rate;
//   dP = dO V^T, divided by keep where kept and 0 where dropped,
//   Delta = rowsum(P o dP) from the recomputed P and dP (as JAX takes it,
//           not dO.O from the rounded output),
//   dS = P o (dP - Delta),
//   dQ = dS K * scale, dK = dS^T Q * scale, dV = drop(P)^T dO,
// all accumulated in float32 and written in bfloat16.
//
// What bounds it on an H100: the five 2 D-deep products per allowed (row,
// key) pair: at the GIT joint shape [8, 12, 1582, 64], prefix 1542, 150
// GFLOP, 151.6 us at the bf16 tensor-core peak. The float32 kernels ran
// them on the CUDA cores in 4 x 4 register tiles (~1% of that bound).
// Design:
// - Two kernels, deterministic and free of atomics, as the float32 pair:
//   a GPU grid has no sequential axis to carry dK/dV across q blocks, as
//   the TPU kernel's VMEM accumulator does.
//   1. dQ: one block per 64 query rows: one consumer warpgroup and one
//      producer warp. The producer loads the Q and dO tiles once, then
//      streams K/V tiles (64 keys) by TMA into a 3-stage ring, twice. The
//      first sweep takes S = Q K^T and dP = dO V^T and carries the online
//      row max m, normaliser l and Sum e^(s - m) dP (rescaled when m
//      grows, as the forward rescales O), which gives Delta. The second
//      takes S and dP again, forms dS and accumulates dQ += dS K. (m, 1/l,
//      Delta) per row go to the float32 stats scratch, 64 rows a tile.
//   2. dK/dV: one block per 64 keys, K and V tiles resident; the producer
//      streams each q block's Q and dO tiles and its 768 bytes of stats
//      (one bulk copy). S^T = K Q^T and dP^T = V dO^T, P^T from the stats
//      in the log2 domain, the dropout hash, then dV += drop(P)^T dO and
//      dK += dS^T Q.
// - Every product is wgmma m64n64k16. S, S^T, dP, dP^T take both operands
//   from shared memory, K-major (bf16 x bf16 is exact in float32). The
//   others take the A operand from registers: the S accumulator's fragment
//   is A's fragment layout. P, drop(P) and dS are float32 in the TPU
//   kernel, so each enters as two bf16 terms, hi = bf16(x) and lo =
//   bf16(x - hi), two products into one float32 accumulator (~2^-17
//   relative). B is then an MN-major tile (K for dQ, dO and Q for dK/dV:
//   the same 128-byte-swizzled tiles, read with the transpose bit). That
//   is 12 m64-products per (q tile, key tile) pair over both kernels,
//   where 9 would do with float32 operands and the bound counts 5: S and
//   dP are taken three times (both sweeps of dQ, and dK/dV).
// - The tensor-core hazards of K4 (flash_attention_sm90.cu) hold: a
//   warpgroup writes no A fragment while its own products are in flight
//   (ptxas would serialise every product, C7513), so each turn waits for
//   all of its products before the softmax arithmetic; the masks are
//   selects, never a branch per score; tiles where every (row, key) is
//   allowed take an unmasked arm.
//
// K8n: the same backward in the TPU kernel's input-dtype softmax
// (_make_bwd_kernel with softmax_native, bf16 inputs): P and drop(P) are
// K4n's bf16 probabilities (flash_attention_sm90.cu: bf16 scores, max and
// exp, a float32 normaliser whose bf16 reciprocal multiplies each e), upcast
// to float32; the rest is K8's math, dP of a kept key divided by the
// float32 1 - rate. The row statistics (max, bf16(1 / z)) come from the
// forward: K4n writes them where autograd will need them, and a standalone
// call takes them from K4n's stats-only launch. So
// attention_bwd_dq_native_sm90_kernel sweeps the keys twice, as K8's dQ
// kernel does: S and dP for Delta = Sum P dP (from the recomputed P and
// dP, as JAX takes it; S and dP of tile t + 1 in flight while tile t's
// terms are summed), then S and dP for dS and dQ += dS K. Delta goes to a
// float32 scratch of 64 rows a tile; the dK/dV kernel's kNative arm
// copies each q tile's (max, 1 / z) and Delta into one stage, in K8's
// order, and forms P^T in bf16 pairs with K4n's exact fast exponential and
// dropout division; drop(P) is bf16 already, so dV += drop(P)^T dO is one
// bf16 term where K8 takes two. The bound counts the function's own five
// products, as K8's.

#include "common.cuh"
#include "flash_attention_sm90.cuh"

namespace rtvc {
namespace {

constexpr int kStages = 3;     // ring depth of streamed tiles
constexpr int kThreads = 160;  // one consumer warpgroup + one producer warp
constexpr uint32_t kTile = 64 * 64 * 2;      // 8 KB: 64 rows of 128 B
constexpr uint32_t kStatBytes = 3 * 64 * 4;  // m, 1/l, Delta of 64 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

struct BwdArgs {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* stats;
  const uint8_t* kv_mask;
  int H, Lq, Lkv, D;
  float scale, scale_log2;
  int causal, prefix_len;
  uint32_t seed, thresh;
  float inv_keep;  // 1 / (1 - rate), or 1
  int q_head_inner, k_head_inner, v_head_inner, g_head_inner;
  float keep;      // 1 - rate, or 1: K8n rounds it (and scale) to bf16
  float* delta;    // K8n: the rows' Delta (stats holds K4n's statistics)
};

// the score x of (row, key), already in the log2 domain, as _block_probs
// masks it; `kept` is the key mask's verdict
__device__ __forceinline__ float masked(float x, int row, int key, bool kept,
                                        const BwdArgs& a) {
  const bool ok = kept && (!a.causal || key < a.prefix_len || key <= row);
  return key < a.Lkv ? (ok ? x : kMasked) : -INFINITY;
}

__device__ __forceinline__ bool dropped(const BwdArgs& a, int b, int h,
                                        int row, int key) {
  return dropout_bits(a.seed, b, h, row, key) < a.thresh;
}

// hi and lo bf16 pairs of (x0, x1): hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 hf = unpack_bf16(hi);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// 1-d bulk copy of `bytes` (a multiple of 16) into shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A dQ-kernel thread's place: rows row0 and row1 (= row0 + 8) of the m64
// fragment, the first column cq of each 8-column group, the warpgroup's
// first row, batch and head
struct QRows {
  int row0, row1, row_min, cq, b, h;
  const uint8_t* mask;  // this batch row's [Lkv] key mask, or null
};

// K8n's dQ-kernel place of a thread: QRows, and the key mask's bits in
// shared memory (load_kept_bits) or null
struct NQRows : QRows {
  const uint32_t* bits;
};

// The scores of one S tile (keys k0 + [0, 64)) in the log2 domain, masked
// by index where the tile needs it
__device__ __forceinline__ void scores(const float (&sc)[32], float (&x)[32],
                                       int k0, const QRows& r,
                                       const BwdArgs& a) {
  const bool whole = r.mask == nullptr && k0 + 64 <= a.Lkv &&
                     (!a.causal || k0 + 64 <= a.prefix_len ||
                      k0 + 63 <= r.row_min);
  if (whole) {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = sc[i] * a.scale_log2;
    return;
  }
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

// dP where kept, scaled by 1 / keep; 0 where dropped
template <bool kDrop>
__device__ __forceinline__ float kept_dp(float d, const BwdArgs& a, int b,
                                         int h, int row, int key) {
  if (!kDrop) return d;
  return dropped(a, b, h, row, key) ? 0.f : d * a.inv_keep;
}

// Sweep 1 of the dQ kernel on one tile: the online row max m (log2
// domain), the normaliser l and e = Sum 2^(x - m) dP, both per thread
// (reduced over a row's four lanes at the end) and rescaled when m grows
template <bool kDrop>
__device__ __forceinline__ void stats_tile(const float (&sc)[32],
                                           const float (&dp)[32],
                                           float (&m)[2], float (&l)[2],
                                           float (&e)[2], int k0,
                                           const QRows& r, const BwdArgs& a) {
  float x[32];
  scores(sc, x, k0, r, a);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
  float al[2], ps[2], pe[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
    // the tile holds a key below Lkv, so the new maxima are finite
    const float mn = fmaxf(m[j], mx[j]);
    al[j] = ex2(m[j] - mn);
    m[j] = mn;
    ps[j] = 0.f;
    pe[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int j = (i >> 1) & 1;
    const float p = ex2(x[i] - m[j]);
    ps[j] += p;
    pe[j] += p * kept_dp<kDrop>(dp[i], a, r.b, r.h, j ? r.row1 : r.row0,
                                k0 + 8 * (i / 4) + r.cq + (i & 1));
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] = l[j] * al[j] + ps[j];
    e[j] = e[j] * al[j] + pe[j];
  }
}

// Sweep 2 of the dQ kernel on one tile: dS = P o (dP - Delta) with P =
// 2^(x - m) / l, split into the bf16 hi and lo A fragments of dS K
template <bool kDrop>
__device__ __forceinline__ void ds_tile(const float (&sc)[32],
                                        const float (&dp)[32],
                                        uint32_t (&dhi)[16],
                                        uint32_t (&dlo)[16],
                                        const float (&m)[2],
                                        const float (&il)[2],
                                        const float (&delta)[2], int k0,
                                        const QRows& r, const BwdArgs& a) {
  float x[32];
  scores(sc, x, k0, r, a);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int j = (i >> 1) & 1;
    const int row = j ? r.row1 : r.row0, key = k0 + 8 * (i / 4) + r.cq;
    const float p0 = ex2(x[i] - m[j]) * il[j];
    const float p1 = ex2(x[i + 1] - m[j]) * il[j];
    const float d0 = kept_dp<kDrop>(dp[i], a, r.b, r.h, row, key);
    const float d1 = kept_dp<kDrop>(dp[i + 1], a, r.b, r.h, row, key + 1);
    split(p0 * (d0 - delta[j]), p1 * (d1 - delta[j]), dhi[i / 2],
          dlo[i / 2]);
  }
}

// Kernel 1: dQ and the row statistics, one block per (64 query rows,
// batch x head)
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    attention_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tg,
                                 const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                      // [64][64] bf16
  const uint32_t sG = sQ + kTile;                // dO, [64][64]
  const uint32_t sK = sG + kTile;                // [kStages][64][64]
  const uint32_t sV = sK + kStages * kTile;      // [kStages][64][64]
  const uint32_t q_full = sV + kStages * kTile;  // then full[], empty[]
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int q0 = blockIdx.x * 64;
  const int tiles = (a.Lkv + 63) / 64;
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
    // ---- producer: Q and dO once, then the K/V ring, two sweeps ----
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * kTile);
      tma_rows(sQ, &tq, q_full, a.q_head_inner, q0, h, b);
      tma_rows(sG, &tg, q_full, a.g_head_inner, q0, h, b);
      for (int u = 0; u < 2 * tiles; ++u) {
        const int s = u % kStages, t = u % tiles;
        mbar_wait(empty0 + 8 * s, ((u / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * kTile);
        tma_rows(sK + s * kTile, &tk, full0 + 8 * s, a.k_head_inner, t * 64,
                 h, b);
        tma_rows(sV + s * kTile, &tv, full0 + 8 * s, a.v_head_inner, t * 64,
                 h, b);
      }
    }
    return;
  }
  // ---- consumer warpgroup: rows q0 + [0, 64) ----
  QRows r;
  r.row_min = q0;
  r.row0 = q0 + 16 * warp + lane / 4;
  r.row1 = r.row0 + 8;
  r.cq = 2 * (lane % 4);
  r.b = b;
  r.h = h;
  r.mask = a.kv_mask == nullptr ? nullptr : a.kv_mask + (size_t)b * a.Lkv;
  uint64_t dq[4], dg[4], dk[4], dv[4];
  float sc[32], dp[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, e[2] = {0.f, 0.f};
  uint32_t dhi[16], dlo[16];
  mbar_wait(q_full, 0);

  // S and dP of ring slot u (tile u % tiles), waited
  auto s_dp = [&](int u) {
    const int s = u % kStages;
    mbar_wait(full0 + 8 * s, (u / kStages) & 1);
    fence_regs(sc);
    fence_regs(dp);
    tile_descs<2>(dq, sQ);
    tile_descs<2>(dk, sK + s * kTile);
    tile_descs<2>(dg, sG);
    tile_descs<2>(dv, sV + s * kTile);
    wgmma_fence();
    issue_s(sc, dq, dk);
    issue_s(dp, dg, dv);
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);
  };

  // sweep 1: m, l and Delta's numerator
  for (int t = 0; t < tiles; ++t) {
    s_dp(t);
    if (lane == 0) mbar_arrive(empty0 + 8 * (t % kStages));
    stats_tile<kDrop>(sc, dp, m, l, e, t * 64, r, a);
  }
  float il[2], delta[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
      e[j] += __shfl_xor_sync(0xffffffffu, e[j], off);
    }
    il[j] = 1.f / l[j];
    delta[j] = e[j] * il[j];
  }

  // sweep 2: dS of tile t + 1 is formed while nothing is in flight; S and
  // dP of tile t + 1 go to the tensor cores with dQ += dS K of tile t
  s_dp(tiles);
  ds_tile<kDrop>(sc, dp, dhi, dlo, m, il, delta, 0, r, a);
  for (int t = 0; t + 1 < tiles; ++t) {
    const int u = tiles + t, s = u % kStages, s1 = (u + 1) % kStages;
    mbar_wait(full0 + 8 * s1, ((u + 1) / kStages) & 1);
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc);
    fence_regs(dhi);
    fence_regs(dlo);
    tile_descs<2>(dq, sQ);
    tile_descs<2>(dk, sK + s1 * kTile);
    tile_descs<2>(dg, sG);
    tile_descs<2>(dv, sV + s1 * kTile);
    uint64_t dkm[4];
    tile_descs<128>(dkm, sK + s * kTile);
    wgmma_fence();
    issue_s(sc, dq, dk);
    issue_s(dp, dg, dv);
    issue_pv(acc, dhi, dlo, dkm);
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    ds_tile<kDrop>(sc, dp, dhi, dlo, m, il, delta, (t + 1) * 64, r, a);
  }
  fence_regs(acc);
  fence_regs(dhi);
  fence_regs(dlo);
  {
    uint64_t dkm[4];
    tile_descs<128>(dkm, sK + (2 * tiles - 1) % kStages * kTile);
    wgmma_fence();
    issue_pv(acc, dhi, dlo, dkm);
    wgmma_wait();
  }
  fence_regs(acc);

  // epilogue: dQ * scale in bf16; the rows' (m, 1/l, Delta)
  __nv_bfloat16* out = a.dq + ((size_t)blockIdx.y * a.Lq) * a.D;
  const bool pairs = (a.D % 2) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + r.cq;
    if (col >= a.D) continue;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = k ? r.row1 : r.row0;
      if (row >= a.Lq) continue;
      const float x0 = acc[4 * j + 2 * k] * a.scale;
      const float x1 = acc[4 * j + 2 * k + 1] * a.scale;
      __nv_bfloat16* dst = out + (size_t)row * a.D + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16(x0);
        if (col + 1 < a.D) dst[1] = __float2bfloat16(x1);
      }
    }
  }
  if (lane % 4 == 0) {
    float* st = a.stats + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 192;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = (k ? r.row1 : r.row0) - q0;
      st[i] = m[k];
      st[64 + i] = il[k];
      st[128 + i] = delta[k];
    }
  }
}

// Kernel 1n: K8n's dQ and Delta, one block per (64 query rows, batch x
// head), from the forward's row statistics (max, bf16(1 / z)): two sweeps
// over the keys, as K8's (see the note at the top). The first takes S and
// dP of tile t + 1 while tile t's Delta terms are summed; the second
// issues S and dP of tile t + 1 with dQ += dS K of tile t.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    attention_bwd_dq_native_sm90_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tg, const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sG = sQ + kTile;
  const uint32_t sK = sG + kTile;
  const uint32_t sV = sK + kStages * kTile;
  const uint32_t q_full = sV + kStages * kTile;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;
  // the key mask's bits, 2 words a tile
  uint32_t* bits = reinterpret_cast<uint32_t*>(
      smem_raw + (empty0 + 8 * kStages - raw_base));

  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int q0 = blockIdx.x * 64;
  const int tiles = (a.Lkv + 63) / 64;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: Q and dO once, then the K/V ring, two sweeps ----
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * kTile);
      tma_rows(sQ, &tq, q_full, a.q_head_inner, q0, h, b);
      tma_rows(sG, &tg, q_full, a.g_head_inner, q0, h, b);
      for (int u = 0; u < 2 * tiles; ++u) {
        const int s = u % kStages, t = u % tiles;
        mbar_wait(empty0 + 8 * s, ((u / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * kTile);
        tma_rows(sK + s * kTile, &tk, full0 + 8 * s, a.k_head_inner, t * 64,
                 h, b);
        tma_rows(sV + s * kTile, &tv, full0 + 8 * s, a.v_head_inner, t * 64,
                 h, b);
      }
    }
    return;
  }
  // ---- consumer warpgroup: rows q0 + [0, 64) ----
  NQRows r;
  r.row_min = q0;
  r.row0 = q0 + 16 * warp + lane / 4;
  r.row1 = r.row0 + 8;
  r.cq = 2 * (lane % 4);
  r.b = b;
  r.h = h;
  r.mask = a.kv_mask == nullptr ? nullptr : a.kv_mask + (size_t)b * a.Lkv;
  r.bits = nullptr;
  if (r.mask != nullptr) {
    load_kept_bits(bits, r.mask, a.Lkv, warp, lane);
    warpgroup_sync();
    r.bits = bits;
  }
  const uint32_t scale2 = bcast2(bf16r(a.scale));
  const size_t tile_id = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  // the forward's statistics of this thread's rows (64 maxima, then 64
  // reciprocals a tile)
  const float* fst = a.stats + tile_id * 128;
  const uint32_t m2[2] = {bcast2(fst[r.row0 - q0]), bcast2(fst[r.row1 - q0])};
  const uint32_t rz2[2] = {bcast2(fst[64 + r.row0 - q0]),
                           bcast2(fst[64 + r.row1 - q0])};
  uint64_t dq[4], dg[4], dk[4], dv[4];
  tile_descs<2>(dq, sQ);
  tile_descs<2>(dg, sG);
  mbar_wait(q_full, 0);

  // S and dP of one tile
  struct SdP {
    float s[32], dp[32];
  } ba, bb;
  // S and dP of ring slot u, issued (two groups); Q Q^T and dO dO^T where
  // !real
  auto issue = [&](SdP& buf, int u, bool real) {
    const int s = u % kStages;
    if (real) mbar_wait(full0 + 8 * s, (u / kStages) & 1);
    tile_descs<2>(dk, real ? sK + s * kTile : sQ);
    tile_descs<2>(dv, real ? sV + s * kTile : sG);
    fence_regs(buf.s);
    fence_regs(buf.dp);
    wgmma_fence();
    issue_s(buf.s, dq, dk);
    issue_s(buf.dp, dg, dv);
  };
  auto release = [&](int u) {
    if (lane == 0) mbar_arrive(empty0 + 8 * (u % kStages));
  };
  // P of one tile in pairs, p2[q] as native_pairs places it
  auto probs = [&](const float (&sc)[32], uint32_t (&p2)[16], int t) {
    uint32_t x2[16];
    native_pairs(sc, x2, t * 64, r, a, scale2);
#pragma unroll
    for (int q = 0; q < 16; ++q) x2[q] = bsub2(x2[q], m2[q & 1]);
    native_exp(x2, p2);
#pragma unroll
    for (int q = 0; q < 16; ++q) p2[q] = bmul2(p2[q], rz2[q & 1]);
  };

  // sweep 1: Delta = Sum P dP, dP 0 where dropped, / keep where kept
  float delta[2] = {0.f, 0.f};
  auto delta_tile = [&](SdP& buf, int t) {
    fence_regs(buf.s);
    fence_regs(buf.dp);
    uint32_t p2[16];
    probs(buf.s, p2, t);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int row = (q & 1) ? r.row1 : r.row0;
      const int key = t * 64 + 8 * (q / 2) + r.cq;
      const float2 p = unpack_bf16(p2[q]);
      delta[q & 1] += p.x * kept_dp<kDrop>(buf.dp[2 * q], a, b, h, row, key) +
                      p.y * kept_dp<kDrop>(buf.dp[2 * q + 1], a, b, h, row,
                                           key + 1);
    }
  };
  pipelined_sweep<2>(ba, bb, 0, tiles, issue, release, delta_tile);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      delta[j] += __shfl_xor_sync(0xffffffffu, delta[j], off);
  }

  // sweep 2: dS = P o (dP - Delta) as bf16 hi + lo, dQ += dS K; dS of tile
  // t + 1 is formed while nothing is in flight
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t dhi[16], dlo[16];
  auto ds_of = [&](int t) {
    uint32_t p2[16];
    probs(ba.s, p2, t);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int j = q & 1, row = j ? r.row1 : r.row0;
      const int key = t * 64 + 8 * (q / 2) + r.cq;
      const float2 p = unpack_bf16(p2[q]);
      const float d0 = kept_dp<kDrop>(ba.dp[2 * q], a, b, h, row, key);
      const float d1 = kept_dp<kDrop>(ba.dp[2 * q + 1], a, b, h, row,
                                      key + 1);
      split(p.x * (d0 - delta[j]), p.y * (d1 - delta[j]), dhi[q], dlo[q]);
    }
  };
  const int u0 = tiles;
  issue(ba, u0, true);
  wgmma_wait();
  fence_regs(ba.s);
  fence_regs(ba.dp);
  ds_of(0);
  for (int t = 0; t + 1 < tiles; ++t) {
    const int s = (u0 + t) % kStages;
    const int u1 = u0 + t + 1, s1 = u1 % kStages;
    mbar_wait(full0 + 8 * s1, (u1 / kStages) & 1);
    fence_regs(ba.s);
    fence_regs(ba.dp);
    fence_regs(acc);
    fence_regs(dhi);
    fence_regs(dlo);
    tile_descs<2>(dk, sK + s1 * kTile);
    tile_descs<2>(dv, sV + s1 * kTile);
    uint64_t dkm[4];
    tile_descs<128>(dkm, sK + s * kTile);
    wgmma_fence();
    issue_s(ba.s, dq, dk);
    issue_s(ba.dp, dg, dv);
    issue_pv(acc, dhi, dlo, dkm);
    wgmma_wait();
    fence_regs(ba.s);
    fence_regs(ba.dp);
    fence_regs(acc);
    release(u0 + t);
    ds_of(t + 1);
  }
  fence_regs(acc);
  fence_regs(dhi);
  fence_regs(dlo);
  {
    uint64_t dkm[4];
    tile_descs<128>(dkm, sK + (u0 + tiles - 1) % kStages * kTile);
    wgmma_fence();
    issue_pv(acc, dhi, dlo, dkm);
    wgmma_wait();
  }
  fence_regs(acc);
  release(u0 + tiles - 1);

  // epilogue: dQ * scale in bf16; the rows' Delta
  __nv_bfloat16* out = a.dq + ((size_t)blockIdx.y * a.Lq) * a.D;
  const bool pairs = (a.D % 2) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + r.cq;
    if (col >= a.D) continue;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = k ? r.row1 : r.row0;
      if (row >= a.Lq) continue;
      const float x0 = acc[4 * j + 2 * k] * a.scale;
      const float x1 = acc[4 * j + 2 * k + 1] * a.scale;
      __nv_bfloat16* dst = out + (size_t)row * a.D + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16(x0);
        if (col + 1 < a.D) dst[1] = __float2bfloat16(x1);
      }
    }
  }
  if (lane % 4 == 0) {
    float* dl = a.delta + tile_id * 64;
#pragma unroll
    for (int k = 0; k < 2; ++k) dl[(k ? r.row1 : r.row0) - q0] = delta[k];
  }
}

// Kernel 2: dK and dV, one block per (64 keys, batch x head). A thread
// holds keys key0 and key0 + 8 (the m64 fragment's rows) and, per q tile,
// the rows q0 + 8 j + cq (+ 1) (its columns). kNative takes P^T in the
// input-dtype softmax from the forward's statistics and K8n's Delta, in
// packed pairs, and drop(P)^T, bf16 already, as one bf16 term.
template <bool kDrop, bool kNative>
__global__ void __launch_bounds__(kThreads, 2)
    attention_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tg,
                                  const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;                       // [64][64] bf16
  const uint32_t sV = sK + kTile;                 // [64][64]
  const uint32_t sQ = sV + kTile;                 // [kStages][64][64]
  const uint32_t sG = sQ + kStages * kTile;       // dO, [kStages][64][64]
  const uint32_t sSt = sG + kStages * kTile;      // [kStages][3][64] f32
  const uint32_t kv_full = sSt + kStages * kStatBytes;
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int k0 = blockIdx.x * 64;
  const int qtiles = (a.Lq + 63) / 64;
  const float* stats =
      a.stats + (size_t)blockIdx.y * qtiles * (kNative ? 128 : 192);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: K and V once, then each q tile's Q, dO and stats ----
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * kTile);
      tma_rows(sK, &tk, kv_full, a.k_head_inner, k0, h, b);
      tma_rows(sV, &tv, kv_full, a.v_head_inner, k0, h, b);
      for (int t = 0; t < qtiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * kTile + kStatBytes);
        tma_rows(sQ + s * kTile, &tq, full0 + 8 * s, a.q_head_inner, t * 64,
                 h, b);
        tma_rows(sG + s * kTile, &tg, full0 + 8 * s, a.g_head_inner, t * 64,
                 h, b);
        if constexpr (kNative) {
          // the forward's (max, bf16(1 / z)), then Delta: one stage holds
          // the three in K8's order
          bulk_load(sSt + s * kStatBytes, stats + t * 128, 2 * 64 * 4,
                    full0 + 8 * s);
          bulk_load(sSt + s * kStatBytes + 2 * 64 * 4,
                    a.delta + ((size_t)blockIdx.y * qtiles + t) * 64, 64 * 4,
                    full0 + 8 * s);
        } else {
          bulk_load(sSt + s * kStatBytes, stats + t * 192, kStatBytes,
                    full0 + 8 * s);
        }
      }
    }
    return;
  }
  // ---- consumer warpgroup: keys k0 + [0, 64) ----
  const int key0 = k0 + 16 * warp + lane / 4, key1 = key0 + 8;
  const int cq = 2 * (lane % 4);
  const uint8_t* mask =
      a.kv_mask == nullptr ? nullptr : a.kv_mask + (size_t)b * a.Lkv;
  const bool kept0 = mask == nullptr || mask[min(key0, a.Lkv - 1)] != 0;
  const bool kept1 = mask == nullptr || mask[min(key1, a.Lkv - 1)] != 0;
  const float keep_b = bf16r(a.keep);
  const uint32_t scale2 = bcast2(bf16r(a.scale));
  const float inv_lo = __fdiv_rd(1.f, keep_b), inv_hi = __fdiv_ru(1.f, keep_b);
  uint64_t dk_[4], dv_[4], dq_[4], dg_[4];
  float st[32], dpt[32], dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  uint32_t phi[16], plo[16], dhi[16], dlo[16];
  mbar_wait(kv_full, 0);

  for (int t = 0; t < qtiles; ++t) {
    const int s = t % kStages, q0 = t * 64;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    fence_regs(st);
    fence_regs(dpt);
    tile_descs<2>(dk_, sK);
    tile_descs<2>(dq_, sQ + s * kTile);
    tile_descs<2>(dv_, sV);
    tile_descs<2>(dg_, sG + s * kTile);
    wgmma_fence();
    issue_s(st, dk_, dq_);   // S^T = K Q^T
    issue_s(dpt, dv_, dg_);  // dP^T = V dO^T
    wgmma_wait();
    fence_regs(st);
    fence_regs(dpt);

    // P^T from the stats, the dropout hash, dS^T; split into A fragments
    const float* sm = reinterpret_cast<const float*>(
        smem_raw + (sSt - raw) + s * kStatBytes);
    const bool whole = mask == nullptr && k0 + 64 <= a.Lkv &&
                       q0 + 64 <= a.Lq &&
                       (!a.causal || k0 + 64 <= a.prefix_len ||
                        k0 + 63 <= q0);
    if constexpr (kNative) {
      // pair q = i / 2: key (i & 2 ? key1 : key0), rows q0 + c, c + 1
      uint32_t x2[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = (i & 2) ? key1 : key0;
        const bool kept_key = (i & 2) ? kept1 : kept0;
        const int c = 8 * (i / 4) + cq;
        uint32_t y2 = bmul2(pack_bf16(st[i], st[i + 1]), scale2);
        if (!whole) {
          uint32_t out = 0;
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int row = q0 + c + c2;
            const bool ok = kept_key && (!a.causal || key < a.prefix_len ||
                                         key <= row);
            const uint32_t h2 = (y2 >> (16 * c2)) & 0xFFFFu;
            out |= (row < a.Lq && key < a.Lkv ? (ok ? h2 : kMaskedBf16)
                                              : kNegInfBf16)
                   << (16 * c2);
          }
          y2 = out;
        }
        // the two rows' max, bf16 values held in floats
        x2[i / 2] = bsub2(y2, __byte_perm(__float_as_uint(sm[c]),
                                          __float_as_uint(sm[c + 1]),
                                          0x7632));
      }
      uint32_t p2[16];
      native_exp(x2, p2);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = 8 * (i / 4) + cq;
        p2[i / 2] = bmul2(p2[i / 2],
                          __byte_perm(__float_as_uint(sm[64 + c]),
                                      __float_as_uint(sm[65 + c]), 0x7632));
        phi[i / 2] = p2[i / 2];
      }
      if (kDrop) native_div(phi, inv_lo, inv_hi, keep_b);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = (i & 2) ? key1 : key0;
        const int c = 8 * (i / 4) + cq;
        const float2 p = unpack_bf16(p2[i / 2]);
        float d0 = dpt[i], d1 = dpt[i + 1];
        if (kDrop) {
          const bool drop0 = dropped(a, b, h, q0 + c, key);
          const bool drop1 = dropped(a, b, h, q0 + c + 1, key);
          phi[i / 2] &= (drop0 ? 0u : 0xFFFFu) | (drop1 ? 0u : 0xFFFF0000u);
          d0 = drop0 ? 0.f : d0 * a.inv_keep;
          d1 = drop1 ? 0.f : d1 * a.inv_keep;
        }
        split(p.x * (d0 - sm[128 + c]), p.y * (d1 - sm[129 + c]), dhi[i / 2],
              dlo[i / 2]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = (i & 2) ? key1 : key0;
        const bool kept_key = (i & 2) ? kept1 : kept0;
        float pu[2], ds[2];
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int c = 8 * (i / 4) + cq + c2, row = q0 + c;
          const float y = st[i + c2] * a.scale_log2;
          const float x =
              whole ? y
                    : (row < a.Lq ? masked(y, row, key, kept_key, a)
                                  : -INFINITY);
          const float p = ex2(x - sm[c]) * sm[64 + c];
          float d = dpt[i + c2];
          pu[c2] = p;
          if (kDrop) {
            const bool drop = dropped(a, b, h, row, key);
            pu[c2] = drop ? 0.f : p * a.inv_keep;
            d = drop ? 0.f : d * a.inv_keep;
          }
          ds[c2] = p * (d - sm[128 + c]);
        }
        split(pu[0], pu[1], phi[i / 2], plo[i / 2]);
        split(ds[0], ds[1], dhi[i / 2], dlo[i / 2]);
      }
    }

    fence_regs(dk);
    fence_regs(dv);
    fence_regs(phi);
    fence_regs(plo);
    fence_regs(dhi);
    fence_regs(dlo);
    tile_descs<128>(dg_, sG + s * kTile);
    tile_descs<128>(dq_, sQ + s * kTile);
    wgmma_fence();
    if constexpr (kNative) {
      issue_pv1(dv, phi, dg_);  // dV += drop(P)^T dO
    } else {
      issue_pv(dv, phi, plo, dg_);  // dV += drop(P)^T dO
    }
    issue_pv(dk, dhi, dlo, dq_);  // dK += dS^T Q
    wgmma_wait();
    fence_regs(dk);
    fence_regs(dv);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // epilogue: dK * scale and dV in bf16, keys < Lkv
  const size_t off = (size_t)blockIdx.y * a.Lkv * a.D;
  const bool pairs = (a.D % 2) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= a.D) continue;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int key = k ? key1 : key0;
      if (key >= a.Lkv) continue;
      const int i = 4 * j + 2 * k;
      __nv_bfloat16* pk = a.dk + off + (size_t)key * a.D + col;
      __nv_bfloat16* pv = a.dv + off + (size_t)key * a.D + col;
      const float k0s = dk[i] * a.scale, k1s = dk[i + 1] * a.scale;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(pk) =
            __floats2bfloat162_rn(k0s, k1s);
        *reinterpret_cast<__nv_bfloat162*>(pv) =
            __floats2bfloat162_rn(dv[i], dv[i + 1]);
      } else {
        pk[0] = __float2bfloat16(k0s);
        pv[0] = __float2bfloat16(dv[i]);
        if (col + 1 < a.D) {
          pk[1] = __float2bfloat16(k1s);
          pv[1] = __float2bfloat16(dv[i + 1]);
        }
      }
    }
  }
}

template <typename Kernel>
int launch_one(Kernel kernel, int smem, dim3 grid, const CUtensorMap& tq,
               const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& tg, const BwdArgs& ka,
               cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, tg, ka);
  return (int)cudaGetLastError();
}

template <bool kDrop, bool kNative>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const CUtensorMap& tg, const BwdArgs& ka,
           int B, cudaStream_t stream) {
  const int bars = 8 * (1 + 2 * kStages);
  const int dq_smem = (2 + 2 * kStages) * kTile + bars + 1024;
  const int dkv_smem =
      (2 + 2 * kStages) * kTile + kStages * kStatBytes + bars + 1024;
  // K8n's dQ kernel adds the key mask's bits, 8 bytes a key tile
  const int err = launch_one(kNative
                                 ? attention_bwd_dq_native_sm90_kernel<kDrop>
                                 : attention_bwd_dq_sm90_kernel<kDrop>,
                             dq_smem + (kNative ? 8 * ((ka.Lkv + 63) / 64)
                                                : 0),
                             dim3((ka.Lq + 63) / 64, B * ka.H), tq, tk, tv,
                             tg, ka, stream);
  if (err != 0) return err;
  return launch_one(attention_bwd_dkv_sm90_kernel<kDrop, kNative>, dkv_smem,
                    dim3((ka.Lkv + 63) / 64, B * ka.H), tq, tk, tv, tg, ka,
                    stream);
}

}  // namespace

int attention_bwd_sm90(const Sm90AttentionBwd& a, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tg;
  BwdArgs ka{static_cast<__nv_bfloat16*>(a.dq),
             static_cast<__nv_bfloat16*>(a.dk),
             static_cast<__nv_bfloat16*>(a.dv),
             a.stats,
             a.kv_mask,
             a.H,
             a.Lq,
             a.Lkv,
             a.D,
             a.scale,
             a.scale * kLog2e,
             a.causal,
             a.prefix_len,
             a.seed,
             a.thresh,
             a.dropout ? 1.f / a.keep : 1.f,
             0,
             0,
             0,
             0,
             a.dropout ? a.keep : 1.f,
             a.delta};
  if (!make_map(&tq, &ka.q_head_inner, a.q, a.D, a.Lq, a.H, a.B, a.qb, a.qh,
                a.ql) ||
      !make_map(&tk, &ka.k_head_inner, a.k, a.D, a.Lkv, a.H, a.B, a.kb, a.kh,
                a.kl) ||
      !make_map(&tv, &ka.v_head_inner, a.v, a.D, a.Lkv, a.H, a.B, a.vb, a.vh,
                a.vl) ||
      !make_map(&tg, &ka.g_head_inner, a.g, a.D, a.Lq, a.H, a.B, a.gb, a.gh,
                a.gl))
    return (int)cudaErrorInvalidValue;
  if (a.native)
    return a.dropout ? launch<true, true>(tq, tk, tv, tg, ka, a.B, stream)
                     : launch<false, true>(tq, tk, tv, tg, ka, a.B, stream);
  return a.dropout ? launch<true, false>(tq, tk, tv, tg, ka, a.B, stream)
                   : launch<false, false>(tq, tk, tv, tg, ka, a.B, stream);
}

}  // namespace rtvc
