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
// float32 1 - rate. The row max is known only after a sweep, and Delta
// needs the normaliser, so attention_bwd_dq_native_sm90_kernel sweeps the
// keys four times: S for the max, S for the normaliser, S and dP for Delta,
// S and dP for dS and dQ += dS K; its stats are (max, bf16(1 / z), Delta).
// The dK/dV kernel serves both modes (kNative): P^T from those stats.
// The bound counts the function's own five products, as K8's.

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
};

// the score x of (row, key), already in the log2 domain, as _block_probs
// masks it; `kept` is the key mask's verdict
__device__ __forceinline__ float masked(float x, int row, int key, bool kept,
                                        const BwdArgs& a,
                                        float sentinel = kMasked) {
  const bool ok = kept && (!a.causal || key < a.prefix_len || key <= row);
  return key < a.Lkv ? (ok ? x : sentinel) : -INFINITY;
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

// Kernel 1n: K8n's dQ and row statistics, one block per (64 query rows,
// batch x head): four sweeps over the keys (see the note at the top). The
// producer streams K alone for the first two and K with V for the others.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    attention_bwd_dq_native_sm90_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tg, const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sG = sQ + kTile;
  const uint32_t sK = sG + kTile;
  const uint32_t sV = sK + kStages * kTile;
  const uint32_t q_full = sV + kStages * kTile;
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
      mbar_init(empty0 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: Q and dO once, then K (sweeps 1-2), K and V (3-4) ----
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * kTile);
      tma_rows(sQ, &tq, q_full, a.q_head_inner, q0, h, b);
      tma_rows(sG, &tg, q_full, a.g_head_inner, q0, h, b);
      for (int u = 0; u < 4 * tiles; ++u) {
        const int s = u % kStages, t = u % tiles;
        const bool with_v = u >= 2 * tiles;
        mbar_wait(empty0 + 8 * s, ((u / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, with_v ? 2 * kTile : kTile);
        tma_rows(sK + s * kTile, &tk, full0 + 8 * s, a.k_head_inner, t * 64,
                 h, b);
        if (with_v)
          tma_rows(sV + s * kTile, &tv, full0 + 8 * s, a.v_head_inner,
                   t * 64, h, b);
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
  const float scale_b = bf16r(a.scale);
  uint64_t dq[4], dg[4], dk[4], dv[4];
  float sc[32], dp[32], x[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, rz[2];
  float delta[2] = {0.f, 0.f};
  uint32_t dhi[16], dlo[16];
  mbar_wait(q_full, 0);

  // S (and with `with_dp` dP) of ring slot u, waited; the slot stays full
  auto products = [&](int u, bool with_dp) {
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
    if (with_dp) issue_s(dp, dg, dv);
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);
    native_scores(sc, x, (u % tiles) * 64, r, a, scale_b);
  };
  auto release = [&](int u) {
    if (lane == 0) mbar_arrive(empty0 + 8 * (u % kStages));
  };
  auto quad_reduce = [&](float (&v)[2], bool is_max) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v[j], off);
        v[j] = is_max ? fmaxf(v[j], o) : v[j] + o;
      }
    }
  };

  // sweep 1: the bf16 row max
  for (int t = 0; t < tiles; ++t) {
    products(t, false);
    release(t);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], x[i]);
  }
  quad_reduce(m, true);
  // sweep 2: the float32 normaliser of the bf16 exponentials
  for (int t = 0; t < tiles; ++t) {
    products(tiles + t, false);
    release(tiles + t);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      z[j] += bf16r(expf(bf16r(x[i] - m[j])));
    }
  }
  quad_reduce(z, false);
#pragma unroll
  for (int j = 0; j < 2; ++j) rz[j] = bf16r(1.f / z[j]);
  // sweep 3: Delta = Sum P dP, dP 0 where dropped, / keep where kept
  for (int t = 0; t < tiles; ++t) {
    const int u = 2 * tiles + t;
    products(u, true);
    release(u);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      delta[j] += native_prob(x[i], m[j], rz[j]) *
                  kept_dp<kDrop>(dp[i], a, b, h, j ? r.row1 : r.row0,
                                 t * 64 + 8 * (i / 4) + r.cq + (i & 1));
    }
  }
  quad_reduce(delta, false);
  // sweep 4: dS = P o (dP - Delta) as bf16 hi + lo, dQ += dS K
  for (int t = 0; t < tiles; ++t) {
    const int u = 3 * tiles + t, s = u % kStages;
    products(u, true);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int j = (i >> 1) & 1;
      const int row = j ? r.row1 : r.row0, key = t * 64 + 8 * (i / 4) + r.cq;
      const float d0 = kept_dp<kDrop>(dp[i], a, b, h, row, key);
      const float d1 = kept_dp<kDrop>(dp[i + 1], a, b, h, row, key + 1);
      split(native_prob(x[i], m[j], rz[j]) * (d0 - delta[j]),
            native_prob(x[i + 1], m[j], rz[j]) * (d1 - delta[j]), dhi[i / 2],
            dlo[i / 2]);
    }
    fence_regs(acc);
    fence_regs(dhi);
    fence_regs(dlo);
    uint64_t dkm[4];
    tile_descs<128>(dkm, sK + s * kTile);
    wgmma_fence();
    issue_pv(acc, dhi, dlo, dkm);
    wgmma_wait();
    fence_regs(acc);
    release(u);
  }

  // epilogue: dQ * scale in bf16; the rows' (max, bf16(1 / z), Delta)
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
      st[64 + i] = rz[k];
      st[128 + i] = delta[k];
    }
  }
}

// Kernel 2: dK and dV, one block per (64 keys, batch x head). A thread
// holds keys key0 and key0 + 8 (the m64 fragment's rows) and, per q tile,
// the rows q0 + 8 j + cq (+ 1) (its columns). kNative takes P^T in the
// input-dtype softmax from K8n's stats.
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
  const float* stats = a.stats + (size_t)blockIdx.y * qtiles * 192;
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
        bulk_load(sSt + s * kStatBytes, stats + t * 192, kStatBytes,
                  full0 + 8 * s);
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
  const float scale_b = bf16r(a.scale), keep_b = bf16r(a.keep);
  const float masked_b = bf16r(kMasked);
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
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int key = (i & 2) ? key1 : key0;
      const bool kept_key = (i & 2) ? kept1 : kept0;
      float pu[2], ds[2];
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = 8 * (i / 4) + cq + c2, row = q0 + c;
        const float y = kNative ? bf16r(bf16r(st[i + c2]) * scale_b)
                                : st[i + c2] * a.scale_log2;
        const float x =
            whole ? y
                  : (row < a.Lq ? masked(y, row, key, kept_key, a,
                                         kNative ? masked_b : kMasked)
                                : -INFINITY);
        const float p = kNative ? native_prob(x, sm[c], sm[64 + c])
                                : ex2(x - sm[c]) * sm[64 + c];
        float d = dpt[i + c2];
        pu[c2] = p;
        if (kDrop) {
          const bool drop = dropped(a, b, h, row, key);
          pu[c2] = drop ? 0.f : kNative ? bf16r(p / keep_b) : p * a.inv_keep;
          d = drop ? 0.f : d * a.inv_keep;
        }
        ds[c2] = p * (d - sm[128 + c]);
      }
      split(pu[0], pu[1], phi[i / 2], plo[i / 2]);
      split(ds[0], ds[1], dhi[i / 2], dlo[i / 2]);
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
    issue_pv(dv, phi, plo, dg_);  // dV += drop(P)^T dO
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
  const int err = launch_one(kNative
                                 ? attention_bwd_dq_native_sm90_kernel<kDrop>
                                 : attention_bwd_dq_sm90_kernel<kDrop>,
                             dq_smem, dim3((ka.Lq + 63) / 64, B * ka.H), tq,
                             tk, tv, tg, ka, stream);
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
             a.dropout ? a.keep : 1.f};
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
