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
//
// K4n: the same function in the TPU kernel's input-dtype softmax
// (_block_probs with softmax_native, bf16 inputs): the float32 score rounded
// to bf16 and multiplied by bf16(scale) in bf16; masked scores bf16(-1e30);
// the row max and e = exp(s - max) in bf16; z = Sum float32(e); p =
// bf16(e * bf16(1 / z)); a kept p becomes bf16(p / bf16(1 - rate)) (0.8984375
// at rate 0.1); the output Sum p v in float32, rounded to bf16. Every e is
// rounded at the row's FINAL max, which an online softmax cannot rescale to,
// so attention_native_sm90_kernel takes three sweeps over the keys. The
// bound is the function's own work, one Q K^T and one P V, as K4's; the
// arithmetic a score, not the products, is what costs (the first design
// took six bf16 roundings and two accurate expf a score). The design:
// - Sweep 1, the row max, is the Q K^T products and one fmaxf a score.
//   x = bf16(bf16(s) * bf16(scale)) does not decrease as the float32 score
//   s grows when bf16(scale) > 0 (each step is a rounding or a positive
//   multiply), so the max of the x is that map of the raw max of the
//   allowed scores; a disallowed key below Lkv raises it to bf16(-1e30) at
//   least (a flag a row). A scale that rounds to <= 0 takes the scores
//   themselves (native_scores).
// - Sweeps 2 and 3 work on bf16 pairs: one cvt.rn.bf16x2.f32 a pair of
//   scores, then mul.rn / sub.rn.bf16x2 for x and x - max, and for e *
//   bf16(1 / z): each one rounding of the exact result, equal to the
//   per-score bf16r(float32 op) (the argument is in
//   flash_attention_sm90.cuh).
// - The exponential and the dropout division are exact and fast
//   (native_exp, native_div): ex2.approx and a multiply, bracketed, with
//   expf or a division only where a bf16 rounding midpoint lies inside the
//   bracket, one branch a tile. native_probe_sm90 checks both against PR
//   11's formulas on every input of their bf16 domains.
// - A key mask is read once a block into shared-memory bits, one 64-bit
//   word a tile (the first design read a mask byte a key a sweep).
// - In sweeps 1 and 2 both operands of S come from shared memory, so S of
//   tile t + 1 is in flight while tile t's arithmetic runs (two S
//   accumulators, wgmma.wait_group 1: pipelined_sweep). Sweep 3 waits for
//   S of t + 1 and P V of t together before writing P (C7513, as K4).
// - x lives in 16 bf16x2 registers, not 32 floats: three blocks an SM, as
//   K4 runs, each with a four-stage ring (K4: three).
// - With the statistics pointer set (autograd will need them), the rows'
//   (max, bf16(1 / z)) go to float32 [B H ceil(Lq / 64)][2][64] for K8n;
//   the stats-only instance stops there (a standalone backward).

#include "common.cuh"
#include "flash_attention_sm90.cuh"

namespace rtvc {
namespace {

constexpr int kRows = 64;    // query rows per consumer warpgroup
constexpr int kKeys = 64;    // keys per K/V tile
constexpr int kDim = 64;     // head dim of a tile; D < 64 is zero-padded
constexpr int kStages = 3;   // K/V ring depth
constexpr int kNStages = 4;  // K4n's ring: three blocks an SM still fit
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
  float scale, keep;  // as given: K4n rounds both to bf16
  float* stats;       // K4n: the rows' (max, bf16(1 / z)), or null
};

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

// K4n's place of a thread: K4's, and the key mask's bits in shared memory
// (load_kept_bits) or null
struct NRows : Rows {
  const uint32_t* bits;
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

// K4n: one consumer warpgroup (64 query rows) + one producer warp, three
// blocks an SM, three sweeps over the keys (see the note at the top). The
// producer streams K alone for the first two sweeps and K with V for the
// third through the one ring. kStatsOnly stops after the second sweep
// with the rows' (max, bf16(1 / z)) written: the statistics K8n takes
// where no forward of autograd left them.
template <bool kDrop, bool kStatsOnly>
__global__ void __launch_bounds__(kThreads, 3)
    attention_native_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const KernelArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kTile;
  const uint32_t sV = sK + kNStages * kTile;
  const uint32_t q_full = sV + kNStages * kTile;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kNStages;
  // the key mask's bits, 2 words a tile
  uint32_t* bits = reinterpret_cast<uint32_t*>(
      smem_raw + (empty0 + 8 * kNStages - raw_base));

  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int q0 = blockIdx.x * kRows;
  const int tiles = (a.Lkv + kKeys - 1) / kKeys;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kNStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: Q once, K for sweeps 1 and 2, K and V for sweep 3 ----
    if (lane == 0) {
      mbar_expect_tx(q_full, kTile);
      tma_rows(sQ, &tq, q_full, a.q_head_inner, q0, h, b);
      for (int u = 0; u < (kStatsOnly ? 2 : 3) * tiles; ++u) {
        const int s = u % kNStages, t = u % tiles;
        const bool with_v = u >= 2 * tiles;
        mbar_wait(empty0 + 8 * s, ((u / kNStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, with_v ? 2 * kTile : kTile);
        tma_rows(sK + s * kTile, &tk, full0 + 8 * s, a.k_head_inner,
                 t * kKeys, h, b);
        if (with_v)
          tma_rows(sV + s * kTile, &tv, full0 + 8 * s, a.v_head_inner,
                   t * kKeys, h, b);
      }
    }
    return;
  }
  // ---- consumer warpgroup: rows q0 + [0, 64) ----
  NRows r;
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
  const float scale_b = bf16r(a.scale), keep_b = bf16r(a.keep);
  const uint32_t scale2 = bcast2(scale_b);
  uint64_t dq[4], dk[4], dv[4];
  float sa[32], sb[32];
  mbar_wait(q_full, 0);
  tile_descs<2>(dq, sQ);

  // S of ring slot u into acc, issued and committed; Q Q^T where !real
  auto issue = [&](float (&acc)[32], int u, bool real) {
    const int s = u % kNStages;
    if (real) mbar_wait(full0 + 8 * s, (u / kNStages) & 1);
    tile_descs<2>(dk, real ? sK + s * kTile : sQ);
    fence_regs(acc);
    wgmma_fence();
    issue_s(acc, dq, dk);
  };
  auto release = [&](int u) {
    if (lane == 0) mbar_arrive(empty0 + 8 * (u % kNStages));
  };

  // sweep 1: the row max. bf16(bf16(s) * scale_b) does not decrease as s
  // grows (scale_b > 0), so the max of the scores is that of the raw max
  // of the allowed keys, or bf16(-1e30) where a disallowed key below Lkv
  // scores more: the products and one fmaxf a score. A scale_b <= 0 takes
  // the scores themselves.
  float raw[2] = {-INFINITY, -INFINITY};
  int flag[2] = {0, 0};
  const bool monotone = scale_b > 0.f;
  auto max_tile = [&](float (&s)[32], int t) {
    fence_regs(s);
    const int k0 = t * kKeys;
    if (!monotone) {
      float x[32];
      native_scores(s, x, k0, r, a, scale_b);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], x[i]);
    } else if (native_whole(k0, r, a)) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], s[i]);
    } else {
      // the allowed scores' max; flag where a disallowed key below Lkv is
      uint64_t ok[2];
      tile_allowed(r, a, k0, ok);
      const int n = min(a.Lkv - k0 - r.cq, 64);  // the thread's keys < Lkv
      const uint64_t in = n <= 0 ? 0ull : ~0ull >> (64 - n);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        flag[j] |= ((in & ~ok[j]) & 0x0303030303030303ull) != 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = (i >> 1) & 1;
        raw[j] = fmaxf(raw[j], (ok[j] >> (8 * (i / 4) + (i & 1))) & 1
                                   ? s[i]
                                   : -INFINITY);
      }
    }
  };
  pipelined_sweep<1>(sa, sb, 0, tiles, issue, release, max_tile);
  float m[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      raw[j] = fmaxf(raw[j], __shfl_xor_sync(0xffffffffu, raw[j], off));
      flag[j] |= __shfl_xor_sync(0xffffffffu, flag[j], off);
    }
    m[j] = monotone ? fmaxf(bf16r(bf16r(raw[j]) * scale_b),
                            flag[j] ? bf16r(kMasked) : -INFINITY)
                    : raw[j];
  }
  const uint32_t m2[2] = {bcast2(m[0]), bcast2(m[1])};

  // sweep 2: z = Sum float32(e), e = bf16(exp(bf16(x - max))), in pairs
  float z[2] = {0.f, 0.f};
  auto sum_tile = [&](float (&s)[32], int t) {
    fence_regs(s);
    uint32_t x2[16], e2[16];
    native_pairs(s, x2, t * kKeys, r, a, scale2);
#pragma unroll
    for (int q = 0; q < 16; ++q) x2[q] = bsub2(x2[q], m2[q & 1]);
    native_exp(x2, e2);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float2 e = unpack_bf16(e2[q]);
      z[q & 1] += e.x + e.y;
    }
  };
  pipelined_sweep<1>(sa, sb, tiles, tiles, issue, release, sum_tile);
  float rz[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      z[j] += __shfl_xor_sync(0xffffffffu, z[j], off);
    rz[j] = bf16r(1.f / z[j]);
  }
  if (a.stats != nullptr && lane % 4 == 0) {
    // the rows' (max, bf16(1 / z)), 64 rows a tile: K8n's statistics
    float* st = a.stats + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 128;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = (k ? r.row1 : r.row0) - q0;
      st[i] = m[k];
      st[64 + i] = rz[k];
    }
  }
  if (kStatsOnly) return;

  // sweep 3: p = bf16(e * bf16(1 / z)), dropped or divided by bf16(keep),
  // then O += P V. S of tile t + 1 and P V of tile t go to the tensor cores
  // together; P is written only once both are done (C7513, see K4).
  const uint32_t rz2[2] = {bcast2(rz[0]), bcast2(rz[1])};
  const float inv_lo = __fdiv_rd(1.f, keep_b), inv_hi = __fdiv_ru(1.f, keep_b);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  uint32_t p[16];
  auto probs = [&](int t) {
    uint32_t x2[16];
    native_pairs(sa, x2, t * kKeys, r, a, scale2);
#pragma unroll
    for (int q = 0; q < 16; ++q) x2[q] = bsub2(x2[q], m2[q & 1]);
    native_exp(x2, p);
#pragma unroll
    for (int q = 0; q < 16; ++q) p[q] = bmul2(p[q], rz2[q & 1]);
    if (kDrop) {
      native_div(p, inv_lo, inv_hi, keep_b);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int row = (q & 1) ? r.row1 : r.row0;
        const int key = t * kKeys + 8 * (q / 2) + r.cq;
        p[q] &= (dropout_bits(a.seed, b, h, row, key) < a.thresh ? 0u
                                                                  : 0xFFFFu) |
                (dropout_bits(a.seed, b, h, row, key + 1) < a.thresh
                     ? 0u
                     : 0xFFFF0000u);
      }
    }
  };
  const int u0 = 2 * tiles;
  issue(sa, u0, true);
  wgmma_wait();
  fence_regs(sa);
  probs(0);
  for (int t = 0; t + 1 < tiles; ++t) {
    const int s = (u0 + t) % kNStages, s1 = (u0 + t + 1) % kNStages;
    mbar_wait(full0 + 8 * s1, ((u0 + t + 1) / kNStages) & 1);
    fence_regs(sa);
    fence_regs(o);
    fence_regs(p);
    tile_descs<2>(dk, sK + s1 * kTile);
    tile_descs<128>(dv, sV + s * kTile);
    wgmma_fence();
    issue_s(sa, dq, dk);
    issue_pv1(o, p, dv);
    wgmma_wait();
    fence_regs(sa);
    fence_regs(o);
    release(u0 + t);
    probs(t + 1);
  }
  fence_regs(o);
  fence_regs(p);
  tile_descs<128>(dv, sV + (u0 + tiles - 1) % kNStages * kTile);
  wgmma_fence();
  issue_pv1(o, p, dv);
  wgmma_wait();
  fence_regs(o);
  release(u0 + tiles - 1);

  // epilogue: O rounded to bf16 (P is normalised already)
  __nv_bfloat16* op = a.out + b * a.ob + h * a.oh;
  const bool pairs = (a.D % 2) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + r.cq;
    if (col >= a.D) continue;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = k ? r.row1 : r.row0;
      if (row >= a.Lq) continue;
      const float x0 = o[4 * j + 2 * k], x1 = o[4 * j + 2 * k + 1];
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

template <bool kDrop, bool kNative, bool kStatsOnly = false>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const KernelArgs& ka, int B,
           cudaStream_t stream) {
  // K4n: its deeper ring and the key mask's bits, 8 bytes a key tile
  const int stages = kNative ? kNStages : kStages;
  const int smem = (1 + 2 * stages) * kTile + 8 * (1 + 2 * stages) + 1024 +
                   (kNative ? 8 * ((ka.Lkv + kKeys - 1) / kKeys) : 0);
  auto kernel = kNative ? attention_native_sm90_kernel<kDrop, kStatsOnly>
                        : attention_sm90_kernel<kDrop>;
  // the largest shared memory this kernel was allowed so far
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    allowed = smem;
  }
  const dim3 grid((ka.Lq + kRows - 1) / kRows, B * ka.H);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, ka);
  return (int)cudaGetLastError();
}

// The probe: one thread per bf16 bit pattern, each value in both halves
// of a pair (the fallback is taken for a pair, so a value's result does not
// depend on its neighbour's).
__global__ void native_probe_kernel(int* out, float keep) {
  const uint32_t bits = blockIdx.x * blockDim.x + threadIdx.x;
  if (bits > 0xFFFFu) return;
  const float v = __uint_as_float(bits << 16);
  const uint32_t v2 = bits | (bits << 16);
  if (bits == 0 || (bits >= 0x8000u && bits <= kNegInfBf16)) {
    // d <= 0 or -inf
    int slow = 0;
    const uint32_t d2[1] = {v2};
    uint32_t e2[1];
    native_exp(d2, e2, &slow);
    const uint32_t got = e2[0], want = pack_bf16(expf(v), expf(v));
    atomicAdd(out, 1);
    if (got != want) atomicAdd(out + 1, 1);
    if (slow) atomicAdd(out + 2, 1);
    const float y = ex2(fmaf(v, 1.4426950408889634f, kExpShift));
    const float e = expf(v);
    if (e >= 0x1p-126f) {  // a normal expf(d): the bracket's argument
      if (!(y * kExpLo <= e && e <= y * kExpHi)) atomicAdd(out + 3, 1);
      atomicMax(out + 4, (int)__float_as_uint(
                             fabsf(y * 0x1p-10f / e - 1.f)));
    }
  }
  if (bits <= 0x3F80u) {  // p in [0, 1]
    const float keep_b = bf16r(keep);
    int slow = 0;
    uint32_t p2[1] = {v2};
    native_div(p2, __fdiv_rd(1.f, keep_b), __fdiv_ru(1.f, keep_b), keep_b,
               &slow);
    const float q = bf16r(v / keep_b);
    atomicAdd(out + 5, 1);
    if (p2[0] != pack_bf16(q, q)) atomicAdd(out + 6, 1);
    if (slow) atomicAdd(out + 7, 1);
  }
}

}  // namespace

int native_probe_sm90(int* out, float keep, cudaStream_t stream) {
  native_probe_kernel<<<256, 256, 0, stream>>>(out, keep);
  return (int)cudaGetLastError();
}

int attention_sm90(const Sm90Attention& a, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  KernelArgs ka{static_cast<__nv_bfloat16*>(a.out), a.kv_mask, a.H, a.Lq,
                a.Lkv, a.D, a.ob, a.oh, a.ol, a.scale * kLog2e, a.causal,
                a.prefix_len, a.seed, a.thresh,
                a.dropout ? 1.f / a.keep : 1.f, 0, 0, 0, a.scale, a.keep,
                a.stats};
  if (!make_map(&tq, &ka.q_head_inner, a.q, a.D, a.Lq, a.H, a.B, a.qb, a.qh,
                a.ql) ||
      !make_map(&tk, &ka.k_head_inner, a.k, a.D, a.Lkv, a.H, a.B, a.kb, a.kh,
                a.kl) ||
      !make_map(&tv, &ka.v_head_inner, a.v, a.D, a.Lkv, a.H, a.B, a.vb, a.vh,
                a.vl))
    return (int)cudaErrorInvalidValue;
  if (a.stats_only)  // dropout leaves the statistics as they are
    return launch<false, true, true>(tq, tk, tv, ka, a.B, stream);
  if (a.native)
    return a.dropout ? launch<true, true>(tq, tk, tv, ka, a.B, stream)
                     : launch<false, true>(tq, tk, tv, ka, a.B, stream);
  return a.dropout ? launch<true, false>(tq, tk, tv, ka, a.B, stream)
                   : launch<false, false>(tq, tk, tv, ka, a.B, stream);
}

}  // namespace rtvc
