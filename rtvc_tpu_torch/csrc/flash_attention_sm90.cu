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
