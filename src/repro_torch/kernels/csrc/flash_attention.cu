// GQA attention forward with an online softmax, for Hopper (sm_90a): K3.
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py:77
// (flash_attention, Pallas body _attn_kernel). There the kv-block axis of
// the grid runs in order and carries the running max m, the denominator l
// and the accumulator in VMEM scratch; here one block owns a tile of query
// rows and walks the K/V tiles in a loop, with m, l and the accumulator in
// registers.
//
// Computes, for q (B, Sq, H, Dh) and k, v (B, Skv, KH, Dh), all contiguous,
// G = H / KH and query head h = kh*G + g reading KV head kh:
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, kh],
//   s_ij = (q[b, i, h] . k[b, j, kh]) / sqrt(Dh)  over the unmasked j,
// masked where causal and pos_j > pos_i, or where window > 0 and pos_j <=
// pos_i - window, and where pos_j < 0. The positions are the indices
// (counted from 0 on both sides) or, in the position instantiations
// (template flag kPos), explicit q_pos (Sq,) and kv_pos (Skv,) int32,
// shared by the batch: what the reference's model path hands
// chunked_attention (src/repro/models/attention.py:72-80). Masked
// scores are -inf while the running max starts at -1e30, so their
// probabilities are exactly 0 and a fully masked row gives 0 (acc /
// max(l, 1e-30)). fp32 inputs, arithmetic and output (bf16 inputs go to
// flash_attention_bf16.cu). Ragged Sq and Skv are masked here, so nothing
// is padded.
//
// For training, an instantiation (template flag kLse) also writes each
// row's log-sum-exp of the scaled scores, lse[b, h, i] = m + log(l), in
// fp32, for the backward (csrc/flash_attention_bwd.cu) to recompute P
// from; a fully masked row gets +inf, so that exp(s - lse) is 0 there. The
// flag adds only these stores: the serving instantiation is the kernel as
// it was.
//
// The GQA fold: the G query heads of one KV head are G adjacent rows of
// the (Sq*G, Dh) row space (row = i*G + g), read in place by stride, so
// each K/V tile a block loads serves all G heads.
//
// What bounds it on this card: operations at prefill lengths. Each
// unmasked (query, key) pair of each head costs 4*Dh FLOPs (Dh
// multiply-adds for the score, Dh for P.V). At smollm-135m's prefill
// (B 8, S 1024, H 9, Dh 64, causal) that is 9.7 GFLOP. The fp32 tolerance
// of 2e-6 rules out plain TF32, so fp32 runs three TF32 products for each
// (split TF32): 29 GFLOP at 495 TFLOP/s is 0.0588 ms; the same work on the
// fp32 CUDA cores would take 0.145 ms at 67 TFLOP/s; the 50 MB it must move
// take 0.015 ms at 3.35 TB/s.
//
// What the design does about it:
// - Both products run on the tensor cores as wgmma.mma_async ... .tf32
//   with fp32 accumulators. Each operand x is split into big =
//   cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and a product is
//   small.big + big.small + big.big, the two small terms accumulated first
//   (split TF32, about fp32's accuracy). Q is not scaled before the
//   product (1/sqrt(Dh) is applied to the scores).
// - Warp roles: kWG consumer warpgroups of 128 threads, each owning 64
//   folded (query, head) rows, and one producer warp. The producer keeps a
//   ring of kStages raw K/V tiles in flight with TMA
//   (cp.async.bulk.tensor.3d over the (B, Skv, KH*Dh) view, out-of-range
//   keys zero-filled) and mbarriers (full: bytes landed; empty: consumers
//   done with the raw tile). The tensor maps are encoded on the host per
//   launch (they hold the base address) with cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint, so no -lcuda is needed.
// - TF32 wgmma takes only K-major operands from shared memory. Q (loaded
//   once) and each K tile are K-major as stored; the V tile is MN-major
//   for O = P.V, so the consumers write it transposed. All three are split
//   into big and small parts on the way into the canonical no-swizzle
//   layout (8 x 16-byte core matrices), which also lets the V keys be
//   permuted within each group of 8 so that the S accumulator fragment is
//   the A fragment of P.V without shuffles (a thread holds keys 2t, 2t+1
//   of the accumulator and positions t, t+4 of the A operand).
// - The online softmax (m, l and the masks, as a key range per row) runs
//   on the S accumulator fragments in registers; a row's 4 threads share
//   a quad, so its max and sum are two shfl_xor. With two warpgroups the
//   second starts its Q.K^T when the first's is done (a named barrier),
//   so each one's softmax overlaps the other's products.
// - Shared memory: Q big/small, one set of K and V big/small tiles, and
//   the raw ring, for fp32: 144 KB at Dh 48 (128 rows, 64-key tiles, 2
//   stages), 192 KB at Dh 64 (128 rows, 64-key tiles), at Dh 96 (128 rows,
//   32-key tiles: 64-key tiles would need 288 KB) and at Dh 128 (64 rows,
//   32-key tiles), 224 KB at Dh 112 (128 rows, 32-key tiles: 230,432
//   bytes with the barriers and the alignment slack, against the
//   232,448-byte opt-in limit), 192 KB at Dh 192 (64 rows, 16-key tiles:
//   Q's big and small halves alone take 96 KB, and 32-key tiles would need
//   288 KB), one block per SM.
// - P.V is issued 64 output columns at a time (three at Dh 192, whose 96
//   O accumulators a thread leave room for one 32-register product at a
//   time under one warpgroup's 255), or 48 at Dh 48 and 96 (m64n48k8) and
//   56 at Dh 112 (m64n56k8), so every width is whole wgmma products; S at
//   Dh 192 is m64n16k8 over 24 k-steps a term.
// - Causal schedule: the row tiles are the grid's slow axis, launched
//   heaviest (last rows) first; K/V tiles wholly outside the causal or
//   window band are skipped.
// - No 128-byte swizzle: it exists to let TMA land row-major tiles that
//   wgmma can read without bank conflicts. Here the consumers write the
//   split operands themselves, straight into the canonical layout, whose
//   core matrices are 128 contiguous bytes; each 8 threads write one.
// - The tensor core truncates as it accumulates, so a P.V chain over every
//   key drifts past the fp32 gate (3.5e-6 at smollm's prefill): each
//   tile's P.V is summed in fresh registers and joins O in one fp32 FMA.
// - Explicit positions (kPos): an M-RoPE prompt's image patches share one
//   temporal position, so positions tie and need not be sorted, and no
//   index band bounds the keys a row sees. Before the warp roles split,
//   the block reads its rows' least and greatest position and then every
//   key's position, and keeps the first and last key that any of its rows
//   may see (valid, at most its greatest position under causal, after its
//   least one's window start): the ring walks the tiles between them.
//   Each tile's key positions (-1 past Skv) go to shared memory beside
//   its K/V, written by the consumers with plain loads (no TMA, so no
//   alignment rule for them), and the softmax builds each element's mask
//   from them. For an arange the bounds are the index band's, so the
//   output and LSE are the index instantiation's bit for bit; a tile in
//   which a row sees nothing leaves its m, l and accumulator exactly as
//   they were (its scores are -inf, not the -1e30 that m starts at).
// The layout, split, wgmma, mbarrier and TMA helpers are in wgmma_tf32.cuh,
// shared with the backward.
// Left for later: overlapping the conversion with the products (the
// split tiles are single-buffered, so the warpgroups meet at two barriers
// a tile), and setmaxnreg for the consumers (ptxas gives 168 registers a
// thread to 288 threads; the fp32 serving instantiations spill 64 B at Dh
// 64, 132 B at 96 and 348 B at 112, whose 56 O accumulators a thread
// are the most).
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// Per head size: consumer warpgroups, keys a K/V tile, ring stages, and
// the output columns one P.V wgmma issues (48 at Dh 48 and 96 and 56 at
// Dh 112, whose tiles are not a multiple of 64 wide)
template <int DH> struct Cfg;
template <> struct Cfg<48> {
  static constexpr int kWG = 2, kKeys = 64, kStages = 2, kPV = 48;
};
template <> struct Cfg<64> {
  static constexpr int kWG = 2, kKeys = 64, kStages = 2, kPV = 64;
};
template <> struct Cfg<96> {
  static constexpr int kWG = 2, kKeys = 32, kStages = 2, kPV = 48;
};
template <> struct Cfg<112> {
  static constexpr int kWG = 2, kKeys = 32, kStages = 2, kPV = 56;
};
template <> struct Cfg<128> {
  static constexpr int kWG = 1, kKeys = 32, kStages = 2, kPV = 64;
};
template <> struct Cfg<192> {
  static constexpr int kWG = 1, kKeys = 16, kStages = 2, kPV = 64;
};

// Shared memory of one block, in bytes from a 1024-aligned base. The
// position instantiations add 4 bounds and a tile's key positions.
template <int DH, bool kPos>
struct Layout {
  static constexpr int kWG = Cfg<DH>::kWG, kKeys = Cfg<DH>::kKeys;
  static constexpr int kStages = Cfg<DH>::kStages;
  static constexpr int kRows = 64 * kWG;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;   // + the producer warp
  static constexpr uint32_t kQ = kRows * DH * 4;     // Q big, Q small
  static constexpr uint32_t kKV = kKeys * DH * 4;    // K, V big and small
  static constexpr uint32_t kTile = kKeys * DH * 4;  // raw K or V
  static constexpr uint32_t kQb = 0, kQs = kQ, kKb = 2 * kQ,
                            kKs = kKb + kKV, kVb = kKs + kKV,
                            kVs = kVb + kKV, kRaw = kVs + kKV,
                            kBars = kRaw + kStages * 2 * kTile;
  static constexpr uint32_t kPosAt = kBars + 2 * kStages * 8;
  static constexpr uint32_t kBytes =
      kPosAt + (kPos ? (4 + kKeys) * 4 : 0) + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB opt-in shared memory");
  static_assert(DH % Cfg<DH>::kPV == 0, "P.V must be whole wgmma products");
};

template <int DH, bool kLse, bool kPos>
__global__ void __launch_bounds__(Layout<DH, kPos>::kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v,
                       const float* __restrict__ q,
                       float* __restrict__ o,
                       float* __restrict__ lse,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, int Sq, int Skv,
                       int H, int KH, int causal, int window, float scale) {
  using L = Layout<DH, kPos>;
  constexpr int kKeys = L::kKeys, kRows = L::kRows, kStages = L::kStages;
  constexpr int kCons = L::kConsumers, kPV = Cfg<DH>::kPV;
  // S's parts of the head dim: 1, or 3 at Dh 192, whose 72-product
  // tensor-core chain a tile (24 k-steps x 3 split terms) drifted to 3.9e-6
  // against the plain version at deepseek-v3's prefill, past the 2e-6 gate
  constexpr int kSChunks = DH > 128 ? 3 : 1;
  // K's column groups of 4 are rotated within runs of kRot (8, or 4 at Dh
  // 48 and 112, whose 12 and 28 groups are not a multiple of 8). A raw row
  // of Dh 48 or 112 starts half a bank row (64 B) after the last, so rows
  // 2 apart share banks there: the rotation steps every second row.
  constexpr int kRot = (DH / 4) % 8 == 0 ? 8 : 4;
  constexpr int kRotShift = kRot == 8 ? 0 : 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw_base);
  const uint32_t full0 = base + L::kBars, empty0 = full0 + kStages * 8;

  const int G = H / KH;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int n_rows = Sq * G;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  // keys these rows can see: K/V tiles outside the band are skipped
  const int q_lo = row0 / G, q_hi = (min(row0 + kRows, n_rows) - 1) / G;
  const int tid = threadIdx.x;
  int t_begin, t_end;
  // explicit positions: bounds {least, greatest query position, first,
  // last key any row may see}, then the tile's key positions
  int* const bounds = reinterpret_cast<int*>(smem + L::kPosAt);
  int* const tile_pos = bounds + 4;
  if constexpr (kPos) {
    if (tid == 0) {
      bounds[0] = bounds[2] = INT_MAX;
      bounds[1] = bounds[3] = INT_MIN;
    }
    __syncthreads();
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = q_lo + tid; i <= q_hi; i += L::kThreads) {
      lo = min(lo, q_pos[i]);
      hi = max(hi, q_pos[i]);
    }
    block_min(bounds, lo);
    block_max(bounds + 1, hi);
    __syncthreads();
    const int qmin = bounds[0], qmax = bounds[1];
    lo = INT_MAX;
    hi = INT_MIN;
    for (int j = tid; j < Skv; j += L::kThreads) {
      const int kp = kv_pos[j];
      if (kp >= 0 && (!causal || kp <= qmax) &&
          (window <= 0 || kp > qmin - window)) {
        lo = min(lo, j);
        hi = max(hi, j);
      }
    }
    block_min(bounds + 2, lo);
    block_max(bounds + 3, hi);
    __syncthreads();
    const bool any = bounds[2] <= bounds[3];
    t_begin = any ? bounds[2] / kKeys : 0;
    t_end = any ? bounds[3] / kKeys + 1 : 0;
  } else {
    const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
    const int k_end = causal ? min(Skv, q_hi + 1) : Skv;
    t_begin = k_begin / kKeys;
    t_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : t_begin;
  }

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kCons) {  // the producer warp: one thread drives the TMA ring
    if (tid == kCons) {
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % kStages;
        mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t dst = base + L::kRaw + s * 2 * L::kTile;
        mbar_expect_tx(full, 2 * L::kTile);
        tma_load_3d(dst, &tmap_k, full, kh * DH, t * kKeys, b);
        tma_load_3d(dst + L::kTile, &tmap_v, full, kh * DH, t * kKeys, b);
      }
    }
    return;
  }

  // Q: this block's rows, unscaled, split, K-major; zeros past the end
  for (int i = tid; i < kRows * (DH / 4); i += kCons) {
    const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) {
      const int qi = row / G, g = row % G;
      x = load4(q + ((static_cast<int64_t>(b) * Sq + qi) * H + kh * G + g) *
                        DH + c);
    }
    float4 hi, lo;
    split4(x, hi, lo);
    const uint32_t off = kmajor(r, c, kRows);
    *reinterpret_cast<float4*>(smem + L::kQb + off) = hi;
    *reinterpret_cast<float4*>(smem + L::kQs + off) = lo;
  }

  // this thread's two rows of the warpgroup's 64 (the accumulator layout)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int rA = row0 + wg * 64 + warp * 16 + lane / 4, rB = rA + 8;
  const bool okA = rA < n_rows, okB = rB < n_rows;
  const int posA = rA / G, posB = rB / G;
  // the keys each of this thread's two rows sees are [lo, hi]
  const int hiA = okA ? (causal ? min(posA, Skv - 1) : Skv - 1) : -1;
  const int hiB = okB ? (causal ? min(posB, Skv - 1) : Skv - 1) : -1;
  const int loA = window > 0 ? posA - window + 1 : 0;
  const int loB = window > 0 ? posB - window + 1 : 0;
  int qpA = 0, qpB = 0;  // explicit positions of the two rows
  if constexpr (kPos) {
    qpA = okA ? q_pos[posA] : 0;
    qpB = okB ? q_pos[posB] : 0;
  }
  const uint32_t qb = base + L::kQb + wg * 2048, qs = base + L::kQs + wg * 2048;
  const uint32_t kb = base + L::kKb, ks = base + L::kKs;
  const uint32_t vb = base + L::kVb, vs = base + L::kVs;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[DH / 2];
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) acc[x] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, s = i % kStages;
    const int key0 = t * kKeys;
    consumers_sync<kCons>();  // every warpgroup is done with the last tile
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    const float* rk =
        reinterpret_cast<const float*>(smem + L::kRaw + s * 2 * L::kTile);
    const float* rv = rk + kKeys * DH;
    // K, split, K-major. Each 8 threads take rows r..r+7 at column groups
    // rotated by the row, so that reads and writes spread over the banks.
    for (int u = tid; u < kKeys * (DH / 4); u += kCons) {
      const int j = u & 7, rest = u >> 3;
      const int cc = rest % (DH / 4), r = (rest / (DH / 4)) * 8 + j;
      const int c =
          ((cc & ~(kRot - 1)) | ((cc + (j >> kRotShift)) & (kRot - 1))) * 4;
      float4 hi, lo;
      split4(load4(rk + r * DH + c), hi, lo);
      const uint32_t off = kmajor(r, c, kKeys);
      *reinterpret_cast<float4*>(smem + L::kKb + off) = hi;
      *reinterpret_cast<float4*>(smem + L::kKs + off) = lo;
    }
    if constexpr (kPos)  // the tile's key positions, -1 past Skv
      if (tid < kKeys)
        tile_pos[tid] = key0 + tid < Skv ? kv_pos[key0 + tid] : -1;
    // V transposed (row n = head dim, contraction over key positions),
    // split. Position p of each group of 8 keys holds key 2*(p%4) + p/4, so
    // the S fragment a thread holds (keys 2t, 2t+1) is its A fragment of
    // P.V (positions t, t+4).
    for (int u = tid; u < DH * (kKeys / 4); u += kCons) {
      const int n = u % DH, p4 = u / DH;
      const int k0 = (p4 >> 1) * 8 + (p4 & 1);
      const float4 x = make_float4(rv[k0 * DH + n], rv[(k0 + 2) * DH + n],
                                   rv[(k0 + 4) * DH + n],
                                   rv[(k0 + 6) * DH + n]);
      float4 hi, lo;
      split4(x, hi, lo);
      const uint32_t off = kmajor(n, p4 * 4, DH);
      *reinterpret_cast<float4*>(smem + L::kVb + off) = hi;
      *reinterpret_cast<float4*>(smem + L::kVs + off) = lo;
    }
    mbar_arrive(empty0 + 8 * s);  // the raw tile may be refilled
    // the split tiles were written by the generic proxy; wgmma reads them
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync<kCons>();

    // S = Q.K^T: small terms first. With two warpgroups the second starts
    // its products when the first's are done, so that one's softmax runs
    // while the other's products do.
    if constexpr (L::kWG == 2)
      if (wg == 1) asm volatile("bar.sync 2, 256;" ::: "memory");
    // (in kSChunks parts of the head dim, each summed in fresh registers:
    // the tensor core truncates as it accumulates)
    float sc[kKeys / 2];
#pragma unroll
    for (int c = 0; c < kSChunks; ++c) {
      constexpr int kC = DH / 8 / kSChunks;   // k-steps a part
      float part[kKeys / 2];
#pragma unroll
      for (int x = 0; x < kKeys / 2; ++x) part[x] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int k8 = c * kC; k8 < (c + 1) * kC; ++k8)
        wgmma_ss<kKeys>(part, desc(qs + k8 * kRows * 32),
                        desc(kb + k8 * kKeys * 32), k8 > c * kC);
#pragma unroll
      for (int k8 = c * kC; k8 < (c + 1) * kC; ++k8)
        wgmma_ss<kKeys>(part, desc(qb + k8 * kRows * 32),
                        desc(ks + k8 * kKeys * 32), 1);
#pragma unroll
      for (int k8 = c * kC; k8 < (c + 1) * kC; ++k8)
        wgmma_ss<kKeys>(part, desc(qb + k8 * kRows * 32),
                        desc(kb + k8 * kKeys * 32), 1);
      wgmma_commit_and_wait();
      fence_regs(part);
#pragma unroll
      for (int x = 0; x < kKeys / 2; ++x)
        sc[x] = c ? sc[x] + part[x] : part[x];
    }
    if constexpr (L::kWG == 2)
      if (wg == 0) asm volatile("bar.arrive 2, 256;" ::: "memory");

    // online softmax on the fragments: sc[4j + e] is (rA, key 8j + 2t4 + e)
    // and sc[4j + 2 + e] is (rB, the same key)
    float mxA = kNegInf, mxB = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * t4 + e;
        bool inA, inB;
        if constexpr (kPos) {
          const int kp = tile_pos[8 * j + 2 * t4 + e];
          inA = okA && sees(qpA, kp, causal, window);
          inB = okB && sees(qpB, kp, causal, window);
        } else {
          inA = key >= loA && key <= hiA;
          inB = key >= loB && key <= hiB;
        }
        sc[4 * j + e] = inA ? sc[4 * j + e] * scale : -INFINITY;
        sc[4 * j + 2 + e] = inB ? sc[4 * j + 2 + e] * scale : -INFINITY;
        mxA = fmaxf(mxA, sc[4 * j + e]);
        mxB = fmaxf(mxB, sc[4 * j + 2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
    }
    const float mA = fmaxf(m_a, mxA), mB = fmaxf(m_b, mxB);
    const float cA = expf(m_a - mA), cB = expf(m_b - mB);
    m_a = mA;
    m_b = mB;
    uint32_t pb[kKeys / 2], ps[kKeys / 2];
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int x = 0; x < kKeys / 2; ++x) {
      const bool rowA = (x & 2) == 0;
      const float p = expf(sc[x] - (rowA ? mA : mB));  // masked: exp(-inf)
      if (rowA) sumA += p;
      else sumB += p;
      pb[x] = tf32(p);
      ps[x] = tf32(p - __uint_as_float(pb[x]));
    }
    l_a = l_a * cA + sumA;  // this thread's keys; the quad sums at the end
    l_b = l_b * cB + sumB;

    // O = O*corr + P.V, kPV output columns at a time: the tile's P.V in
    // fresh registers, small terms first, then one rounded fp32 FMA
#pragma unroll
    for (int c = 0; c < DH / kPV; ++c) {
      float pv[kPV / 2];
#pragma unroll
      for (int x = 0; x < kPV / 2; ++x) pv[x] = 0.f;
      const uint32_t vbc = vb + c * kPV * 32, vsc = vs + c * kPV * 32;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        wgmma_rs<kPV>(pv, ps[4 * j], ps[4 * j + 2], ps[4 * j + 1],
                      ps[4 * j + 3], desc(vbc + j * DH * 32));
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        wgmma_rs<kPV>(pv, pb[4 * j], pb[4 * j + 2], pb[4 * j + 1],
                      pb[4 * j + 3], desc(vsc + j * DH * 32));
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        wgmma_rs<kPV>(pv, pb[4 * j], pb[4 * j + 2], pb[4 * j + 1],
                      pb[4 * j + 3], desc(vbc + j * DH * 32));
      wgmma_commit_and_wait();
      fence_regs(pv);
#pragma unroll
      for (int x = 0; x < kPV / 2; ++x)
        acc[kPV / 2 * c + x] =
            fmaf(acc[kPV / 2 * c + x], (x & 2) ? cB : cA, pv[x]);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float dA = fmaxf(l_a, 1e-30f), dB = fmaxf(l_b, 1e-30f);
  if constexpr (kLse) {  // (B, H, Sq); one thread of the row's quad writes
    const int64_t bh = static_cast<int64_t>(b) * H + kh * G;
    if (okA && t4 == 0)
      lse[(bh + rA % G) * Sq + posA] = l_a > 0.f ? m_a + logf(l_a) : INFINITY;
    if (okB && t4 == 0)
      lse[(bh + rB % G) * Sq + posB] = l_b > 0.f ? m_b + logf(l_b) : INFINITY;
  }
  if (okA) {
    float* dst =
        o + ((static_cast<int64_t>(b) * Sq + posA) * H + kh * G + rA % G) *
                DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      store2(dst + 8 * j + 2 * t4, acc[4 * j] / dA, acc[4 * j + 1] / dA);
  }
  if (okB) {
    float* dst =
        o + ((static_cast<int64_t>(b) * Sq + posB) * H + kh * G + rB % G) *
                DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      store2(dst + 8 * j + 2 * t4, acc[4 * j + 2] / dB, acc[4 * j + 3] / dB);
  }
}

// The (B, Skv, KH*Dh) view of k or v, read in boxes of (1, keys, Dh);
// keys past Skv read as zeros. Returns 0, or kEncodeError + the CUresult.
int encode(CUtensorMap* map, const void* base, int B, int Skv, int KH,
           int DH, int keys) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t es = 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(KH) * DH,
                              static_cast<cuuint64_t>(Skv),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {dims[0] * es, dims[0] * dims[1] * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(DH),
                             static_cast<cuuint32_t>(keys), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int DH, bool kLse, bool kPos>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* q_pos, const int* kv_pos, int B, int Sq, int Skv,
           int H, int KH, int causal, int window, cudaStream_t st) {
  using L = Layout<DH, kPos>;
  static bool configured = false;  // the attribute holds per function
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<DH, kLse, kPos>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int G = H / KH;
  const long long tiles = (static_cast<long long>(Sq) * G + L::kRows - 1) /
                          L::kRows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_k, map_v;
  int rc = encode(&map_k, k, B, Skv, KH, DH, L::kKeys);
  if (rc == 0) rc = encode(&map_v, v, B, Skv, KH, DH, L::kKeys);
  if (rc != 0) return rc;
  const dim3 grid(B * KH, static_cast<unsigned>(tiles));
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  flash_attention_kernel<DH, kLse, kPos>
      <<<grid, L::kThreads, L::kBytes, st>>>(
          map_k, map_v, static_cast<const float*>(q),
          static_cast<float*>(o), lse,
          q_pos, kv_pos, Sq, Skv, H, KH, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// One head size and mask source: the training instantiation when lse is
// set, else the serving one.
template <int DH, bool kPos>
int dispatch_lse(const void* q, const void* k, const void* v, void* o,
                 float* lse, const int* q_pos, const int* kv_pos, int B,
                 int Sq, int Skv, int H, int KH, int causal, int window,
                 cudaStream_t st) {
  if (lse != nullptr)
    return launch<DH, true, kPos>(q, k, v, o, lse, q_pos, kv_pos, B, Sq, Skv,
                                  H, KH, causal, window, st);
  return launch<DH, false, kPos>(q, k, v, o, lse, q_pos, kv_pos, B, Sq, Skv,
                                 H, KH, causal, window, st);
}

// The position instantiations when q_pos is set, else the index ones.
template <int DH>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, const int* q_pos, const int* kv_pos, int B, int Sq,
             int Skv, int H, int KH, int causal, int window,
             cudaStream_t st) {
  if (q_pos != nullptr)
    return dispatch_lse<DH, true>(q, k, v, o, lse, q_pos, kv_pos, B, Sq,
                                  Skv, H, KH, causal, window, st);
  return dispatch_lse<DH, false>(q, k, v, o, lse, q_pos, kv_pos, B, Sq, Skv,
                                 H, KH, causal, window, st);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a head size other than 48, 64, 96, 112, 128 or
// 192 or more than 65535 row tiles, or 10000 + the CUresult if a tensor map
// cannot be encoded. q, o: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh); fp32,
// contiguous, 16-byte aligned (TMA's rule). lse: null (serving), or (B, H,
// Sq) fp32 written by the training instantiation. q_pos, kv_pos: both null
// (mask by index), or (Sq,) and (Skv,) contiguous int32 (mask by them; a
// cudaErrorInvalidValue if only one is set).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const void* q_pos, const void* kv_pos,
                                      int B, int Sq, int Skv, int H, int KH,
                                      int Dh, int causal, int window,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if ((q_pos == nullptr) != (kv_pos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  switch (Dh) {
    case 48:
      return dispatch<48>(q, k, v, o, l, qp, kp, B, Sq, Skv, H, KH, causal,
                          window, st);
    case 64:
      return dispatch<64>(q, k, v, o, l, qp, kp, B, Sq, Skv, H, KH, causal,
                          window, st);
    case 96:
      return dispatch<96>(q, k, v, o, l, qp, kp, B, Sq, Skv, H, KH, causal,
                          window, st);
    case 112:
      return dispatch<112>(q, k, v, o, l, qp, kp, B, Sq, Skv, H, KH, causal,
                           window, st);
    case 128:
      return dispatch<128>(q, k, v, o, l, qp, kp, B, Sq, Skv, H, KH, causal,
                           window, st);
    case 192:
      return dispatch<192>(q, k, v, o, l, qp, kp, B, Sq, Skv, H, KH, causal,
                           window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
