// GQA attention forward in bf16 with an online softmax, for Hopper
// (sm_90a): K3's bf16 route.
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py:77
// (flash_attention, Pallas body _attn_kernel) for bf16 inputs, as
// flash_attention.cu does for fp32. One block owns a tile of query rows
// and walks the K/V tiles in a loop, with the running max m, the
// denominator l and the accumulator in registers.
//
// Computes, for q (B, Sq, H, Dh) and k, v (B, Skv, KH, Dh), all bf16 and
// contiguous, G = H / KH and query head h = kh*G + g reading KV head kh:
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, kh],
//   s_ij = (q[b, i, h] . k[b, j, kh]) / sqrt(Dh)  over the unmasked j,
// with flash_attention.cu's masks (causal, window, pos_j < 0; positions
// the indices or, in the kPos instantiations, explicit q_pos and kv_pos
// int32) and its numerics for a fully masked row (0, LSE +inf). As the
// reference's chunked_attention (src/repro/models/attention.py:90) does,
// the unnormalised P is rounded to bf16 before P.V, while l sums it in
// fp32; S, the softmax and every sum are fp32. The training
// instantiation (kLse) writes the output in fp32 and each row's
// log-sum-exp, lse[b, h, i] = m + log(l), in fp32 (the backward's D reads
// the output unrounded); the wrapper rounds that output to bf16, the bits
// the serving instantiation writes. The flag adds only these stores.
//
// What bounds it on this card: operations. Each unmasked (query, key)
// pair of each head costs 4*Dh FLOPs. At starcoder2-15b's prefill (B 4, S
// 4600, H 48 over KH 4, Dh 128, window 4096) that is 1.03 TFLOP: 1.04 ms at
// bf16's 989 TFLOP/s; its 113 MB take 0.034 ms at 3.35 TB/s.
//
// What the design does about it:
// - Both products are bf16 wgmma.mma_async with fp32 accumulators, one
//   instruction a k-step of 16 (wgmma_bf16.cuh): S = Q.K^T with Q and K
//   K-major in shared memory, and O += P.V with P as the register A
//   operand (the S accumulator fragment rounded to bf16 pairs in place: a
//   thread's accumulator columns 2t, 2t+1 of each 8 are its A columns) and
//   V read MN-major through the descriptor's transpose bit. Nothing is
//   converted between the tiles' arrival and the products.
// - Warp roles: two consumer warpgroups, each owning 64 folded (query,
//   head) rows (row = i*G + g: the G query heads of one KV head are G
//   adjacent rows, so each K/V tile serves all of them), and one producer
//   warp that keeps a ring of K/V tiles in flight with TMA
//   (cp.async.bulk.tensor.3d over the (B, Skv, KH*Dh) views, keys past Skv
//   zero-filled) behind mbarriers (full: bytes landed and the producer's
//   side data written; empty: both warpgroups done with the stage). Q is
//   read once with 16-byte loads and written into the same swizzled
//   layout by the consumers.
// - Tiles (Cfg): 128 keys a tile, so that S is one m64n128 product a
//   k-step; 3 stages at Dh 48 and 64, 2 at 96, 112 and 128. The swizzle is
//   128 bytes at Dh 64 and 128 (one or two boxes a row), 64 at 96 and 32
//   at 48 and 112. Shared memory: 160 KB at Dh 128 (Q 32 KB, two stages of
//   K and V at 32 KB each), one block a SM; 288 threads, which get the
//   register budget of 384 (168 a thread), enough for the S 64 and O 64
//   accumulators a thread at Dh 128.
// - Dh 192 (deepseek-v3's MLA: qk_nope 128 + qk_rope 64, v padded to
//   192): 128-key tiles would take 192 KB for two stages of K and V beside
//   Q's 48 KB, and S's 64 and O's 96 accumulators a thread would not fit,
//   so the tiles are 64 keys (S one m64n64 product a k-step, 32
//   accumulators), 3 stages (Q 48 KB + 3 x 48 KB: 192 KB); a row of 384
//   bytes is three 64-column boxes of the 128-byte swizzle, and P.V is one
//   m64n192k16 a k-step of 16 keys (wgmma_rs_bf16_n192), V read MN-major
//   across the three boxes.
// - The online softmax runs on the S fragments in registers, in base 2
//   (scores scaled by log2(e)/sqrt(Dh), exp2); a row's 4 threads share a
//   quad, so its max and sum are two shfl_xor. A thread whose rows see
//   every key of a tile skips the per-element mask.
// - Causal and window schedule: the row tiles are the grid's slow axis,
//   launched heaviest (last rows) first; K/V tiles wholly outside the
//   band are skipped. Ragged Sq and Skv: TMA zero-fills keys past Skv and
//   the masks drop them; rows past Sq*G read zeros and are not written.
// - Explicit positions (kPos): as flash_attention.cu, the block's tile
//   range from its rows' least and greatest position and every key's;
//   each tile's key positions (-1 past Skv) are written into the stage by
//   the producer warp's 32 lanes, which arrive on the stage's full barrier
//   after their stores, and the softmax masks each element by them.
// Left for later: issuing the next tile's Q.K^T before this tile's P.V
// (intra-warpgroup overlap), a warpgroup ping-pong, setmaxnreg.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// Per head size: keys a K/V tile, ring stages and the swizzle's bytes
template <int DH> struct Cfg;
template <> struct Cfg<48> {
  static constexpr int kKeys = 128, kStages = 3, kSB = 32;
};
template <> struct Cfg<64> {
  static constexpr int kKeys = 128, kStages = 3, kSB = 128;
};
template <> struct Cfg<96> {
  static constexpr int kKeys = 128, kStages = 2, kSB = 64;
};
template <> struct Cfg<112> {
  static constexpr int kKeys = 128, kStages = 2, kSB = 32;
};
template <> struct Cfg<128> {
  static constexpr int kKeys = 128, kStages = 2, kSB = 128;
};
template <> struct Cfg<192> {
  static constexpr int kKeys = 64, kStages = 3, kSB = 128;
};

// Shared memory of one block, in bytes from a 1024-aligned base: Q, the
// ring of K and V tiles, the barriers, then with explicit positions 4
// bounds and each stage's key positions
template <int DH, bool kPos>
struct Layout {
  static constexpr int kWG = 2, kKeys = Cfg<DH>::kKeys;
  static constexpr int kStages = Cfg<DH>::kStages;
  static constexpr int kRows = 64 * kWG;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;   // + the producer warp
  static constexpr uint32_t kQ = kRows * DH * 2;
  static constexpr uint32_t kTile = kKeys * DH * 2;  // K or V
  static constexpr uint32_t kRing = kQ, kBars = kRing + kStages * 2 * kTile;
  static constexpr uint32_t kPosAt = kBars + 2 * kStages * 8;
  static constexpr uint32_t kBytes =
      kPosAt + (kPos ? (4 + kStages * kKeys) * 4 : 0) + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB opt-in shared memory");
  static_assert(kQ % 1024 == 0 && kTile % 1024 == 0, "boxes 1024-aligned");
};

// the output's type: bf16, or fp32 in the training instantiations
template <bool kLse>
using OutT = std::conditional_t<kLse, float, bf16>;

template <int DH, bool kLse, bool kPos>
__global__ void __launch_bounds__(Layout<DH, kPos>::kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tmap_k,
                            const __grid_constant__ CUtensorMap tmap_v,
                            const bf16* __restrict__ q,
                            OutT<kLse>* __restrict__ o,
                            float* __restrict__ lse,
                            const int* __restrict__ q_pos,
                            const int* __restrict__ kv_pos, int Sq, int Skv,
                            int H, int KH, int causal, int window,
                            float scale2) {
  using L = Layout<DH, kPos>;
  constexpr int kKeys = L::kKeys, kRows = L::kRows, kStages = L::kStages;
  constexpr int kCons = L::kConsumers, SB = Cfg<DH>::kSB;
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
  // last key any row may see}, then each stage's key positions
  int* const bounds = reinterpret_cast<int*>(smem + L::kPosAt);
  int* const stage_pos = bounds + 4;
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
      mbar_init(full0 + 8 * s, 1 + 32);  // the TMA bytes + the 32 lanes
      mbar_init(empty0 + 8 * s, kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kCons) {  // the producer warp
    const int lane = tid - kCons;
    for (int t = t_begin; t < t_end; ++t) {
      const int i = t - t_begin, s = i % kStages;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) {
        const uint32_t dst = base + L::kRing + s * 2 * L::kTile;
        mbar_expect_tx(full, 2 * L::kTile);
        tma_tile<SB, DH>(dst, &tmap_k, full, kh * DH, t * kKeys, b, kKeys);
        tma_tile<SB, DH>(dst + L::kTile, &tmap_v, full, kh * DH, t * kKeys,
                         b, kKeys);
      }
      if constexpr (kPos)  // the tile's key positions, -1 past Skv
        for (int j = lane; j < kKeys; j += 32) {
          const int key = t * kKeys + j;
          stage_pos[s * kKeys + j] = key < Skv ? kv_pos[key] : -1;
        }
      mbar_arrive(full);
    }
    return;
  }

  // Q: this block's rows, unscaled, in the swizzled layout; zeros past the
  // end
  load_folded<SB, DH, kRows>(smem, q, b, kh, G, H, Sq, row0, tid, kCons);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumers_sync<kCons>();

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
  const uint32_t qw = base + wg * 64 * SB;  // the warpgroup's 64 rows
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[DH / 2];
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) acc[x] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, s = i % kStages;
    const int key0 = t * kKeys;
    const uint32_t kb = base + L::kRing + s * 2 * L::kTile;
    const uint32_t vb = kb + L::kTile;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    // S = Q.K^T, one bf16 wgmma a k-step of 16
    float sc[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_bf16<kKeys>(sc, desc_k<SB>(qw + kstep<SB>(kk, kRows)),
                           desc_k<SB>(kb + kstep<SB>(kk, kKeys)), kk > 0);
    wgmma_commit_and_wait();
    fence_regs(sc);

    // online softmax in base 2 on the fragments: sc[4j + e] is (rA, key
    // 8j + 2t4 + e) and sc[4j + 2 + e] is (rB, the same key)
    const bool allA = !kPos && key0 >= loA && key0 + kKeys - 1 <= hiA;
    const bool allB = !kPos && key0 >= loB && key0 + kKeys - 1 <= hiB;
    float mxA = kNegInf, mxB = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * t4 + e;
        bool inA, inB;
        if constexpr (kPos) {
          const int kp = stage_pos[s * kKeys + 8 * j + 2 * t4 + e];
          inA = okA && sees(qpA, kp, causal, window);
          inB = okB && sees(qpB, kp, causal, window);
        } else {
          inA = allA || (key >= loA && key <= hiA);
          inB = allB || (key >= loB && key <= hiB);
        }
        sc[4 * j + e] = inA ? sc[4 * j + e] * scale2 : -INFINITY;
        sc[4 * j + 2 + e] = inB ? sc[4 * j + 2 + e] * scale2 : -INFINITY;
        mxA = fmaxf(mxA, sc[4 * j + e]);
        mxB = fmaxf(mxB, sc[4 * j + 2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
    }
    const float mA = fmaxf(m_a, mxA), mB = fmaxf(m_b, mxB);
    const float cA = exp2f(m_a - mA), cB = exp2f(m_b - mB);
    m_a = mA;
    m_b = mB;
    // P in fp32 (summed into l) and rounded to bf16 pairs: the A fragment
    // of P.V (pa[4kk..4kk+3] are k-step kk's a0..a3)
    uint32_t pa[kKeys / 4];
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int y = 0; y < kKeys / 4; ++y) {
      const bool rowA = (y & 1) == 0;
      const float m = rowA ? mA : mB;
      const float p0 = exp2f(sc[2 * y] - m), p1 = exp2f(sc[2 * y + 1] - m);
      if (rowA) sumA += p0 + p1;
      else sumB += p0 + p1;
      pa[y] = pack_bf16(p0, p1);
    }
    l_a = l_a * cA + sumA;  // this thread's keys; the quad sums at the end
    l_b = l_b * cB + sumB;
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) acc[x] *= (x & 2) ? cB : cA;

    // O += P.V, V MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs_bf16<DH>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                        pa[4 * kk + 3],
                        desc_mn<SB>(vb + kk * 16 * SB, kKeys));
    wgmma_commit_and_wait();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * s);  // the stage may be refilled
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
      lse[(bh + rA % G) * Sq + posA] =
          l_a > 0.f ? (m_a + log2f(l_a)) * kLn2 : INFINITY;
    if (okB && t4 == 0)
      lse[(bh + rB % G) * Sq + posB] =
          l_b > 0.f ? (m_b + log2f(l_b)) * kLn2 : INFINITY;
  }
  if (okA) {
    OutT<kLse>* dst =
        o + ((static_cast<int64_t>(b) * Sq + posA) * H + kh * G + rA % G) *
                DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      store2(dst + 8 * j + 2 * t4, acc[4 * j] / dA, acc[4 * j + 1] / dA);
  }
  if (okB) {
    OutT<kLse>* dst =
        o + ((static_cast<int64_t>(b) * Sq + posB) * H + kh * G + rB % G) *
                DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      store2(dst + 8 * j + 2 * t4, acc[4 * j + 2] / dB, acc[4 * j + 3] / dB);
  }
}

template <int DH, bool kLse, bool kPos>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* q_pos, const int* kv_pos, int B, int Sq, int Skv,
           int H, int KH, int causal, int window, cudaStream_t st) {
  using L = Layout<DH, kPos>;
  constexpr int SB = Cfg<DH>::kSB;
  static bool configured = false;  // the attribute holds per function
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<DH, kLse, kPos>,
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
  int rc = encode_bf16<SB>(&map_k, k, B, Skv, KH * DH, L::kKeys);
  if (rc == 0) rc = encode_bf16<SB>(&map_v, v, B, Skv, KH * DH, L::kKeys);
  if (rc != 0) return rc;
  const dim3 grid(B * KH, static_cast<unsigned>(tiles));
  const float scale2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(DH)));
  flash_attention_bf16_kernel<DH, kLse, kPos>
      <<<grid, L::kThreads, L::kBytes, st>>>(
          map_k, map_v, static_cast<const bf16*>(q),
          static_cast<OutT<kLse>*>(o), lse, q_pos, kv_pos, Sq, Skv, H, KH,
          causal, window, scale2);
  return static_cast<int>(cudaGetLastError());
}

// One head size: the position instantiations when q_pos is set, else the
// index ones; the training instantiation when lse is set, else serving.
template <int DH>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, const int* q_pos, const int* kv_pos, int B, int Sq,
             int Skv, int H, int KH, int causal, int window,
             cudaStream_t st) {
  if (q_pos != nullptr) {
    if (lse != nullptr)
      return launch<DH, true, true>(q, k, v, o, lse, q_pos, kv_pos, B, Sq,
                                    Skv, H, KH, causal, window, st);
    return launch<DH, false, true>(q, k, v, o, lse, q_pos, kv_pos, B, Sq,
                                   Skv, H, KH, causal, window, st);
  }
  if (lse != nullptr)
    return launch<DH, true, false>(q, k, v, o, lse, q_pos, kv_pos, B, Sq,
                                   Skv, H, KH, causal, window, st);
  return launch<DH, false, false>(q, k, v, o, lse, q_pos, kv_pos, B, Sq,
                                  Skv, H, KH, causal, window, st);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a head size other than 48, 64, 96, 112, 128 or
// 192 or more than 65535 row tiles, or 10000 + the CUresult if a tensor map
// cannot be encoded. q, o: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh); bf16
// (o fp32 whenever lse is set), contiguous, 16-byte aligned (TMA's rule).
// lse: null (serving), or (B, H, Sq) fp32 written by the training
// instantiation. q_pos, kv_pos: both null (mask by index), or (Sq,) and
// (Skv,) contiguous int32 (mask by them; a cudaErrorInvalidValue if only
// one is set).
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           const void* q_pos,
                                           const void* kv_pos, int B, int Sq,
                                           int Skv, int H, int KH, int Dh,
                                           int causal, int window,
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
