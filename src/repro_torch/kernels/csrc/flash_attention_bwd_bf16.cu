// GQA attention backward in bf16 for Hopper (sm_90a): the gradients of
// K3's bf16 route.
//
// Replaces: nothing on the TPU (the reference trains through its pure-JAX
// chunked_attention, src/repro/models/attention.py:33-106, under
// jax.checkpoint; it trains in its params' dtype, bf16 by default,
// src/repro/launch/steps.py:91-119). flash_attention_bwd.cu does the fp32
// backward; this file does bf16 at head sizes 48, 64, 96, 112, 128 and 192
// (MLA's 48, 96 and deepseek-v3's 192, zamba2's shared block's 112, the
// dense configs' 64 and 128), from the row log-sum-exp and the fp32 output
// that K3's bf16 training instantiation (flash_attention_bf16.cu, kLse)
// saves.
//
// Computes, for q, dO (B, Sq, H, Dh), k, v (B, Skv, KH, Dh), all bf16, the
// forward's o (B, Sq, H, Dh) and lse (B, H, Sq) in fp32, all contiguous,
// G = H / KH, query head h = kh*G + g reading KV head kh, scale =
// 1/sqrt(Dh), with the forward's masks (causal keeps pos_j <= pos_i, a
// window keeps pos_j > pos_i - window, a key at a negative position is
// invalid; ragged Sq and Skv) on the indices as positions or, in the
// position instantiations (template flag kPos, at every head size: the
// reference's loss_fn takes positions for every arch), explicit q_pos and
// kv_pos int32:
//   P_ij  = exp(scale * q_i.k_j - lse_i) where unmasked, else 0   (fp32)
//   D_i   = sum_d dO_id o_id                                     (fp32)
//   dP_ij = dO_i . v_j,   dS_ij = P_ij (dP_ij - D_i)             (fp32)
//   dv_j  = sum_{g, i} bf16(P_ij) dO_i
//   dk_j  = scale * sum_{g, i} bf16(dS_ij) q_i
//   dq_i  = scale * sum_j bf16(dS_ij) k_j
// every sum in fp32, each gradient rounded to bf16 once as it is stored
// (or after the reduce of dK/dV's fp32 partials). P and dS are rounded to
// bf16 where they enter the tensor cores as operands, as the forward
// rounds P before P.V and as the reference rounds P there
// (src/repro/models/attention.py:90); the plain version of exactly this
// arithmetic is kernels/ref.py::flash_attention_bwd_bf16_ref. A fully
// masked row has lse = +inf and o = 0, so its P, D and dS are 0.
//
// Four kernels, no floating-point atomics: every output element is summed
// in one fixed order, so two runs give the same bits.
//   (a) attn_bwd_bf16_dot_kernel: D, 16 or 32 lanes a (b, i, h) row, 4
//       elements each of the first Dh / 4 (lane l also takes l + 32 at Dh
//       192).
//   (b) attn_bwd_bf16_dkdv_kernel: a block owns 64 keys of one KV head and
//       walks a contiguous range of their (head g, query tile of 64)
//       steps; `splits` blocks share a key tile's steps (split c takes
//       steps [n*c/splits, n*(c+1)/splits) of the n that the causal and
//       window bands leave) and write fp32 partial dK, dV.
//   (r) attn_bwd_bf16_reduce_kernel: with splits > 1, dK and dV as the sum
//       of the partials in split order, rounded to bf16.
//   (c) attn_bwd_bf16_dq_kernel: a block owns 128 folded (query, head)
//       rows of one KV head (row = i*G + g, as the forward folds them) and
//       walks the 64-key tiles they can see.
// At Dh 192, (b) is attn_bwd_bf16_dkdv_wide_kernel.
//
// What bounds it on this card: operations. Each unmasked (query, key) pair
// of each head costs five products of Dh multiply-adds (S, dP, dV, dK,
// dQ). At train_4k's shape (B 2, S 4096, H 32 over KH 2, Dh 128, causal)
// that is 0.687 TFLOP: 0.695 ms at bf16's 989 TFLOP/s. As run, (b) and (c)
// each recompute S and dP (seven products).
//
// What the design does about it:
// - Every product is one bf16 wgmma.mma_async a k-step of 16 with fp32
//   accumulators (wgmma_bf16.cuh), on tiles that TMA lands swizzled and
//   the descriptors read as they are: nothing is converted in shared
//   memory. (b): S^T = K.Q^T and dP^T = V.dO^T (K and V K-major as the
//   shared A, Q and dO K-major as B, m64n64), then dV += P^T.dO and dK +=
//   dS^T.Q with P^T and dS^T as register A operands (the S^T and dP^T
//   accumulator fragments rounded to bf16 pairs in place) and dO and Q
//   read MN-major through the descriptor's transpose bit. (c): S = Q.K^T
//   and dP = dO.V^T, then dQ += dS.K with K MN-major.
// - Warp roles in (b) and (c): two consumer warpgroups and a producer
//   warpgroup whose first warp keeps a ring of tiles in flight with TMA
//   and mbarriers. (b):
//   K and V, loaded once, are shared by both warpgroups, which take
//   alternate steps, each with its own dK, dV accumulators (64 + 64 a
//   thread at Dh 128); the ring's stages hold a step's Q and dO tiles and
//   its 64 queries' lse (times log2 e; +inf past Sq) and D, which the
//   producer's 32 lanes write beside the TMA bytes before arriving on the
//   stage's full barrier. At the end the second warpgroup's sums join the
//   first's through shared memory, in that order. (c): each warpgroup
//   owns 64 of the block's rows (Q and dO read once with 16-byte loads
//   into the swizzled layout, lse and D in registers); both read every
//   K/V tile of the ring.
// - Tiles: 64 keys a block and 64 queries a step in (b) (4 stages; 163 KB
//   of shared memory at Dh 128), 128 rows a block and 64 keys a tile in
//   (c) (3 stages; 160 KB); one block a SM. Registers: a block's budget
//   is set by its threads rounded up to whole warpgroups (168 a thread for
//   288 or 384), under which (b)'s 128 dK, dV accumulators a thread at Dh
//   128 spilled 740 bytes; so the producer is a warpgroup of its own,
//   which gives up registers with setmaxnreg (to 24) for the consumers'
//   240 (8 bytes spilled at Dh 128).
// - Filling the card: the wrapper (kernels/flash_attention.py::
//   backward_plan, bf16 tiles) picks `splits`: 1 when one block a (key
//   tile, batch, KV head) gives every SM a block, else the smallest count
//   that does, capped so that the busiest key tile still gives each split
//   a step a warpgroup. Key tile 0 (the most steps under the causal mask)
//   is first in the grid; (c)'s row tiles run heaviest (last rows) first.
// - Steps and tiles wholly inside the masks skip the per-element test.
// - Head sizes: the tiles are the same at every size; the swizzle is the
//   bf16 forward's (wgmma_bf16.cuh: 128 bytes at 64 and 128, 64 at 96, 32
//   at 48 and 112, whose 96- and 224-byte rows are whole 32-byte boxes
//   only), and the register-A products issue Dh output columns at once
//   (m64n48k16 .. m64n128k16). Shared memory at 112, the largest after
//   128: (b) 147 KB, (c) 144 KB.
// - Dh 192 (deepseek-v3's MLA, v padded to 192): (b) has a kernel of its
//   own (below), (c) is the other dims' with two changes, and D and the
//   reduce are the other dims'. What bounds
//   them: at deepseek-v3's training step (B 8, S 256, 128 heads, G 1,
//   causal) the bytes, 0.241 ms for 0.81 GB (64.7 GFLOP take 0.065 ms);
//   but a dK/dV block walks only 1 to 4 steps (4096 blocks) and a dQ
//   block 2 or 4 tiles (2048), each alone on its SM (211 and 193 KB of
//   shared memory), so a block's loads, waits and stores are not hidden
//   by other blocks. What their design does (times at that shape on an
//   H100 SXM at 700 W, benchmarks/torch_k3_wide_probe.py):
//   . Both grids head-major: a head's 4 key tiles (dK/dV, key tile 0, the
//     most steps under the causal mask, first) or 2 row tiles (dQ, the
//     last rows first) launched next to each other, so a head's Q and dO
//     (or K and V) are read from device memory about once: dK/dV 0.452 ->
//     0.429 ms, dQ 0.246 -> 0.230 against the tile as the slow axis (the
//     probe's "row tile slowest").
//   . (b): 96 + 96 dK, dV accumulators a thread do not fit beside S^T and
//     dP^T under the consumers' 240 registers, so both warpgroups take
//     every step, each summing half of the columns (m64n96k16 over three
//     32-column boxes of the 64-byte swizzle, which Dh 192 takes so that a
//     half is whole boxes). S^T and dP^T are computed once a step between
//     them: warpgroup w for the step's queries [32w, 32w + 32) (m64n32k16),
//     P^T and dS^T rounded to bf16 into shared memory (one 128-byte box of
//     64 rows each), a barrier, then dV and dK over all 64 queries with the
//     A operand from shared memory. Four products a step where the earlier
//     design (each warpgroup S^T and dP^T in full) did six. Every product
//     is waited for within its step: a group in flight across the loop's
//     back edge made ptxas serialize every wgmma (its C7515 note). 3
//     stages; 211 KB. Splitting by product instead (one warpgroup S^T and
//     dV, the other dP^T and dK, P^T handed over in fp32) was slower: the
//     second group waits on the first's P^T.
//   . (c): the other dims' kernel (96 dQ accumulators a thread, one
//     m64n192k16 a k-step, 2 stages: a third would pass 227 KB) with its
//     grid's axes swapped (the row tile fastest: head-major) and, when G =
//     1 (the folded rows are the query rows), Q and dO landed by TMA beside
//     the first K/V tiles instead of loaded by the consumers: with the
//     block order, 0.474 -> 0.230 ms against the earlier design (the
//     probe's "parent").
// - Explicit positions (kPos), as flash_attention_bwd.cu's: no index band
//   bounds the steps, and the positions may tie and need not be sorted.
//   Before the warp roles split, a (b) block reads its keys' least and
//   greatest valid position, then every query's, and walks the query
//   tiles from the first to the last that holds a query that may see one
//   of its keys; a (c) block likewise bounds its key tiles by its rows'
//   least and greatest position. The producer's 32 lanes write each
//   stage's positions (a step's queries in (b), a tile's keys in (c), -1
//   for a key past Skv) beside the TMA bytes, as the bf16 forward does;
//   the consumers hold their own rows' positions in registers and mask
//   every element by the two. For an arange these are the index band's
//   tiles, and with the wrapper's plan (sized from the index bounds) the
//   gradients are the index instantiations' bit for bit.
// Left for later: computing S and dP once for both dK/dV and dQ, folding
// D and the reduce into the other kernels, and at Dh 192 a persistent grid
// (one block an SM walking many key tiles, so that one tile's stores and
// the next one's loads overlap) and one barrier a step (P^T and dS^T in
// two buffers, which the position instantiations' shared memory cannot
// hold beside three stages).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_bf16.cuh"

namespace {

constexpr int kWGThreads = 128;   // a warpgroup
constexpr int kWG = 2;            // consumer warpgroups a block
// (b), (c): + a producer warpgroup, whose first warp works; it gives
// registers up to the consumers (setmaxnreg): 128 x 24 + 256 x 240 = 384 x
// 168, the budget a 384-thread block starts with
constexpr int kThreads = (kWG + 1) * kWGThreads;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kLaunchRegs = 168;
constexpr int kDotThreads = 256;  // (a), (r)
constexpr int kKeyTile = 64;      // (b): the keys a block owns
constexpr int kQueryTile = 64;    // (b): the queries of a step
constexpr int kRowTile = 64 * kWG;  // (c): the folded rows a block owns
constexpr int kKeyStep = 64;      // (c): the keys of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;  // the opt-in shared memory of a block

// each head size's swizzle (wgmma_bf16.cuh), the bf16 forward's but at
// Dh 192, which takes 64 bytes so that half its columns are whole boxes
template <int DH>
constexpr int kSB = DH == 64 || DH == 128 ? 128
                    : DH == 96 || DH == 192 ? 64 : 32;
// (b)'s ring stages (even: warpgroup w takes stages w, w+2; Dh 192's
// kernel has its own) and (c)'s (a third at Dh 192 would pass 227 KB)
constexpr int kDkdvStages = 4;
template <int DH>
constexpr int kDqStages = DH == 192 ? 2 : 3;

// (b)'s shared memory, in bytes from a 1024-aligned base: K and V, the
// ring (a stage: Q, dO), each stage's 64 lse and 64 D, the barriers (K/V's,
// then each stage's full and empty), then with explicit positions 4 bounds
// and each stage's 64 query positions
template <int DH, bool kPos>
struct DkdvSmem {
  static constexpr uint32_t kTile = kKeyTile * DH * 2;  // K, V, Q or dO
  static constexpr uint32_t kK = 0, kV = kTile, kRing = 2 * kTile;
  static constexpr uint32_t kStage = 2 * kTile;
  static constexpr int kStages = kDkdvStages;
  static constexpr uint32_t kStats = kRing + kStages * kStage;
  static constexpr uint32_t kBars = kStats + kStages * 2 * kQueryTile * 4;
  static constexpr uint32_t kPosAt = kBars + (1 + 2 * kStages) * 8;
  static constexpr uint32_t kBytes =
      kPosAt + (kPos ? (4 + kStages * kQueryTile) * 4 : 0) + 1024;
  static_assert(kBytes <= kSmemLimit, "over the opt-in shared memory");
  static_assert(kTile % 1024 == 0 && kStage % 1024 == 0,
                "tiles and stages keep the boxes 1024-aligned");
  static_assert(kStages % 2 == 0 &&
                    2 * (DH / 2) * kWGThreads * 4 <= kStages * kStage,
                "alternate steps: even stages, and the second warpgroup's "
                "dK, dV sums fit the ring");
};

// (c)'s: Q and dO (the block's rows), the ring (a stage: K, V), barriers
// (at Dh 192 Q and dO's first, then each stage's full and empty), then
// with explicit positions 4 bounds and each stage's 64 key positions
template <int DH, bool kPos>
struct DqSmem {
  static constexpr uint32_t kRowsBytes = kRowTile * DH * 2;
  static constexpr uint32_t kTile = kKeyStep * DH * 2;
  static constexpr uint32_t kQ = 0, kO = kRowsBytes, kRing = 2 * kRowsBytes;
  static constexpr int kStages = kDqStages<DH>;
  static constexpr uint32_t kBars = kRing + kStages * 2 * kTile;
  static constexpr uint32_t kFull = kBars + (DH == 192 ? 8 : 0);
  static constexpr uint32_t kPosAt = kFull + 2 * kStages * 8;
  static constexpr uint32_t kBytes =
      kPosAt + (kPos ? (4 + kStages * kKeyStep) * 4 : 0) + 1024;
  static_assert(kBytes <= kSmemLimit, "over the opt-in shared memory");
  static_assert(kRowsBytes % 1024 == 0 && kTile % 1024 == 0,
                "boxes 1024-aligned");
};

// the lanes of a D row: a power of two (the shuffle's) up to a warp, 4
// elements each of the first DH / 4, and at 192 lane l also l + 32
template <int DH>
constexpr int kDotLanes = DH / 4 <= 16 ? 16 : 32;

// (a): kDotLanes lanes a (b, i, h) row (16 at Dh 48 and 64, 32 at 96, 112,
// 128 and 192), 4 elements each of the first DH / 4 (two such at 192),
// summed in fp32; dO bf16, o fp32
template <int DH>
__global__ void __launch_bounds__(kDotThreads)
attn_bwd_bf16_dot_kernel(const bf16* __restrict__ dout,
                         const float* __restrict__ out, float* __restrict__ D,
                         int B, int Sq, int H) {
  constexpr int kLanes = kDotLanes<DH>;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kDotThreads +
                    threadIdx.x;
  const int64_t row = u / kLanes;
  const int lane = static_cast<int>(u % kLanes);
  const bool ok = row < static_cast<int64_t>(B) * Sq * H;
  float s = 0.f;
#pragma unroll
  for (int c = lane; ok && c < DH / 4; c += kLanes) {
    const int64_t e = row * DH + c * 4;
    const uint2 a = *reinterpret_cast<const uint2*>(dout + e);
    const float2 a01 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&a.x));
    const float2 a23 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&a.y));
    const float4 o = *reinterpret_cast<const float4*>(out + e);
    s = fmaf(a01.x, o.x,
             fmaf(a01.y, o.y, fmaf(a23.x, o.z, fmaf(a23.y, o.w, s))));
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (ok && lane == 0) {  // row = (b * Sq + i) * H + h -> (b, h, i)
    const int64_t h = row % H, bi = row / H;
    const int64_t b = bi / Sq, i = bi % Sq;
    D[(b * H + h) * Sq + i] = s;
  }
}

// (b)'s query tiles of a block, [x, x + y): those that hold a query that
// may see one of keys [k0, k_last], by the index band or, with kPos, from
// the keys' least and greatest valid position and every query's (bounds:
// 4 ints of shared memory; all kThreads threads of the block call it)
template <bool kPos>
__device__ __forceinline__ int2 query_tiles(int* bounds, const int* q_pos,
                                            const int* kv_pos, int k0,
                                            int k_last, int Sq, int causal,
                                            int window) {
  constexpr int QT = kQueryTile;
  if constexpr (kPos) {
    const int tid = threadIdx.x;
    if (tid == 0) {
      bounds[0] = bounds[2] = INT_MAX;
      bounds[1] = bounds[3] = INT_MIN;
    }
    __syncthreads();
    const int j = k0 + tid;
    const int kp = tid < kKeyTile && j <= k_last ? kv_pos[j] : -1;
    block_min(bounds, kp >= 0 ? kp : INT_MAX);
    block_max(bounds + 1, kp);
    __syncthreads();
    const int kp_min = bounds[0], kp_max = bounds[1];
    int lo = INT_MAX, hi = INT_MIN;
    if (kp_min <= kp_max)
      for (int i = tid; i < Sq; i += kThreads) {
        const int qp = q_pos[i];
        if ((!causal || kp_min <= qp) &&
            (window <= 0 || kp_max > qp - window)) {
          lo = min(lo, i);
          hi = max(hi, i);
        }
      }
    block_min(bounds + 2, lo);
    block_max(bounds + 3, hi);
    __syncthreads();
    const bool any = bounds[2] <= bounds[3];
    const int qt0 = any ? bounds[2] / QT : 0;
    return make_int2(qt0, any ? bounds[3] / QT + 1 - qt0 : 0);
  } else {
    const int q_begin = causal ? k0 : 0;
    const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
    const int qt0 = q_begin / QT;
    return make_int2(qt0,
                     q_end > q_begin ? (q_end + QT - 1) / QT - qt0 : 0);
  }
}

// O: dK's and dV's type (bf16, or fp32 for split partials)
template <typename O, int DH, bool kPos>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_bf16_dkdv_kernel(const __grid_constant__ CUtensorMap tmap_q,
                          const __grid_constant__ CUtensorMap tmap_do,
                          const __grid_constant__ CUtensorMap tmap_k,
                          const __grid_constant__ CUtensorMap tmap_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, O* __restrict__ dk,
                          O* __restrict__ dv, const int* __restrict__ q_pos,
                          const int* __restrict__ kv_pos, int B, int Sq,
                          int Skv, int H, int KH, int causal, int window,
                          int splits, int64_t split_stride, float scale,
                          float scale2) {
  using L = DkdvSmem<DH, kPos>;
  constexpr int SB = kSB<DH>, QT = kQueryTile, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw_base);
  const uint32_t kv_full = base + L::kBars, full0 = kv_full + 8;
  const uint32_t empty0 = full0 + kStages * 8;

  // block -> (key tile, batch, KV head, split), key tile slowest: under the
  // causal mask the first key tiles have the most steps and start first
  int id = blockIdx.x;
  const int c = id % splits;
  id /= splits;
  const int kh = id % KH;
  id /= KH;
  const int b = id % B, k0 = (id / B) * kKeyTile;
  const int G = H / KH;

  // the queries that can see keys [k0, k_last], in tiles; the steps are
  // (g, query tile) with g slowest; this block takes [s_lo, s_hi), step
  // i of them going to stage i % kStages and to warpgroup i % 2
  const int tid = threadIdx.x;
  const int k_last = min(k0 + kKeyTile, Skv) - 1;
  // explicit positions: bounds {least, greatest key position, first, last
  // query that may see one}, then each stage's query positions
  int* const bounds = reinterpret_cast<int*>(smem + L::kPosAt);
  int* const stage_pos = bounds + 4;
  const int2 tiles = query_tiles<kPos>(bounds, q_pos, kv_pos, k0, k_last, Sq,
                                       causal, window);
  const int qt0 = tiles.x, nq = tiles.y;
  const int64_t n = static_cast<int64_t>(G) * nq;
  const int s_lo = static_cast<int>(n * c / splits);
  const int steps = static_cast<int>(n * (c + 1) / splits) - s_lo;

  if (tid == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);  // the TMA bytes + the 32 lanes
      mbar_init(empty0 + 8 * s, kWGThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWG * kWGThreads) {  // the producer warpgroup's first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int lane = tid - kWG * kWGThreads;
    if (lane >= 32) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kTile);
      tma_tile<SB, DH>(base + L::kK, &tmap_k, kv_full, kh * DH, k0, b,
                       kKeyTile);
      tma_tile<SB, DH>(base + L::kV, &tmap_v, kv_full, kh * DH, k0, b,
                       kKeyTile);
    }
    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages, st = s_lo + i;
      const int h = kh * G + st / nq, q0 = (qt0 + st % nq) * QT;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s;
      const uint32_t dst = base + L::kRing + s * L::kStage;
      if (lane == 0) {
        mbar_expect_tx(full, 2 * L::kTile);
        tma_tile<SB, DH>(dst, &tmap_q, full, h * DH, q0, b, QT);
        tma_tile<SB, DH>(dst + L::kTile, &tmap_do, full, h * DH, q0, b, QT);
      }
      // the step's lse (in base 2; +inf past Sq, so P is 0 there) and D
      float* stats = reinterpret_cast<float*>(smem + L::kStats) + s * 2 * QT;
      const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq;
#pragma unroll
      for (int j = lane; j < QT; j += 32) {
        const bool ok = q0 + j < Sq;
        stats[j] = ok ? lse[row + q0 + j] * kLog2e : INFINITY;
        stats[QT + j] = ok ? D[row + q0 + j] : 0.f;
        if constexpr (kPos) stage_pos[s * QT + j] = ok ? q_pos[q0 + j] : 0;
      }
      mbar_arrive(full);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));

  // this thread's two key rows of the accumulators
  const int wg = tid / kWGThreads, t = tid % kWGThreads;
  const int warp = t / 32, lane = t % 32, t4 = lane % 4;
  const int keyA = k0 + warp * 16 + lane / 4, keyB = keyA + 8;
  int kpA = -1, kpB = -1;  // their explicit positions (-1 past Skv)
  if constexpr (kPos) {
    kpA = keyA < Skv ? kv_pos[keyA] : -1;
    kpB = keyB < Skv ? kv_pos[keyB] : -1;
  }
  float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
  mbar_wait(kv_full, 0);

  for (int i = wg; i < steps; i += kWG) {
    const int s = i % kStages, st = s_lo + i;
    const int q0 = (qt0 + st % nq) * QT;
    const uint32_t qs = base + L::kRing + s * L::kStage;
    const uint32_t dos = qs + L::kTile;
    const float* lse2 =
        reinterpret_cast<const float*>(smem + L::kStats) + s * 2 * QT;
    const float* Ds = lse2 + QT;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    // S^T = K.Q^T and dP^T = V.dO^T (64 keys x 64 queries), two groups: P
    // is formed while dP^T is still on the tensor cores
    float sT[QT / 2], dpT[QT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_bf16<QT>(sT, desc_k<SB>(base + L::kK + kstep<SB>(kk, 64)),
                        desc_k<SB>(qs + kstep<SB>(kk, QT)), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_bf16<QT>(dpT, desc_k<SB>(base + L::kV + kstep<SB>(kk, 64)),
                        desc_k<SB>(dos + kstep<SB>(kk, QT)), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sT);

    // P^T in fp32 on the fragments: sT[4j + e] is (keyA, query q0 + 8j +
    // 2t4 + e) and sT[4j + 2 + e] is (keyB, the same query)
    const bool all = !kPos && all_visible(q0, q0 + QT - 1, k0,
                                          k0 + kKeyTile - 1, Sq, Skv, causal,
                                          window);
    const int* qpos = stage_pos + s * QT;
#pragma unroll
    for (int x = 0; x < QT / 2; ++x) {
      const int col = 8 * (x / 4) + 2 * t4 + (x & 1);
      bool in;
      if constexpr (kPos)  // past Sq its lse is +inf: P is 0
        in = sees(qpos[col], (x & 2) ? kpB : kpA, causal, window);
      else
        in = all || visible(q0 + col, (x & 2) ? keyB : keyA, Sq, Skv, causal,
                            window);
      sT[x] = in ? exp2f(sT[x] * scale2 - lse2[col]) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dpT);
    // dS^T = P^T (dP^T - D) in fp32; P^T and dS^T rounded to bf16 pairs,
    // the A fragments of dV += P^T.dO and dK += dS^T.Q
    uint32_t pa[QT / 4], da[QT / 4];
#pragma unroll
    for (int y = 0; y < QT / 4; ++y) {
      const int col = 8 * (y / 2) + 2 * t4;
      const float g0 = sT[2 * y] * (dpT[2 * y] - Ds[col]);
      const float g1 = sT[2 * y + 1] * (dpT[2 * y + 1] - Ds[col + 1]);
      pa[y] = pack_bf16(sT[2 * y], sT[2 * y + 1]);
      da[y] = pack_bf16(g0, g1);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_rs_bf16<DH>(dv_acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                        pa[4 * kk + 3], desc_mn<SB>(dos + kk * 16 * SB, QT));
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_rs_bf16<DH>(dk_acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                        da[4 * kk + 3], desc_mn<SB>(qs + kk * 16 * SB, QT));
    wgmma_commit_and_wait();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(empty0 + 8 * s);  // the stage may be refilled
  }

  // the second warpgroup's sums join the first's, through the ring (every
  // step is done once both groups pass the barrier)
  consumers_sync<kWG * kWGThreads>();
  float* buf = reinterpret_cast<float*>(smem + L::kRing);
  if (wg == 1) {
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) {
      buf[x * kWGThreads + t] = dk_acc[x];
      buf[(DH / 2 + x) * kWGThreads + t] = dv_acc[x];
    }
  }
  consumers_sync<kWG * kWGThreads>();
  if (wg == 1) return;
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) {
    dk_acc[x] += buf[x * kWGThreads + t];
    dv_acc[x] += buf[(DH / 2 + x) * kWGThreads + t];
  }

  // dK, dV (or this split's partials): rows past Skv are not written
  O* dk_out = dk + c * split_stride;
  O* dv_out = dv + c * split_stride;
  const int64_t kv_batch = static_cast<int64_t>(b) * Skv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? keyB : keyA;
    if (key >= Skv) continue;
    const int64_t off = ((kv_batch + key) * KH + kh) * DH + 2 * t4;
#pragma unroll
    for (int x = 0; x < DH / 8; ++x) {  // columns 8x + 2t4, +1
      const int a = 4 * x + 2 * r;
      store2(dk_out + off + 8 * x, dk_acc[a] * scale, dk_acc[a + 1] * scale);
      store2(dv_out + off + 8 * x, dv_acc[a], dv_acc[a + 1]);
    }
  }
}

// dk, dv (n elements each, bf16) = the sum over s < splits, in order, of
// the fp32 partials part[s * n ..] and part[(splits + s) * n ..], rounded
// to bf16 once
__global__ void __launch_bounds__(kDotThreads)
attn_bwd_bf16_reduce_kernel(const float4* __restrict__ part,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int64_t n4, int splits) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kDotThreads +
                   threadIdx.x;
       i < 2 * n4; i += static_cast<int64_t>(gridDim.x) * kDotThreads) {
    const int64_t w = i >= n4, e = i - w * n4;
    const float4* p = part + w * splits * n4 + e;
    float4 s = p[0];
    for (int c = 1; c < splits; ++c) {
      const float4 x = p[c * n4];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    bf16* dst = (w ? dv : dk) + e * 4;
    store2(dst, s.x, s.y);
    store2(dst + 2, s.z, s.w);
  }
}

// tmap_q, tmap_do: read at Dh 192 only, where (G = 1) Q and dO land by TMA
template <int DH, bool kPos>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_bf16_dq_kernel(const __grid_constant__ CUtensorMap tmap_k,
                        const __grid_constant__ CUtensorMap tmap_v,
                        const bf16* __restrict__ q,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, bf16* __restrict__ dq,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ kv_pos, int Sq, int Skv,
                        int H, int KH, int causal, int window, float scale,
                        float scale2,
                        const __grid_constant__ CUtensorMap tmap_q,
                        const __grid_constant__ CUtensorMap tmap_do) {
  using L = DqSmem<DH, kPos>;
  constexpr bool kWide = DH == 192;
  constexpr int SB = kSB<DH>, KT = kKeyStep, kStages = L::kStages;
  constexpr int kCons = kWG * kWGThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw_base);
  const uint32_t rows_full = base + L::kBars;  // Dh 192's Q and dO
  const uint32_t full0 = base + L::kFull, empty0 = full0 + kStages * 8;

  // block -> (batch, KV head, folded row tile), the last rows (the most
  // keys under the causal mask) first: the batch and KV head the grid's x,
  // or at Dh 192 its y, so that a head's row tiles run next to each other
  // (they read the same K and V while it is in L2)
  // (b, kh and row0 each read the grid in one expression: the same values
  // held in variables first change the other head dims' machine code)
  const int G = H / KH;
  const int b = (kWide ? blockIdx.y : blockIdx.x) / KH;
  const int kh = (kWide ? blockIdx.y : blockIdx.x) % KH;
  const int n_rows = Sq * G;
  const int row0 = (kWide ? gridDim.x - 1 - blockIdx.x
                          : gridDim.y - 1 - blockIdx.y) * kRowTile;
  const int q_lo = row0 / G, q_hi = (min(row0 + kRowTile, n_rows) - 1) / G;
  const int tid = threadIdx.x;
  // explicit positions: bounds {least, greatest row position, first, last
  // key one of them may see}, then each stage's key positions
  int* const bounds = reinterpret_cast<int*>(smem + L::kPosAt);
  int* const stage_pos = bounds + 4;
  int t_begin, t_end;
  if constexpr (kPos) {
    const int2 seen = position_tiles<KT, kThreads>(
        bounds, q_pos, kv_pos, q_lo, q_hi, Skv, causal, window);
    t_begin = seen.x;
    t_end = seen.y;
  } else {
    const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
    const int k_end = causal ? min(Skv, q_hi + 1) : Skv;
    t_begin = k_begin / KT;
    t_end = k_end > k_begin ? (k_end + KT - 1) / KT : t_begin;
  }

  if (tid == 0) {
    if constexpr (kWide) mbar_init(rows_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      // the TMA bytes (+ the 32 lanes that write the key positions)
      mbar_init(full0 + 8 * s, kPos ? 1 + 32 : 1);
      mbar_init(empty0 + 8 * s, kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kCons) {  // the producer warpgroup: its first thread drives the
                       // ring (its first warp, with explicit positions)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int lane = tid - kCons;
    if (lane >= (kPos ? 32 : 1)) return;
    // at Dh 192 with G = 1 (the folded rows are the query rows) Q and dO
    // land by TMA beside the first K/V tiles
    if constexpr (kWide) {
      if (lane == 0 && G == 1) {
        mbar_expect_tx(rows_full, 2 * L::kRowsBytes);
        tma_tile<SB, DH>(base + L::kQ, &tmap_q, rows_full, kh * DH, row0, b,
                         kRowTile);
        tma_tile<SB, DH>(base + L::kO, &tmap_do, rows_full, kh * DH, row0,
                         b, kRowTile);
      }
    }
    for (int t = t_begin; t < t_end; ++t) {
      const int i = t - t_begin, s = i % kStages;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) {
        const uint32_t dst = base + L::kRing + s * 2 * L::kTile;
        mbar_expect_tx(full, 2 * L::kTile);
        tma_tile<SB, DH>(dst, &tmap_k, full, kh * DH, t * KT, b, KT);
        tma_tile<SB, DH>(dst + L::kTile, &tmap_v, full, kh * DH, t * KT, b,
                         KT);
      }
      if constexpr (kPos) {  // the tile's key positions, -1 past Skv
        for (int j = lane; j < KT; j += 32) {
          const int key = t * KT + j;
          stage_pos[s * KT + j] = key < Skv ? kv_pos[key] : -1;
        }
        mbar_arrive(full);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));

  if (kWide && G == 1) {
    mbar_wait(rows_full, 0);
  } else {  // Q and dO: this block's rows in the swizzled layout; zeros
            // past the end
    load_folded<SB, DH, kRowTile>(smem + L::kQ, q, b, kh, G, H, Sq, row0,
                                  tid, kCons);
    load_folded<SB, DH, kRowTile>(smem + L::kO, dout, b, kh, G, H, Sq, row0,
                                  tid, kCons);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync<kCons>();
  }

  // this thread's two rows of the warpgroup's 64, their keys and stats
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int rA = row0 + wg * 64 + warp * 16 + lane / 4, rB = rA + 8;
  const bool okA = rA < n_rows, okB = rB < n_rows;
  const int posA = rA / G, posB = rB / G;
  const int hiA = okA ? (causal ? min(posA, Skv - 1) : Skv - 1) : -1;
  const int hiB = okB ? (causal ? min(posB, Skv - 1) : Skv - 1) : -1;
  const int loA = window > 0 ? posA - window + 1 : 0;
  const int loB = window > 0 ? posB - window + 1 : 0;
  const int64_t bh = static_cast<int64_t>(b) * H + kh * G;
  const int64_t iA = (bh + rA % G) * Sq + posA, iB = (bh + rB % G) * Sq + posB;
  const float lseA = okA ? lse[iA] * kLog2e : INFINITY;
  const float lseB = okB ? lse[iB] * kLog2e : INFINITY;
  const float dA = okA ? D[iA] : 0.f, dB = okB ? D[iB] : 0.f;
  int qpA = 0, qpB = 0;  // explicit positions of the two rows
  if constexpr (kPos) {
    qpA = okA ? q_pos[posA] : 0;
    qpB = okB ? q_pos[posB] : 0;
  }
  const uint32_t qw = base + L::kQ + wg * 64 * SB;
  const uint32_t ow = base + L::kO + wg * 64 * SB;
  float dq_acc[DH / 2];
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) dq_acc[x] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, s = i % kStages;
    const int key0 = t * KT;
    const uint32_t kb = base + L::kRing + s * 2 * L::kTile;
    const uint32_t vb = kb + L::kTile;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    // S = Q.K^T and dP = dO.V^T (64 rows x 64 keys), two groups
    float sc[KT / 2], dp[KT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_bf16<KT>(sc, desc_k<SB>(qw + kstep<SB>(kk, kRowTile)),
                        desc_k<SB>(kb + kstep<SB>(kk, KT)), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_bf16<KT>(dp, desc_k<SB>(ow + kstep<SB>(kk, kRowTile)),
                        desc_k<SB>(vb + kstep<SB>(kk, KT)), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P on the fragments: sc[4j + e] is (rA, key key0 + 8j + 2t4 + e) and
    // sc[4j + 2 + e] is (rB, the same key)
    const bool allA = !kPos && key0 >= loA && key0 + KT - 1 <= hiA;
    const bool allB = !kPos && key0 >= loB && key0 + KT - 1 <= hiB;
#pragma unroll
    for (int x = 0; x < KT / 2; ++x) {
      const int col = 8 * (x / 4) + 2 * t4 + (x & 1), key = key0 + col;
      const bool rowB = (x & 2) != 0;
      bool in;
      if constexpr (kPos) {
        const int kp = stage_pos[s * KT + col];
        in = rowB ? okB && sees(qpB, kp, causal, window)
                  : okA && sees(qpA, kp, causal, window);
      } else {
        in = rowB ? allB || (key >= loB && key <= hiB)
                  : allA || (key >= loA && key <= hiA);
      }
      sc[x] = in ? exp2f(sc[x] * scale2 - (rowB ? lseB : lseA)) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - D), rounded to bf16 pairs: the A fragment of dQ += dS.K
    uint32_t da[KT / 4];
#pragma unroll
    for (int y = 0; y < KT / 4; ++y) {
      const float d = (y & 1) ? dB : dA;
      da[y] = pack_bf16(sc[2 * y] * (dp[2 * y] - d),
                        sc[2 * y + 1] * (dp[2 * y + 1] - d));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_rs_bf16<DH>(dq_acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                        da[4 * kk + 3], desc_mn<SB>(kb + kk * 16 * SB, KT));
    wgmma_commit_and_wait();
    fence_regs(dq_acc);
    mbar_arrive(empty0 + 8 * s);  // the stage may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rB : rA;
    if (row >= n_rows) continue;
    bf16* dst = dq + ((static_cast<int64_t>(b) * Sq + row / G) * H + kh * G +
                      row % G) * DH + 2 * t4;
#pragma unroll
    for (int x = 0; x < DH / 8; ++x) {
      const int a = 4 * x + 2 * r;
      store2(dst + 8 * x, dq_acc[a] * scale, dq_acc[a + 1] * scale);
    }
  }
}

// ---- Dh 192 (deepseek-v3's MLA, v padded to 192): (b)'s kernel

namespace wide {
constexpr int kDH = 192;
constexpr int kHalf = kDH / 2;     // dK's and dV's columns a warpgroup sums
constexpr int kQHalf = kQueryTile / 2;  // a step's queries a group takes
constexpr int kDkdvStages = 3;
// P^T and dS^T of a step (64 keys x 64 queries, bf16): one 128-byte box of
// 64 rows each, the K-major A operands of dV += P^T.dO and dK += dS^T.Q
constexpr int kPSB = 128;
constexpr uint32_t kPTile = kKeyTile * kQueryTile * 2;
}  // namespace wide

// (b) at Dh 192, from a 1024-aligned base: K and V, the ring (a stage: Q,
// dO), P^T and dS^T, each stage's 64 lse and 64 D, the barriers (K/V's,
// then each stage's full and empty), then with explicit positions 4 bounds
// and each stage's 64 query positions
template <bool kPos>
struct DkdvWideSmem {
  static constexpr uint32_t kTile = kKeyTile * wide::kDH * 2;  // K, V, Q, dO
  static constexpr uint32_t kK = 0, kV = kTile, kRing = 2 * kTile;
  static constexpr uint32_t kStage = 2 * kTile;
  static constexpr int kStages = wide::kDkdvStages;
  static constexpr uint32_t kPT = kRing + kStages * kStage;
  static constexpr uint32_t kDST = kPT + wide::kPTile;
  static constexpr uint32_t kStats = kDST + wide::kPTile;
  static constexpr uint32_t kBars = kStats + kStages * 2 * kQueryTile * 4;
  static constexpr uint32_t kPosAt = kBars + (1 + 2 * kStages) * 8;
  static constexpr uint32_t kBytes =
      kPosAt + (kPos ? (4 + kStages * kQueryTile) * 4 : 0) + 1024;
  static_assert(kBytes <= kSmemLimit, "over the opt-in shared memory");
  static_assert(kTile % 1024 == 0 && wide::kPTile % 1024 == 0,
                "tiles 1024-aligned");
};

// (b) at Dh 192. A block owns 64 keys of one KV head and walks its steps
// as the other head dims' kernel does, but both consumer warpgroups take
// every step: warpgroup w computes S^T and dP^T for the step's queries
// [32w, 32w + 32) (m64n32), forms its half of P^T and dS^T, rounds them to
// bf16 into shared memory, and after a barrier sums dV and dK for its half
// of the columns [96w, 96w + 96) over all 64 queries (m64n96k16, A from
// shared memory). So S^T and dP^T are computed once a step.
template <typename O, bool kPos>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_bf16_dkdv_wide_kernel(const __grid_constant__ CUtensorMap tmap_q,
                               const __grid_constant__ CUtensorMap tmap_do,
                               const __grid_constant__ CUtensorMap tmap_k,
                               const __grid_constant__ CUtensorMap tmap_v,
                               const float* __restrict__ lse,
                               const float* __restrict__ D,
                               O* __restrict__ dk, O* __restrict__ dv,
                               const int* __restrict__ q_pos,
                               const int* __restrict__ kv_pos, int B, int Sq,
                               int Skv, int H, int KH, int causal,
                               int window, int splits, int64_t split_stride,
                               float scale, float scale2) {
  using L = DkdvWideSmem<kPos>;
  constexpr int DH = wide::kDH, SB = kSB<DH>, QT = kQueryTile;
  constexpr int kStages = L::kStages, kCons = kWG * kWGThreads;
  constexpr int kHalf = wide::kHalf, kQHalf = wide::kQHalf;
  constexpr int kPSB = wide::kPSB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw_base);
  const uint32_t kv_full = base + L::kBars, full0 = kv_full + 8;
  const uint32_t empty0 = full0 + kStages * 8;

  // block -> (batch, KV head, key tile, split), split fastest; head-major:
  // a head's key tiles next to each other (they read the same Q and dO
  // while it is in L2), key tile 0 (the most steps under the causal mask)
  // first
  const int n_kt = (Skv + kKeyTile - 1) / kKeyTile;
  int id = blockIdx.x;
  const int c = id % splits;
  id /= splits;
  const int kt = id % n_kt, head = id / n_kt;
  const int b = head / KH, kh = head % KH, k0 = kt * kKeyTile;
  const int G = H / KH;

  const int tid = threadIdx.x;
  const int k_last = min(k0 + kKeyTile, Skv) - 1;
  int* const bounds = reinterpret_cast<int*>(smem + L::kPosAt);
  int* const stage_pos = bounds + 4;
  const int2 tiles = query_tiles<kPos>(bounds, q_pos, kv_pos, k0, k_last, Sq,
                                       causal, window);
  const int qt0 = tiles.x, nq = tiles.y;
  const int64_t n = static_cast<int64_t>(G) * nq;
  const int s_lo = static_cast<int>(n * c / splits);
  const int steps = static_cast<int>(n * (c + 1) / splits) - s_lo;

  if (tid == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);  // the TMA bytes + the 32 lanes
      mbar_init(empty0 + 8 * s, kCons);  // both warpgroups take every step
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kCons) {  // the producer warpgroup's first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int lane = tid - kCons;
    if (lane >= 32) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kTile);
      tma_tile<SB, DH>(base + L::kK, &tmap_k, kv_full, kh * DH, k0, b,
                       kKeyTile);
      tma_tile<SB, DH>(base + L::kV, &tmap_v, kv_full, kh * DH, k0, b,
                       kKeyTile);
    }
    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages, st = s_lo + i;
      const int h = kh * G + st / nq, q0 = (qt0 + st % nq) * QT;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s;
      const uint32_t dst = base + L::kRing + s * L::kStage;
      if (lane == 0) {
        mbar_expect_tx(full, 2 * L::kTile);
        tma_tile<SB, DH>(dst, &tmap_q, full, h * DH, q0, b, QT);
        tma_tile<SB, DH>(dst + L::kTile, &tmap_do, full, h * DH, q0, b, QT);
      }
      // the step's lse (in base 2; +inf past Sq, so P is 0 there) and D
      float* stats = reinterpret_cast<float*>(smem + L::kStats) + s * 2 * QT;
      const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq;
#pragma unroll
      for (int j = lane; j < QT; j += 32) {
        const bool ok = q0 + j < Sq;
        stats[j] = ok ? lse[row + q0 + j] * kLog2e : INFINITY;
        stats[QT + j] = ok ? D[row + q0 + j] : 0.f;
        if constexpr (kPos) stage_pos[s * QT + j] = ok ? q_pos[q0 + j] : 0;
      }
      mbar_arrive(full);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));

  // this thread's two key rows of the accumulators, and its warpgroup's
  // queries [qh, qh + 32) of a step and columns [96 wg, 96 wg + 96)
  const int wg = tid / kWGThreads, t = tid % kWGThreads;
  const int warp = t / 32, lane = t % 32, t4 = lane % 4;
  const int rowA = warp * 16 + lane / 4, rowB = rowA + 8;
  const int keyA = k0 + rowA, keyB = k0 + rowB;
  int kpA = -1, kpB = -1;  // their explicit positions (-1 past Skv)
  if constexpr (kPos) {
    kpA = keyA < Skv ? kv_pos[keyA] : -1;
    kpB = keyB < Skv ? kv_pos[keyB] : -1;
  }
  const int qh = wg * kQHalf, col0 = wg * kHalf;
  const uint32_t box0 = col0 * 2 / SB * QT * SB;  // its first column box
  const uint32_t pt = base + L::kPT, dsb = base + L::kDST;
  float dk_acc[kHalf / 2], dv_acc[kHalf / 2];
#pragma unroll
  for (int x = 0; x < kHalf / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages, st = s_lo + i;
    const int q0 = (qt0 + st % nq) * QT;
    const uint32_t qs = base + L::kRing + s * L::kStage;
    const uint32_t dos = qs + L::kTile;
    const float* lse2 =
        reinterpret_cast<const float*>(smem + L::kStats) + s * 2 * QT;
    const float* Ds = lse2 + QT;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    // S^T = K.Q^T and dP^T = V.dO^T for the 64 keys x this group's 32
    // queries (rows qh.. of the Q and dO tiles), two groups
    float sT[kQHalf / 2], dpT[kQHalf / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_bf16<kQHalf>(sT, desc_k<SB>(base + L::kK + kstep<SB>(kk, 64)),
                            desc_k<SB>(qs + qh * SB + kstep<SB>(kk, QT)),
                            kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_bf16<kQHalf>(dpT,
                            desc_k<SB>(base + L::kV + kstep<SB>(kk, 64)),
                            desc_k<SB>(dos + qh * SB + kstep<SB>(kk, QT)),
                            kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // this step's S^T
    fence_regs(sT);

    // P^T in fp32 on the fragments: sT[4j + e] is (keyA, query q0 + qh +
    // 8j + 2t4 + e) and sT[4j + 2 + e] is (keyB, the same query)
    const bool all = !kPos && all_visible(q0 + qh, q0 + qh + kQHalf - 1, k0,
                                          k0 + kKeyTile - 1, Sq, Skv, causal,
                                          window);
    const int* qpos = stage_pos + s * QT;
#pragma unroll
    for (int x = 0; x < kQHalf / 2; ++x) {
      const int col = qh + 8 * (x / 4) + 2 * t4 + (x & 1);
      bool in;
      if constexpr (kPos)  // past Sq its lse is +inf: P is 0
        in = sees(qpos[col], (x & 2) ? kpB : kpA, causal, window);
      else
        in = all || visible(q0 + col, (x & 2) ? keyB : keyA, Sq, Skv, causal,
                            window);
      sT[x] = in ? exp2f(sT[x] * scale2 - lse2[col]) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dpT);
    // dS^T = P^T (dP^T - D) in fp32; both rounded to bf16 pairs into the
    // shared P^T and dS^T tiles once the other group's last dV, dK (which
    // read them) are done too
    consumers_sync<kCons>();
#pragma unroll
    for (int y = 0; y < kQHalf / 4; ++y) {
      const int col = qh + 8 * (y / 2) + 2 * t4;
      const float g0 = sT[2 * y] * (dpT[2 * y] - Ds[col]);
      const float g1 = sT[2 * y + 1] * (dpT[2 * y + 1] - Ds[col + 1]);
      const uint32_t at = swizzled<kPSB>((y & 1) ? rowB : rowA,
                                         col & ~7, kKeyTile) + (col & 7) * 2;
      *reinterpret_cast<uint32_t*>(smem + L::kPT + at) =
          pack_bf16(sT[2 * y], sT[2 * y + 1]);
      *reinterpret_cast<uint32_t*>(smem + L::kDST + at) = pack_bf16(g0, g1);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync<kCons>();
    // dV += P^T.dO and dK += dS^T.Q over the step's 64 queries, this
    // group's columns of dO and Q read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_ss_bf16_n96_mn(dv_acc, desc_k<kPSB>(pt + kstep<kPSB>(kk, 64)),
                           desc_mn<SB>(dos + box0 + kk * 16 * SB, QT), 1);
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_ss_bf16_n96_mn(dk_acc, desc_k<kPSB>(dsb + kstep<kPSB>(kk, 64)),
                           desc_mn<SB>(qs + box0 + kk * 16 * SB, QT), 1);
    // waited for within the step: a product in flight across the loop's
    // back edge makes ptxas serialize every product
    wgmma_commit_and_wait();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(empty0 + 8 * s);  // the stage may be refilled
  }

  // dK, dV (or this split's partials), this group's columns: rows past Skv
  // are not written
  O* dk_out = dk + c * split_stride;
  O* dv_out = dv + c * split_stride;
  const int64_t kv_batch = static_cast<int64_t>(b) * Skv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? keyB : keyA;
    if (key >= Skv) continue;
    const int64_t off = ((kv_batch + key) * KH + kh) * DH + col0 + 2 * t4;
#pragma unroll
    for (int x = 0; x < kHalf / 8; ++x) {  // columns col0 + 8x + 2t4, +1
      const int a = 4 * x + 2 * r;
      store2(dk_out + off + 8 * x, dk_acc[a] * scale, dk_acc[a + 1] * scale);
      store2(dv_out + off + 8 * x, dv_acc[a], dv_acc[a + 1]);
    }
  }
}

// Sets the kernel's shared memory once, and refuses a build that starts a
// block with fewer registers than setmaxnreg.inc waits for (it would hang)
template <typename Kernel>
int configure(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  const cudaError_t a = cudaFuncGetAttributes(&attr, kernel);
  if (a != cudaSuccess) return static_cast<int>(a);
  if (attr.numRegs < kLaunchRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  done = true;  // the attribute holds per function
  return 0;
}

float scale_of(int Dh) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
}
// the scale in base 2: log2(e) / sqrt(Dh), for exp2
float scale2_of(int Dh) {
  return static_cast<float>(1.4426950408889634 /
                            sqrt(static_cast<double>(Dh)));
}

template <typename O, int DH, bool kPos>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* D, void* dk, void* dv,
                const int* q_pos, const int* kv_pos, int B, int Sq, int Skv,
                int H, int KH, int causal, int window, int splits,
                cudaStream_t st) {
  // Dh 192 takes its own kernel, with the same arguments
  constexpr bool kWide = DH == 192;
  constexpr int SB = kSB<DH>;
  const auto kernel = [] {
    if constexpr (kWide) return attn_bwd_bf16_dkdv_wide_kernel<O, kPos>;
    else return attn_bwd_bf16_dkdv_kernel<O, DH, kPos>;
  }();
  using Smem = std::conditional_t<kWide, DkdvWideSmem<kPos>,
                                  DkdvSmem<DH, kPos>>;
  static bool done = false;
  const int bytes = Smem::kBytes;
  const int rc = configure(kernel, bytes, done);
  if (rc != 0) return rc;
  const int64_t blocks =
      static_cast<int64_t>((Skv + kKeyTile - 1) / kKeyTile) * B * KH * splits;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mdo, mk, mv;
  int e = encode_bf16<SB>(&mq, q, B, Sq, H * DH, kQueryTile);
  if (e == 0) e = encode_bf16<SB>(&mdo, dout, B, Sq, H * DH, kQueryTile);
  if (e == 0) e = encode_bf16<SB>(&mk, k, B, Skv, KH * DH, kKeyTile);
  if (e == 0) e = encode_bf16<SB>(&mv, v, B, Skv, KH * DH, kKeyTile);
  if (e != 0) return e;
  const int64_t stride =
      splits > 1 ? static_cast<int64_t>(B) * Skv * KH * DH : 0;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, st>>>(
          mq, mdo, mk, mv, lse, D, static_cast<O*>(dk), static_cast<O*>(dv),
          q_pos, kv_pos, B, Sq, Skv, H, KH, causal, window, splits, stride,
          scale_of(DH), scale2_of(DH));
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool kPos>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* D, void* dq, const int* q_pos,
              const int* kv_pos, int B, int Sq, int Skv, int H, int KH,
              int causal, int window, cudaStream_t st) {
  constexpr int SB = kSB<DH>;
  static bool done = false;
  const int bytes = DqSmem<DH, kPos>::kBytes;
  const int rc = configure(attn_bwd_bf16_dq_kernel<DH, kPos>, bytes, done);
  if (rc != 0) return rc;
  const long long tiles =
      (static_cast<long long>(Sq) * (H / KH) + kRowTile - 1) / kRowTile;
  // (batch x KV head, row tile), or (row tile, batch x KV head) at Dh 192
  const long long heads = static_cast<long long>(B) * KH;
  constexpr bool kWide = DH == 192;
  if ((kWide ? heads : tiles) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mk, mv, mq, mdo;
  int e = encode_bf16<SB>(&mk, k, B, Skv, KH * DH, kKeyStep);
  if (e == 0) e = encode_bf16<SB>(&mv, v, B, Skv, KH * DH, kKeyStep);
  if (kWide && e == 0) e = encode_bf16<SB>(&mq, q, B, Sq, H * DH, kRowTile);
  if (kWide && e == 0)
    e = encode_bf16<SB>(&mdo, dout, B, Sq, H * DH, kRowTile);
  if (e != 0) return e;
  const dim3 grid = kWide ? dim3(static_cast<unsigned>(tiles), B * KH)
                         : dim3(B * KH, static_cast<unsigned>(tiles));
  attn_bwd_bf16_dq_kernel<DH, kPos><<<grid, kThreads, bytes, st>>>(
      mk, mv, static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
      lse, D, static_cast<bf16*>(dq), q_pos, kv_pos, Sq, Skv, H, KH, causal,
      window, scale_of(DH), scale2_of(DH), kWide ? mq : mk, kWide ? mdo : mv);
  return static_cast<int>(cudaGetLastError());
}

// (b) at one head size: the position instantiation when q_pos is set
template <typename O, int DH>
int dkdv_at(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* D, void* dk, void* dv,
            const int* q_pos, const int* kv_pos, int B, int Sq, int Skv,
            int H, int KH, int causal, int window, int splits,
            cudaStream_t st) {
  if (q_pos != nullptr)
    return launch_dkdv<O, DH, true>(q, k, v, dout, lse, D, dk, dv, q_pos,
                                    kv_pos, B, Sq, Skv, H, KH, causal, window,
                                    splits, st);
  return launch_dkdv<O, DH, false>(q, k, v, dout, lse, D, dk, dv, q_pos,
                                   kv_pos, B, Sq, Skv, H, KH, causal, window,
                                   splits, st);
}

// (c) at one head size: the position instantiation when q_pos is set
template <int DH>
int dq_at(const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* D, void* dq, const int* q_pos,
          const int* kv_pos, int B, int Sq, int Skv, int H, int KH,
          int causal, int window, cudaStream_t st) {
  if (q_pos != nullptr)
    return launch_dq<DH, true>(q, k, v, dout, lse, D, dq, q_pos, kv_pos, B,
                               Sq, Skv, H, KH, causal, window, st);
  return launch_dq<DH, false>(q, k, v, dout, lse, D, dq, q_pos, kv_pos, B,
                              Sq, Skv, H, KH, causal, window, st);
}

// Calls f(std::integral_constant<int, Dh>) at a head size the kernels
// take (48, 64, 96, 112, 128, 192), else returns cudaErrorInvalidValue
template <typename F>
int at_head_dim(int Dh, F f) {
  switch (Dh) {
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool shape_ok(int B, int Sq, int Skv, int H, int KH) {
  return B >= 1 && Sq >= 1 && Skv >= 1 && KH >= 1 && H % KH == 0;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for a shape the kernels do not take (Dh
// other than 48, 64, 96, 112, 128 or 192, H % KH != 0, too many blocks),
// or 10000 + the CUresult if a
// tensor map cannot be encoded. Layouts as at the top; q, k, v, dO and the
// gradients bf16 (dK/dV's split partials fp32), o, lse and D fp32, the
// positions int32; every tensor contiguous and, for q, k, v and dO,
// 16-byte aligned (TMA). Call (a), then (b), then (r) when splits > 1, and
// (c); (b) and (c) read D.

// The tiles, for the wrapper to check its copy of the schedule against:
// (b)'s keys a block and queries a step, (c)'s folded rows a block and
// keys a tile, and the warpgroups that take (b)'s steps in turn (2; 1 at
// Dh 192, where both take every step, each half the head dim), at head
// size Dh
extern "C" int attn_bwd_bf16_tiles(int Dh, int* key_tile, int* query_tile,
                                   int* rows, int* key_step, int* groups) {
  return at_head_dim(Dh, [&](auto dh) {
    *key_tile = kKeyTile;
    *query_tile = kQueryTile;
    *rows = kRowTile;
    *key_step = kKeyStep;
    *groups = decltype(dh)::value == 192 ? 1 : kWG;
    return 0;
  });
}

// Whether the position instantiations are built at head size Dh: at every
// head size the kernels take
extern "C" int attn_bwd_bf16_positions_built(int Dh) {
  int built = 0;
  at_head_dim(Dh, [&](auto) {
    built = 1;
    return 0;
  });
  return built;
}

// (a) D (B, H, Sq) from bf16 dO (B, Sq, H, Dh) and the training forward's
// fp32 o
extern "C" int attn_bwd_bf16_dot_launch(const void* dout, const void* out,
                                        void* D, int B, int Sq, int H, int Dh,
                                        void* stream) {
  if (!shape_ok(B, Sq, 1, H, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return at_head_dim(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    const int64_t lanes = static_cast<int64_t>(B) * Sq * H * kDotLanes<DH>;
    const int64_t blocks = (lanes + kDotThreads - 1) / kDotThreads;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    attn_bwd_bf16_dot_kernel<DH><<<static_cast<unsigned>(blocks),
                                   kDotThreads, 0, st>>>(
        static_cast<const bf16*>(dout), static_cast<const float*>(out),
        static_cast<float*>(D), B, Sq, H);
    return static_cast<int>(cudaGetLastError());
  });
}

// (b) dk, dv (B, Skv, KH, Dh) bf16 with splits = 1; with splits > 1 dk and
// dv are (splits, B, Skv, KH, Dh) fp32 partials for (r). q_pos, kv_pos:
// both null (the index masks) or (Sq,) and (Skv,) int32 on the card
extern "C" int attn_bwd_bf16_dkdv_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* D,
                                         void* dk, void* dv,
                                         const void* q_pos,
                                         const void* kv_pos, int B, int Sq,
                                         int Skv, int H, int KH, int Dh,
                                         int causal, int window, int splits,
                                         void* stream) {
  if (!shape_ok(B, Sq, Skv, H, KH) || splits < 1 ||
      (q_pos == nullptr) != (kv_pos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto i = [](const void* p) { return static_cast<const int*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return at_head_dim(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    if (splits > 1)
      return dkdv_at<float, DH>(q, k, v, dout, f(lse), f(D), dk, dv,
                                i(q_pos), i(kv_pos), B, Sq, Skv, H, KH,
                                causal, window, splits, st);
    return dkdv_at<bf16, DH>(q, k, v, dout, f(lse), f(D), dk, dv, i(q_pos),
                             i(kv_pos), B, Sq, Skv, H, KH, causal, window,
                             splits, st);
  });
}

// (r) dk, dv (n elements each, n % 4 == 0, bf16) from the fp32 partials
// part (2, splits, n): dK's, then dV's
extern "C" int attn_bwd_bf16_reduce_launch(const void* part, void* dk,
                                           void* dv, long long n, int splits,
                                           void* stream) {
  if (n < 4 || n % 4 != 0 || splits < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = n / 4;
  int64_t blocks = (2 * n4 + kDotThreads - 1) / kDotThreads;
  if (blocks > 8192) blocks = 8192;  // grid-stride past that
  attn_bwd_bf16_reduce_kernel<<<static_cast<unsigned>(blocks), kDotThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(part), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n4, splits);
  return static_cast<int>(cudaGetLastError());
}

// (c) dq (B, Sq, H, Dh) bf16; q_pos, kv_pos as for (b)
extern "C" int attn_bwd_bf16_dq_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* D,
                                       void* dq, const void* q_pos,
                                       const void* kv_pos, int B, int Sq,
                                       int Skv, int H, int KH, int Dh,
                                       int causal, int window, void* stream) {
  if (!shape_ok(B, Sq, Skv, H, KH) ||
      (q_pos == nullptr) != (kv_pos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto i = [](const void* p) { return static_cast<const int*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return at_head_dim(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    return dq_at<DH>(q, k, v, dout, f(lse), f(D), dq, i(q_pos), i(kv_pos), B,
                     Sq, Skv, H, KH, causal, window, st);
  });
}
