// GQA attention backward for Hopper (sm_90a): the gradients of K3.
//
// Replaces: nothing on the TPU. The reference trains through its pure-JAX
// chunked_attention (src/repro/models/attention.py:33-106), with
// jax.checkpoint per KV chunk, so its backward recomputes each chunk's
// scores; no Pallas backward exists. This file does the same recomputation
// on the card, from the row log-sum-exp that K3's training instantiation
// (csrc/flash_attention.cu, kLse) saves. It replaces the first version of
// this file, whose dK/dV and dQ kernels ran every product as fp32 FMAs on
// the CUDA cores with one dK/dV block per (key tile, KV head, batch).
//
// Computes, for q, dO (B, Sq, H, Dh), k, v (B, Skv, KH, Dh), the forward's
// o (B, Sq, H, Dh) and lse (B, H, Sq), all fp32 (bf16 goes to
// flash_attention_bwd_bf16.cu) and contiguous, G = H / KH and query head
// h = kh*G + g reading KV head kh, scale = 1/sqrt(Dh):
//   P_ij  = exp(scale * q_i.k_j - lse_i)     where (i, j) is unmasked, else 0
//   D_i   = sum_d dO_id o_id                 (= sum_j P_ij dP_ij)
//   dP_ij = dO_i . v_j,   dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_{g, i} dS_ij q_i,    dv_j = sum_{g, i} P_ij dO_i
// with the forward's masks: causal keeps pos_j <= pos_i, a window keeps
// pos_j > pos_i - window, a key at a negative position is invalid, with
// the indices as positions (counted from 0 on both sides) or, in the
// position instantiations (template flag kPos), explicit q_pos and kv_pos
// int32; ragged Sq and Skv masked here. A fully masked row has lse = +inf
// and o = 0, so its P, D and dS are 0 and it adds nothing to any
// gradient.
//
// Four kernels, no floating-point atomics: every output element is summed
// in one fixed order, so two runs give the same bits.
//   (a) attn_bwd_dot_kernel: D, Dh / 4 lanes a (b, i, h) row (rounded up
//       to 16 or 32, the extra lanes adding 0).
//   (b) attn_bwd_dkdv_kernel: a block owns 64 keys of one KV head and walks
//       a contiguous range of their (head g, query tile) steps; `splits`
//       blocks share a key tile's steps (split c takes steps
//       [n*c/splits, n*(c+1)/splits) of the n that the causal and window
//       bands leave) and write partial dK, dV.
//   (r) attn_bwd_reduce_kernel: with splits > 1, dK and dV as the sum of
//       the partials in split order.
//   (c) attn_bwd_dq_kernel: a block owns 64 query rows of one head and
//       walks the key tiles its rows can see.
//   (b'), (c') attn_bwd_dkdv_wide_kernel, attn_bwd_dq_wide_kernel: (b)
//       and (c) at Dh 192, below.
//
// What bounds it on this card: operations. Each unmasked (query, key) pair
// of each head costs five products of Dh multiply-adds (S, dP, dV, dK,
// dQ). At the training shape (B 8, S 256, H 9, KH 3, Dh 64, causal) that
// is 1.516 GFLOP: in split TF32 (three TF32 products for each) 4.55 GFLOP
// at 495 TFLOP/s, 9.19 us; on the fp32 CUDA cores 22.6 us at 67 TFLOP/s;
// the bytes (q, k, v, o, dO, lse read, dq, dk, dv, D written, ~25 MB) take
// 7.6 us at 3.35 TB/s. As run, (b) and (c) each recompute S and dP (seven
// products) over whole tiles (40,960 pairs a head against 32,896
// unmasked), so the tensor cores do 1.74 times the bound's work: 16 us.
//
// What the design does about it:
// - Every product runs on the tensor cores as wgmma.mma_async ... .tf32 in
//   split TF32 (wgmma_tf32.cuh, shared with the forward; the split rounds
//   with two integer operations, split4_int, not cvt.rna). Each tile's dV,
//   dK or dQ product is summed in fresh registers and joins its running
//   sum in one fp32 add: a chain that accumulated inside the tensor core
//   would drift past the fp32 gate, as the forward's P.V did.
// - Layouts for TF32 wgmma, which reads only K-major operands from shared
//   memory. (b): S^T = K.Q^T and dP^T = V.dO^T with K and V as A and Q and
//   dO K-major as stored; then dV += P^T.dO and dK += dS^T.Q with P^T and
//   dS^T as register A fragments taken straight from the S^T and dP^T
//   accumulators, so dO and Q are also written transposed (head dim as
//   rows, queries as the contraction, permuted within each group of 8 so
//   that a thread's accumulator columns 2t, 2t+1 are its A positions t,
//   t+4). (c): the forward's S = Q.K^T and dP = dO.V^T, then dQ += dS.K
//   with K written transposed and permuted the same way. Every operand is
//   split into big and small halves on its way into the canonical
//   no-swizzle layout (conflict-free: 8 threads write one 128-byte core
//   matrix).
// - Two warpgroups a block at Dh 64. They share the block's own operand
//   (K and V in (b), Q and dO in (c), loaded once by both) and each walks
//   every other step with tiles of its own, so one group's conversion and
//   softmax run while the other's products do; at the end the second
//   group's sums join the first's through shared memory, in that order.
//   Steps are 32 queries in (b) and 32 keys in (c). Shared memory: (b) K
//   and V in both halves (64 KB), and per group Q, Q^T, dO, dO^T (64 KB),
//   the next step's raw Q and dO (16 KB) and two sets of the step's lse
//   and D: 225 KB of the 227 KB a block can have; (c) Q and dO (64 KB),
//   per group K, V, K^T (48 KB) and the raw K and V (16 KB): 192 KB. At
//   Dh 128 one warpgroup a block, with 16-wide steps (208 KB and 192 KB;
//   (b) holds 128 accumulators a thread and spills a few hundred bytes).
//   Blocks of 256 threads (128 at Dh 128) at up to 255 registers, one a
//   SM.
// - Head sizes 48, 96 and 112 (MLA at reduced() and minicpm3-4b's qk_nope
//   + qk_rope; zamba2-7b's shared block) keep this design with their own
//   tiles (Cfg): Dh 48 as Dh 64 (two warpgroups, 32-wide steps; 169 KB
//   and 144 KB); Dh 96 two warpgroups with 16-wide steps (217 KB and 192
//   KB); Dh 112 one warpgroup, 16-query steps in (b) (182 KB: 32 would
//   take 253 KB) and 32-key steps in (c) (224 KB). The register-A products
//   (dV, dK, dQ) issue 48 output columns at a time at Dh 48 and 96
//   (m64n48k8) and 56 at 112 (m64n56k8), each summed in fresh registers
//   as at 64. Dh 112's 16-row tiles are 448 float4s, three and a half
//   passes of a warpgroup: the last pass is partial. Column groups rotate
//   within runs of 4 where a row's 12 or 28 groups are not a multiple of
//   8. Position instantiations exist at every head size (the reference's
//   loss_fn takes positions for every arch); they add 16 bytes of shared
//   memory (the bounds) to each layout.
// - A group's next step's raw tiles (and lse, D) are copied with cp.async
//   while its current step's products run; the conversion into split
//   layouts sits between two barriers of that group alone. S (S^T) and dP
//   (dP^T) are committed as two groups, so P is formed while dP is still
//   on the tensor cores. Steps whose tile is wholly unmasked skip the
//   per-element mask.
// - Filling the card: at the training shape one block per (key tile, KV
//   head, batch) is 4 x 3 x 8 = 96 blocks on 132 SMs, and under the causal
//   mask key tile 0 walks 24 steps (8 query tiles x 3 heads) while the
//   mean SM has 1440 / 132 = 10.9: the heaviest blocks set the time. The
//   wrapper (kernels/flash_attention.py::backward_plan) picks `splits`, the
//   smallest count that gives at least one block a SM, capped so that the
//   busiest key tile still gives each split a step a warpgroup: 2 at the
//   training shape (192 blocks of 12, 9, 6 or 3 steps, key tile 0 first;
//   on an H100 dK/dV took 41 us against 66 us unsplit, and 3, 4 or 6
//   splits were slower than 2), 6 at the federated shape (B 4, S 128: 144
//   blocks of at most 2 steps, where one block a key tile gave 24). With
//   splits > 1 the partials ((splits, B, Skv, KH, Dh) each for dK and dV,
//   6.3 MB at the training shape, held in L2) are summed by (r). (c)'s
//   grid is (query tile, head, batch) with the last query tiles (the most
//   keys under causal) first, as the forward orders its rows.
// - Explicit positions (kPos): no index band bounds the steps, and the
//   positions may tie and need not be sorted. A dK/dV block first reads
//   its keys' least and greatest valid position, then every query's, and
//   walks the query tiles from the first to the last that holds a query
//   that may see one of its keys; a dQ block likewise reads its rows'
//   least and greatest position and walks the key tiles from the first to
//   the last that holds a key one of its rows may see. Within those, each
//   element is masked by its positions (the keys' in registers, the
//   queries' read with plain loads; no cp.async, so no alignment rule for
//   them). For an arange these are the index band's tiles, and with the
//   wrapper's plan (sized from the index bounds) the gradients are the
//   index instantiations' bit for bit.
// - Dh 192 (deepseek-v3's MLA: qk_nope 128 + qk_rope 64, v padded) has
//   kernels of its own, (b') and (c'): split, a block's K and V (or Q and
//   dO) alone would take 4 x 48 KB = 192 KB of the 227 KB. So the block's
//   own operand stays raw in shared memory (48 KB each, rows padded by 4
//   floats so that rows 8 apart start 4 banks apart) and is the register
//   A operand of S^T (S) and dP^T (dP): each thread loads its fragment of
//   32 head-dim columns at a time and splits it in registers (m64n16k8
//   over those 4 k-steps, each part summed in fresh registers: the fp32
//   forward at 192 drifted past its gate with one 72-product chain a
//   tile). The steps are 16 queries (16 keys in dQ), split K-major and
//   transposed as at the other dims (24 KB each). What bounds them: at
//   deepseek-v3's training step (B 8, S 256, 128 heads, G 1, causal) the
//   bytes, 0.481 ms for 1.61 GB (64.7 GFLOP x 3 split TF32 take 0.392
//   ms); but a step's products are m64n16k8 and m64n64k8 on one 64-row
//   tile, each block alone on its SM. What their design does (times at
//   that shape on an H100 80GB HBM3 at 700 W, benchmarks/
//   torch_k3_wide_probe.py; 4.39 ms for D, dK/dV and dQ with both
//   warpgroups computing S^T and dP^T (S, dP) in full every step):
//   . The two warpgroups split a step by product, so each runs once: in
//     (b') warpgroup 0 converts the step's Q, computes S^T from K and P^T
//     from it and hands P^T to warpgroup 1 through shared memory (8
//     floats a thread, in the accumulator layout, behind named barrier
//     3); warpgroup 1 converts dO, computes dP^T from V, splits P^T for
//     dV, forms dS^T and hands it back (barrier 4); then warpgroup 0 sums
//     all 192 columns of dK and warpgroup 1 of dV (m64n64k8), 96
//     accumulators a thread each. (c') likewise: warpgroup 0 K (K-major
//     and transposed) and S, warpgroup 1 V and dP; each then sums half of
//     dQ's columns from K^T, which warpgroup 0 rewrites only once
//     warpgroup 1 is done with it (barrier 5). Each warpgroup waits only
//     at its own barriers for its own tile; the hand-overs are the only
//     meetings. Four products a step (three in dQ) where both warpgroups
//     computing S^T and dP^T did six (five).
//   . Two products in flight: S^T's (S's) next 32-column part is loaded,
//     split and issued before the last is waited for, and dK's, dV's and
//     dQ's column products likewise (3.39 -> 3.32 ms against one at a
//     time, the probe's "one product in flight").
//   . dQ's blocks the query tile slowest (the last rows first): 1.3 %
//     faster at this shape than head-major (the probe's "other block
//     order"); dK/dV's head-major (a head's key tiles next to each other,
//     key tile 0 first), as the bf16 kernel's: within the spread of the
//     other order at this shape.
//   Shared memory: (b') 222 KB, (c') 198 KB; 256 threads a block, one a
//   SM; dK/dV at 255 registers spills 120 B (56 B with positions).
// Left for later: computing S and dP once for both dK/dV and dQ, a deeper
// cp.async ring (shared memory is full at Dh 64), folding D and the reduce
// into the other kernels; at Dh 192 wider S products than m64n16k8 (32-row
// steps do not fit beside K and V) and overlapping a step's conversion
// with the last step's products (a trial that converted the next step's
// K-major tile during this one's hand-over was slower).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kWGThreads = 128;   // a warpgroup
constexpr int kDotThreads = 256;  // (a), (r)
constexpr int kKeyTile = 64;      // (b): the keys a block owns (wgmma's M)
constexpr int kRowTile = 64;      // (c): the query rows a block owns

// Warpgroups a block, (b)'s query tile and (c)'s key tile (the N of S^T
// and S, and the contraction of the dV, dK and dQ products), and the
// output columns one register-A wgmma of those products issues (48 at Dh
// 48 and 96, 56 at 112: their widths are not a multiple of 64)
template <int DH> struct Cfg;
template <> struct Cfg<48> {
  static constexpr int kWG = 2, kQ = 32, kK = 32, kN = 48;
};
template <> struct Cfg<64> {
  static constexpr int kWG = 2, kQ = 32, kK = 32, kN = 64;
};
template <> struct Cfg<96> {
  static constexpr int kWG = 2, kQ = 16, kK = 16, kN = 48;
};
template <> struct Cfg<112> {
  static constexpr int kWG = 1, kQ = 16, kK = 32, kN = 56;
};
template <> struct Cfg<128> {
  static constexpr int kWG = 1, kQ = 16, kK = 16, kN = 64;
};
// Dh 192's kernels (b') and (c'): kWG counts the groups that share out
// the steps, 1 (both warpgroups take every step, split between them by
// product)
template <> struct Cfg<192> {
  static constexpr int kWG = 1, kQ = 16, kK = 16;
};
constexpr int kSmemLimit = 232448;  // the opt-in shared memory of a block

// (b') and (c'): the head dim, the threads a block, the columns of dQ
// each warpgroup sums in (c'), a raw row of the block's own operand
// (padded: rows 8 apart start 4 banks apart, so a warp's A-fragment loads
// meet no conflict) and the head-dim columns of one part of S^T (S) and
// dP^T (dP), summed in fresh registers
constexpr int kWideDH = 192;
constexpr int kWideThreads = 2 * kWGThreads;
constexpr int kWideHalf = kWideDH / 2;
constexpr int kWideRow = kWideDH + 4;
constexpr int kWidePart = 32;
// (b') and (c')'s named barriers between the warpgroups (group_sync takes
// 1 and 2): P handed over, dS handed back, and in (c') K^T free again
constexpr int kBarP = 3, kBarDS = 4, kBarKt = 5;

// (b')'s shared memory from a 128-aligned base: K and V raw, then the
// step's Q, dO, Q^T and dO^T split, its raw Q and dO, two sets of lse and
// D, the hand-over slots (8 floats a thread of a warpgroup), then, with
// explicit positions, 4 bounds
template <bool kPos>
struct DkdvWideSmem {
  static constexpr int kQT = Cfg<kWideDH>::kQ;
  static constexpr uint32_t kRaw = kKeyTile * kWideRow * 4;  // K or V
  static constexpr uint32_t kTh = kQT * kWideDH * 4;  // a step tile, a half
  static constexpr uint32_t kK = 0, kV = kRaw, kQ = 2 * kRaw,
                            kO = kQ + 2 * kTh, kQt = kO + 2 * kTh,
                            kOt = kQt + 2 * kTh, kRawQ = kOt + 2 * kTh,
                            kRawO = kRawQ + kTh, kStats = kRawO + kTh;
  static constexpr uint32_t kX = kStats + 2 * 2 * kQT * 4;
  static constexpr uint32_t kPosAt = kX + 8 * kWGThreads * 4;
  static constexpr uint32_t kBytes = kPosAt + (kPos ? 16 : 0) + 128;
  static_assert(kBytes <= kSmemLimit, "over the opt-in shared memory");
};

// (c')'s: Q and dO raw, then the step's K, V and K^T split, its raw K
// and V, the hand-over slots, then, with explicit positions, 4 bounds
template <bool kPos>
struct DqWideSmem {
  static constexpr int kKT = Cfg<kWideDH>::kK;
  static constexpr uint32_t kRaw = kRowTile * kWideRow * 4;  // Q or dO
  static constexpr uint32_t kTh = kKT * kWideDH * 4;
  static constexpr uint32_t kQ = 0, kO = kRaw, kK = 2 * kRaw,
                            kV = kK + 2 * kTh, kKt = kV + 2 * kTh,
                            kRawK = kKt + 2 * kTh, kRawV = kRawK + kTh,
                            kX = kRawV + kTh;
  static constexpr uint32_t kPosAt = kX + 8 * kWGThreads * 4;
  static constexpr uint32_t kBytes = kPosAt + (kPos ? 16 : 0) + 128;
  static_assert(kBytes <= kSmemLimit, "over the opt-in shared memory");
};

// (b)'s shared memory, in bytes from a 128-aligned base: K and V, then
// each warpgroup's Q, Q^T, dO, dO^T, raw Q and dO and two sets of lse and
// D, then, with explicit positions, 4 bounds. Each split operand is a big
// half then a small half, `half` bytes on.
template <int DH, bool kPos>
struct DkdvSmem {
  static constexpr int kWG = Cfg<DH>::kWG, kQT = Cfg<DH>::kQ;
  static constexpr uint32_t kKV = kKeyTile * DH * 4;  // K or V, one half
  static constexpr uint32_t kQh = kQT * DH * 4;       // Q-sized, one half
  static constexpr uint32_t kK = 0, kV = 2 * kKV, kGroup0 = 4 * kKV;
  static constexpr uint32_t kQ = 0, kQt = 2 * kQh, kO = 4 * kQh,
                            kOt = 6 * kQh, kRawQ = 8 * kQh, kRawO = 9 * kQh,
                            kStats = 10 * kQh;        // within a group
  static constexpr uint32_t kGroup = kStats + 2 * 2 * kQT * 4;
  static constexpr uint32_t kPosAt = kGroup0 + kWG * kGroup;
  static constexpr uint32_t kBytes = kPosAt + (kPos ? 16 : 0) + 128;
  static_assert(kBytes <= kSmemLimit, "over the opt-in shared memory");
  static_assert(kWG == 1 || DH * kWGThreads * 4 <= kGroup,
                "the second group's dK, dV sums fit its region");
};

// (c)'s shared memory: Q and dO, then each warpgroup's K, V, K^T and raw
// K and V, then, with explicit positions, 4 bounds
template <int DH, bool kPos>
struct DqSmem {
  static constexpr int kWG = Cfg<DH>::kWG, kKT = Cfg<DH>::kK;
  static constexpr uint32_t kQh = kRowTile * DH * 4;  // Q or dO, one half
  static constexpr uint32_t kKh = kKT * DH * 4;       // K-sized, one half
  static constexpr uint32_t kQ = 0, kO = 2 * kQh, kGroup0 = 4 * kQh;
  static constexpr uint32_t kK = 0, kV = 2 * kKh, kKt = 4 * kKh,
                            kRawK = 6 * kKh, kRawV = 7 * kKh;  // in a group
  static constexpr uint32_t kGroup = 8 * kKh;
  static constexpr uint32_t kPosAt = kGroup0 + kWG * kGroup;
  static constexpr uint32_t kBytes = kPosAt + (kPos ? 16 : 0) + 128;
  static_assert(kBytes <= kSmemLimit, "over the opt-in shared memory");
  static_assert(kWG == 1 || DH / 2 * kWGThreads * 4 <= kGroup,
                "the second group's dQ sums fit its region");
};


// With explicit positions: the first and last index in [0, n) whose
// position p satisfies may_see(p), by the block's T threads, through the
// 4 ints at `bounds` (whose first two the caller has set). Returns false
// if there is none.
template <int T, typename Pred>
__device__ __forceinline__ bool index_range(const int* __restrict__ pos,
                                            int n, Pred may_see, int* bounds,
                                            int& first, int& last) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x; i < n; i += T)
    if (may_see(pos[i])) {
      lo = min(lo, i);
      hi = max(hi, i);
    }
  block_min(bounds + 2, lo);
  block_max(bounds + 3, hi);
  __syncthreads();
  first = bounds[2];
  last = bounds[3];
  return first <= last;
}

// a barrier over the 128 threads of warpgroup wg only (ids 1, 2, ...)
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void store_split(uint8_t* big, uint32_t half,
                                            uint32_t off, const float4& x) {
  float4 hi, lo;
  split4_int(x, hi, lo);
  *reinterpret_cast<float4*>(big + off) = hi;
  *reinterpret_cast<float4*>(big + half + off) = lo;
}

// Loops over the u < N elements of a tile, u = it * T + tid for T
// threads, fully unrolled so that a thread's loads are all in flight
// together. Where T does not divide N (Dh 112's 16-row tiles: 448 float4s
// over 128 threads) the last pass is partial and `in` skips the rest.
template <int N, int T>
struct Passes {
  static constexpr int value = (N + T - 1) / T;
  static __device__ __forceinline__ bool in(int u) {
    return N % T == 0 || u < N;
  }
};

// Row and column (in c) of float4 u of a tile of DH-float rows, in an
// order free of bank conflicts for the K-major writes (and reads of a
// row-major tile): each 8 threads take rows r..r+7 at column groups
// rotated by the row, within runs of 8 groups (of 4 at Dh 48 and 112,
// whose 12 and 28 groups are not a multiple of 8).
template <int DH>
__device__ __forceinline__ int rotated(int u, int& c) {
  constexpr int kGroups = DH / 4, kRot = kGroups % 8 == 0 ? 8 : 4;
  const int j = u & 7, rest = u >> 3;
  const int cc = rest % kGroups;
  c = ((cc & ~(kRot - 1)) | ((cc + j) & (kRot - 1))) * 4;
  return (rest / kGroups) * 8 + j;
}

// ROWS rows of DH elements, row-major at `raw`, into a split K-major
// operand (rows as rows), by one warpgroup
template <int ROWS, int DH>
__device__ __forceinline__ void to_kmajor(const float* raw, uint8_t* dst,
                                          uint32_t half, int tid) {
  using P = Passes<ROWS * (DH / 4), kWGThreads>;
#pragma unroll
  for (int it = 0; it < P::value; ++it) {
    const int u = it * kWGThreads + tid;
    if (!P::in(u)) continue;
    int c;
    const int r = rotated<DH>(u, c);
    store_split(dst, half, kmajor(r, c, ROWS), load4(raw + r * DH + c));
  }
}

// The same rows transposed: head dim as rows, the ROWS positions as the
// contraction, position p of each group of 8 holding row 2*(p%4) + p/4,
// so that an accumulator fragment (a thread's columns 2t, 2t+1) is the A
// fragment (positions t, t+4) of a product over those rows
template <int ROWS, int DH>
__device__ __forceinline__ void to_transposed(const float* raw, uint8_t* dst,
                                              uint32_t half, int tid) {
  using P = Passes<DH * (ROWS / 4), kWGThreads>;
#pragma unroll
  for (int it = 0; it < P::value; ++it) {
    const int u = it * kWGThreads + tid;
    if (!P::in(u)) continue;
    const int n = u % DH, p4 = u / DH;
    const int r0 = (p4 >> 1) * 8 + (p4 & 1);
    store_split(dst, half, kmajor(n, p4 * 4, DH),
                make_float4(raw[r0 * DH + n], raw[(r0 + 2) * DH + n],
                            raw[(r0 + 4) * DH + n], raw[(r0 + 6) * DH + n]));
  }
}

// ROWS rows row0.. of head `head` of a (.., rows, heads, DH) tensor straight
// from global memory into a split K-major operand, by the T threads of the
// block; rows past `rows` are 0
template <int ROWS, int DH, int T>
__device__ __forceinline__ void load_kmajor(const float* src,
                                            int64_t batch_off, int row0,
                                            int rows, int heads, int head,
                                            uint8_t* dst, uint32_t half,
                                            int tid) {
  using P = Passes<ROWS * (DH / 4), T>;
  float4 x[P::value];
#pragma unroll
  for (int it = 0; it < P::value; ++it) {
    if (!P::in(it * T + tid)) continue;
    int c;
    const int r = rotated<DH>(it * T + tid, c);
    x[it] = row0 + r < rows
                ? load4(src + ((batch_off + row0 + r) * heads + head) *
                                  static_cast<int64_t>(DH) + c)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int it = 0; it < P::value; ++it) {
    if (!P::in(it * T + tid)) continue;
    int c;
    const int r = rotated<DH>(it * T + tid, c);
    store_split(dst, half, kmajor(r, c, ROWS), x[it]);
  }
}

// cp.async of ROWS rows row0.. of head `head` into a row-major raw tile, by
// one warpgroup, in 16-byte chunks of 4 elements; rows past `rows` are
// zero-filled
template <int ROWS, int DH>
__device__ __forceinline__ void copy_rows(const float* src, int64_t batch_off,
                                          int row0, int rows, int heads,
                                          int head, uint32_t dst, int tid) {
  constexpr int kVec = 4;
  using P = Passes<ROWS * (DH / kVec), kWGThreads>;
#pragma unroll
  for (int it = 0; it < P::value; ++it) {
    const int u = it * kWGThreads + tid;
    if (!P::in(u)) continue;
    const int r = u / (DH / kVec), c = (u % (DH / kVec)) * kVec;
    const bool ok = row0 + r < rows;
    const float* p =
        ok ? src + ((batch_off + row0 + r) * heads + head) *
                       static_cast<int64_t>(DH) + c
           : src;
    cp_async16(dst + u * 16, p, ok ? 16 : 0);
  }
}

// acc += A . B over K/8 k-steps: A from registers (a[4j..4j+3] are the
// accumulator fragment of a 64 x K product, so positions t, t+4 of k-step j
// are its columns 8j + 2t, 8j + 2t + 1), B the transposed operand (DH
// rows, big half at `bb`, small half at `bs`), N = Cfg<DH>::kN output
// columns at a time. Split TF32, small terms first, in fresh registers,
// then one fp32 add.
template <int K, int DH>
__device__ __forceinline__ void product_rs(float (&acc)[DH / 2],
                                           const uint32_t (&ab)[K / 2],
                                           const uint32_t (&as)[K / 2],
                                           uint32_t bb, uint32_t bs) {
  constexpr int N = Cfg<DH>::kN;
  static_assert(DH % N == 0, "whole wgmma products");
#pragma unroll
  for (int c = 0; c < DH / N; ++c) {
    float t[N / 2];
#pragma unroll
    for (int x = 0; x < N / 2; ++x) t[x] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < K / 8; ++j)
      wgmma_rs<N>(t, as[4 * j], as[4 * j + 2], as[4 * j + 1], as[4 * j + 3],
                  desc(bb + c * N * 32 + j * DH * 32));
#pragma unroll
    for (int j = 0; j < K / 8; ++j)
      wgmma_rs<N>(t, ab[4 * j], ab[4 * j + 2], ab[4 * j + 1], ab[4 * j + 3],
                  desc(bs + c * N * 32 + j * DH * 32));
#pragma unroll
    for (int j = 0; j < K / 8; ++j)
      wgmma_rs<N>(t, ab[4 * j], ab[4 * j + 2], ab[4 * j + 1], ab[4 * j + 3],
                  desc(bb + c * N * 32 + j * DH * 32));
    wgmma_commit_and_wait();
    fence_regs(t);
#pragma unroll
    for (int x = 0; x < N / 2; ++x) acc[N / 2 * c + x] += t[x];
  }
}

// d (64 x N) = A . B^T over DH, both split K-major in shared memory (A of
// 64 rows, B of N rows; big halves at ab, bb, small ones `ah`, `bh` bytes
// on): small terms first. Issued, not waited for.
template <int N, int DH>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t ab,
                                           uint32_t ah, uint32_t bb,
                                           uint32_t bh) {
#pragma unroll
  for (int k8 = 0; k8 < DH / 8; ++k8)
    wgmma_ss<N>(d, desc(ab + ah + k8 * 64 * 32), desc(bb + k8 * N * 32),
                k8 > 0);
#pragma unroll
  for (int k8 = 0; k8 < DH / 8; ++k8)
    wgmma_ss<N>(d, desc(ab + k8 * 64 * 32), desc(bb + bh + k8 * N * 32), 1);
#pragma unroll
  for (int k8 = 0; k8 < DH / 8; ++k8)
    wgmma_ss<N>(d, desc(ab + k8 * 64 * 32), desc(bb + k8 * N * 32), 1);
}

// With two warpgroups a block, the second parks its sums in shared memory
// (`buf`, N floats a thread) and the first adds them to its own: first +
// second, a fixed order
template <int N>
__device__ __forceinline__ void park(const float (&a)[N], float* buf,
                                     int tid) {
#pragma unroll
  for (int x = 0; x < N; ++x) buf[x * kWGThreads + tid] = a[x];
}
template <int N>
__device__ __forceinline__ void gather(float (&a)[N], const float* buf,
                                       int tid) {
#pragma unroll
  for (int x = 0; x < N; ++x) a[x] += buf[x * kWGThreads + tid];
}

// (a)'s lanes a row: DH / 4 float4s, rounded up to a power of two (16 at
// Dh 48 and 64, 32 at 96, 112 and 128) so that a row's lanes are one
// shuffle tree within a warp; the lanes past DH / 4 add 0. At Dh 192 32
// lanes, lane l also taking float4 l + 32.
template <int DH>
struct DotLanes {
  static constexpr int value = DH / 4 <= 16 ? 16 : 32;
};

// four elements a thread (eight for some lanes at Dh 192), summed in fp32
template <int DH>
__global__ void __launch_bounds__(kDotThreads)
attn_bwd_dot_kernel(const float* __restrict__ dout,
                    const float* __restrict__ out, float* __restrict__ D,
                    int B, int Sq, int H) {
  constexpr int kLanes = DotLanes<DH>::value, kVec = DH / 4;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kDotThreads +
                    threadIdx.x;
  const int64_t row = u / kLanes;
  const int lane = static_cast<int>(u % kLanes);
  const bool ok = row < static_cast<int64_t>(B) * Sq * H;
  float s = 0.f;
#pragma unroll
  for (int c = lane; ok && c < kVec; c += kLanes) {
    const int64_t e = (row * kVec + c) * 4;
    const float4 a = load4(dout + e);
    const float4 o = load4(out + e);
    s += fmaf(a.x, o.x, fmaf(a.y, o.y, fmaf(a.z, o.z, a.w * o.w)));
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

template <int DH, bool kPos>
__global__ void __launch_bounds__(Cfg<DH>::kWG * kWGThreads, 1)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ D, float* __restrict__ dk,
                     float* __restrict__ dv, const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos, int B, int Sq, int Skv,
                     int H, int KH, int causal, int window, int splits,
                     int64_t split_stride, float scale) {
  using L = DkdvSmem<DH, kPos>;
  constexpr int QT = L::kQT, WG = L::kWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 127u) & ~127u;
  uint8_t* smem = smem_raw + (base - raw_base);

  // block -> (key tile, batch, KV head, split), key tile slowest: under the
  // causal mask the first key tiles have the most steps and start first
  int id = blockIdx.x;
  const int c = id % splits;
  id /= splits;
  const int kh = id % KH;
  id /= KH;
  const int b = id % B, k0 = (id / B) * kKeyTile;
  const int G = H / KH;
  const int wg = threadIdx.x / kWGThreads, tid = threadIdx.x % kWGThreads;
  const uint32_t gbase = base + L::kGroup0 + wg * L::kGroup;
  uint8_t* gsmem = smem + L::kGroup0 + wg * L::kGroup;

  // the queries that can see keys [k0, k_last], in tiles; the steps are
  // (g, query tile) with g slowest, this block takes [s_lo, s_hi) and
  // warpgroup wg every WG-th of them from s_lo + wg
  const int k_last = min(k0 + kKeyTile, Skv) - 1;
  int qt0, nq;
  if constexpr (kPos) {  // bounds: {least, greatest key position, first,
                         // last query that may see one}
    int* bounds = reinterpret_cast<int*>(smem + L::kPosAt);
    if (threadIdx.x == 0) {
      bounds[0] = bounds[2] = INT_MAX;
      bounds[1] = bounds[3] = INT_MIN;
    }
    __syncthreads();
    const int j = k0 + static_cast<int>(threadIdx.x);
    const int kp = j <= k_last && threadIdx.x < kKeyTile ? kv_pos[j] : -1;
    block_min(bounds, kp >= 0 ? kp : INT_MAX);
    block_max(bounds + 1, kp);
    __syncthreads();
    const int kp_min = bounds[0], kp_max = bounds[1];
    int first, last;
    const bool any =
        kp_min <= kp_max &&
        index_range<WG * kWGThreads>(
            q_pos, Sq,
            [=](int qp) {
              return (!causal || kp_min <= qp) &&
                     (window <= 0 || kp_max > qp - window);
            },
            bounds, first, last);
    qt0 = any ? first / QT : 0;
    nq = any ? last / QT + 1 - qt0 : 0;
  } else {
    const int q_begin = causal ? k0 : 0;
    const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
    qt0 = q_begin / QT;
    nq = q_end > q_begin ? (q_end + QT - 1) / QT - qt0 : 0;
  }
  const int64_t n = static_cast<int64_t>(G) * nq;
  const int s_lo = static_cast<int>(n * c / splits);
  const int s_hi = static_cast<int>(n * (c + 1) / splits);

  const int64_t q_batch = static_cast<int64_t>(b) * Sq;
  // the warpgroup's i-th step's raw Q, dO, lse and D, by cp.async
  auto issue = [&](int i) {
    const int s = s_lo + wg + i * WG;
    const int h = kh * G + s / nq, q0 = (qt0 + s % nq) * QT;
    copy_rows<QT, DH>(q, q_batch, q0, Sq, H, h, gbase + L::kRawQ, tid);
    copy_rows<QT, DH>(dout, q_batch, q0, Sq, H, h, gbase + L::kRawO, tid);
    if (tid < QT) {
      const uint32_t st = gbase + L::kStats + (i & 1) * 2 * QT * 4 + tid * 4;
      const bool ok = q0 + tid < Sq;
      const int64_t off =
          ok ? (static_cast<int64_t>(b) * H + h) * Sq + q0 + tid : 0;
      cp_async4(st, lse + off, ok ? 4 : 0);
      cp_async4(st + QT * 4, D + off, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  const int steps = s_hi - s_lo > wg ? (s_hi - s_lo - wg + WG - 1) / WG : 0;
  if (steps > 0) issue(0);

  // K and V: this block's keys, split, K-major, by every thread; zeros
  // past Skv
  const int64_t kv_batch = static_cast<int64_t>(b) * Skv;
  load_kmajor<kKeyTile, DH, WG * kWGThreads>(
      k, kv_batch, k0, Skv, KH, kh, smem + L::kK, L::kKV, threadIdx.x);
  load_kmajor<kKeyTile, DH, WG * kWGThreads>(
      v, kv_batch, k0, Skv, KH, kh, smem + L::kV, L::kKV, threadIdx.x);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // this thread's two key rows of the accumulators
  const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int keyA = k0 + warp * 16 + lane / 4, keyB = keyA + 8;
  int kpA = -1, kpB = -1;  // their explicit positions (-1 past Skv)
  if constexpr (kPos) {
    kpA = keyA < Skv ? kv_pos[keyA] : -1;
    kpB = keyB < Skv ? kv_pos[keyB] : -1;
  }
  float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int s = s_lo + wg + i * WG;
    cp_async_wait_all();
    group_sync(wg);  // step i's raw tiles are in; step i-1's products done
    const float* rq = reinterpret_cast<const float*>(gsmem + L::kRawQ);
    const float* ro = reinterpret_cast<const float*>(gsmem + L::kRawO);
    to_kmajor<QT, DH>(rq, gsmem + L::kQ, L::kQh, tid);
    to_transposed<QT, DH>(rq, gsmem + L::kQt, L::kQh, tid);
    to_kmajor<QT, DH>(ro, gsmem + L::kO, L::kQh, tid);
    to_transposed<QT, DH>(ro, gsmem + L::kOt, L::kQh, tid);
    // the split tiles were written by the generic proxy; wgmma reads them
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    group_sync(wg);  // the raw buffers are free
    if (i + 1 < steps) issue(i + 1);
    const int q0 = (qt0 + s % nq) * QT;
    const float* lse_s = reinterpret_cast<const float*>(
        gsmem + L::kStats + (i & 1) * 2 * QT * 4);
    const float* D_s = lse_s + QT;

    // S^T = K.Q^T and dP^T = V.dO^T (64 keys x QT queries), two groups:
    // P is formed while dP^T is still on the tensor cores
    float st[QT / 2], dpt[QT / 2];
#pragma unroll
    for (int x = 0; x < QT / 2; ++x) st[x] = dpt[x] = 0.f;
    wgmma_fence();
    product_ss<QT, DH>(st, base + L::kK, L::kKV, gbase + L::kQ, L::kQh);
    wgmma_commit();
    product_ss<QT, DH>(dpt, base + L::kV, L::kKV, gbase + L::kO, L::kQh);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T on the fragments, split: st[4j + e] is (keyA, query q0 + 8j +
    // 2t4 + e) and st[4j + 2 + e] is (keyB, the same query)
    const bool all = !kPos && all_visible(q0, q0 + QT - 1, k0,
                                          k0 + kKeyTile - 1, Sq, Skv, causal,
                                          window);
    uint32_t pb[QT / 2], ps[QT / 2];
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t4 + e, qi = q0 + col;
        const float l = lse_s[col];
        int qp = 0;
        if constexpr (kPos) qp = qi < Sq ? q_pos[qi] : 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r + e;
          bool in;
          if constexpr (kPos)
            in = qi < Sq && sees(qp, r ? kpB : kpA, causal, window);
          else
            in = all || visible(qi, r ? keyB : keyA, Sq, Skv, causal, window);
          const float p = in ? expf(st[x] * scale - l) : 0.f;
          pb[x] = tf32_int(p);
          ps[x] = tf32_int(p - __uint_as_float(pb[x]));
        }
      }
    wgmma_wait<0>();
    fence_regs(dpt);
    // dV += P^T.dO; then dS^T = P^T (dP^T - D), with P as its two parts
    // (within 2^-22 of it), split, and dK += dS^T.Q (scaled at the end)
    product_rs<QT, DH>(dv_acc, pb, ps, gbase + L::kOt,
                       gbase + L::kOt + L::kQh);
#pragma unroll
    for (int x = 0; x < QT / 2; ++x) {
      const float d = D_s[8 * (x / 4) + 2 * t4 + (x & 1)];
      const float g = (__uint_as_float(pb[x]) + __uint_as_float(ps[x])) *
                      (dpt[x] - d);
      pb[x] = tf32_int(g);
      ps[x] = tf32_int(g - __uint_as_float(pb[x]));
    }
    product_rs<QT, DH>(dk_acc, pb, ps, gbase + L::kQt,
                       gbase + L::kQt + L::kQh);
  }

  if constexpr (WG > 1) {  // the second group's sums join the first's
    float* buf = reinterpret_cast<float*>(smem + L::kGroup0 + L::kGroup);
    if (wg == 1) {
      park(dk_acc, buf, tid);
      park(dv_acc, buf + (DH / 2) * kWGThreads, tid);
    }
    __syncthreads();
    if (wg == 1) return;
    gather(dk_acc, buf, tid);
    gather(dv_acc, buf + (DH / 2) * kWGThreads, tid);
  }

  // dK, dV (or this split's partials): rows past Skv are not written
  float* dk_out = dk + c * split_stride;
  float* dv_out = dv + c * split_stride;
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

// dk, dv (n elements each) = the sum over s < splits, in order, of the
// partials part[s * n ..] and part[(splits + s) * n ..]
__global__ void __launch_bounds__(kDotThreads)
attn_bwd_reduce_kernel(const float4* __restrict__ part,
                       float* __restrict__ dk, float* __restrict__ dv,
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
    store4((w ? dv : dk) + e * 4, s);
  }
}

template <int DH, bool kPos>
__global__ void __launch_bounds__(Cfg<DH>::kWG * kWGThreads, 1)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ D, float* __restrict__ dq,
                   const int* __restrict__ q_pos,
                   const int* __restrict__ kv_pos, int B, int Sq, int Skv,
                   int H, int KH, int causal, int window, float scale) {
  using L = DqSmem<DH, kPos>;
  constexpr int KT = L::kKT, WG = L::kWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 127u) & ~127u;
  uint8_t* smem = smem_raw + (base - raw_base);

  // block -> (query tile, batch, head), the last query tiles (the most keys
  // under the causal mask) first
  int id = blockIdx.x;
  const int h = id % H;
  id /= H;
  const int b = id % B;
  const int n_qt = (Sq + kRowTile - 1) / kRowTile;
  const int q0 = (n_qt - 1 - id / B) * kRowTile;
  const int kh = h / (H / KH);
  const int wg = threadIdx.x / kWGThreads, tid = threadIdx.x % kWGThreads;
  const uint32_t gbase = base + L::kGroup0 + wg * L::kGroup;
  uint8_t* gsmem = smem + L::kGroup0 + wg * L::kGroup;

  // the key tiles that rows [q0, q_last] can see; warpgroup wg takes every
  // WG-th from the wg-th
  const int q_last = min(q0 + kRowTile, Sq) - 1;
  int kt0, nk;
  if constexpr (kPos) {  // bounds: {least, greatest row position, first,
                         // last key one of them may see}
    int* bounds = reinterpret_cast<int*>(smem + L::kPosAt);
    if (threadIdx.x == 0) {
      bounds[0] = bounds[2] = INT_MAX;
      bounds[1] = bounds[3] = INT_MIN;
    }
    __syncthreads();
    const int i = q0 + static_cast<int>(threadIdx.x);
    const bool mine = i <= q_last && threadIdx.x < kRowTile;
    block_min(bounds, mine ? q_pos[i] : INT_MAX);
    block_max(bounds + 1, mine ? q_pos[i] : INT_MIN);
    __syncthreads();
    const int qp_min = bounds[0], qp_max = bounds[1];
    int first, last;
    const bool any = index_range<WG * kWGThreads>(
        kv_pos, Skv,
        [=](int kp) {
          return kp >= 0 && (!causal || kp <= qp_max) &&
                 (window <= 0 || kp > qp_min - window);
        },
        bounds, first, last);
    kt0 = any ? first / KT : 0;
    nk = any ? last / KT + 1 - kt0 : 0;
  } else {
    const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
    const int k_end = causal ? min(Skv, q_last + 1) : Skv;
    kt0 = k_begin / KT;
    nk = k_end > k_begin ? (k_end + KT - 1) / KT - kt0 : 0;
  }
  const int steps = nk > wg ? (nk - wg + WG - 1) / WG : 0;

  const int64_t kv_batch = static_cast<int64_t>(b) * Skv;
  auto issue = [&](int i) {  // the i-th step's raw K and V, by cp.async
    const int key0 = (kt0 + wg + i * WG) * KT;
    copy_rows<KT, DH>(k, kv_batch, key0, Skv, KH, kh, gbase + L::kRawK, tid);
    copy_rows<KT, DH>(v, kv_batch, key0, Skv, KH, kh, gbase + L::kRawV, tid);
    cp_async_commit();
  };
  if (steps > 0) issue(0);

  // Q and dO: this block's rows, split, K-major, by every thread; zeros
  // past Sq
  const int64_t q_batch = static_cast<int64_t>(b) * Sq;
  load_kmajor<kRowTile, DH, WG * kWGThreads>(
      q, q_batch, q0, Sq, H, h, smem + L::kQ, L::kQh, threadIdx.x);
  load_kmajor<kRowTile, DH, WG * kWGThreads>(
      dout, q_batch, q0, Sq, H, h, smem + L::kO, L::kQh, threadIdx.x);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // this thread's two query rows of the accumulators, and their stats
  const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int rowA = q0 + warp * 16 + lane / 4, rowB = rowA + 8;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * Sq;
  const float lseA = rowA < Sq ? lse[bh + rowA] : 0.f;
  const float lseB = rowB < Sq ? lse[bh + rowB] : 0.f;
  const float dA = rowA < Sq ? D[bh + rowA] : 0.f;
  const float dB = rowB < Sq ? D[bh + rowB] : 0.f;
  int qpA = 0, qpB = 0;  // their explicit positions
  if constexpr (kPos) {
    qpA = rowA < Sq ? q_pos[rowA] : 0;
    qpB = rowB < Sq ? q_pos[rowB] : 0;
  }
  float dq_acc[DH / 2];
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) dq_acc[x] = 0.f;

  for (int i = 0; i < steps; ++i) {
    cp_async_wait_all();
    group_sync(wg);  // step i's raw K, V are in; step i-1's products done
    const float* rk = reinterpret_cast<const float*>(gsmem + L::kRawK);
    const float* rv = reinterpret_cast<const float*>(gsmem + L::kRawV);
    to_kmajor<KT, DH>(rk, gsmem + L::kK, L::kKh, tid);
    to_transposed<KT, DH>(rk, gsmem + L::kKt, L::kKh, tid);
    to_kmajor<KT, DH>(rv, gsmem + L::kV, L::kKh, tid);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    group_sync(wg);  // the raw buffers are free
    if (i + 1 < steps) issue(i + 1);
    const int key0 = (kt0 + wg + i * WG) * KT;

    // S = Q.K^T and dP = dO.V^T (64 rows x KT keys), two groups: P is
    // formed while dP is still on the tensor cores
    float sc[KT / 2], dp[KT / 2];
#pragma unroll
    for (int x = 0; x < KT / 2; ++x) sc[x] = dp[x] = 0.f;
    wgmma_fence();
    product_ss<KT, DH>(sc, base + L::kQ, L::kQh, gbase + L::kK, L::kKh);
    wgmma_commit();
    product_ss<KT, DH>(dp, base + L::kO, L::kQh, gbase + L::kV, L::kKh);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P, then dS, on the fragments: sc[4j + e] is (rowA, key key0 + 8j +
    // 2t4 + e) and sc[4j + 2 + e] is (rowB, the same key)
    const bool all = !kPos && all_visible(q0, q0 + kRowTile - 1, key0,
                                          key0 + KT - 1, Sq, Skv, causal,
                                          window);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * t4 + e;
        int kp = -1;
        if constexpr (kPos) kp = key < Skv ? kv_pos[key] : -1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r + e;
          bool in;
          if constexpr (kPos)
            in = (r ? rowB : rowA) < Sq &&
                 sees(r ? qpB : qpA, kp, causal, window);
          else
            in = all ||
                 visible(r ? rowB : rowA, key, Sq, Skv, causal, window);
          sc[x] = in ? expf(sc[x] * scale - (r ? lseB : lseA)) : 0.f;
        }
      }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t ab[KT / 2], as[KT / 2];
#pragma unroll
    for (int x = 0; x < KT / 2; ++x) {
      const float g = sc[x] * (dp[x] - ((x & 2) ? dB : dA));
      ab[x] = tf32_int(g);
      as[x] = tf32_int(g - __uint_as_float(ab[x]));
    }
    // dQ += dS.K (scaled at the end)
    product_rs<KT, DH>(dq_acc, ab, as, gbase + L::kKt,
                       gbase + L::kKt + L::kKh);
  }

  if constexpr (WG > 1) {  // the second group's sums join the first's
    float* buf = reinterpret_cast<float*>(smem + L::kGroup0 + L::kGroup);
    if (wg == 1) park(dq_acc, buf, tid);
    __syncthreads();
    if (wg == 1) return;
    gather(dq_acc, buf, tid);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rowB : rowA;
    if (row >= Sq) continue;
    float* dst = dq + ((q_batch + row) * H + h) * DH + 2 * t4;
#pragma unroll
    for (int x = 0; x < DH / 8; ++x) {
      const int a = 4 * x + 2 * r;
      store2(dst + 8 * x, dq_acc[a] * scale, dq_acc[a + 1] * scale);
    }
  }
}

// ---- (b') and (c'): Dh 192

// cp.async of 64 rows row0.. of head `head` of a (.., rows, heads, 192)
// tensor into a raw tile of rows padded to kWideRow floats, by T threads
// (thread tid of them), in 16-byte chunks; rows past `rows` are zero-filled
template <int T>
__device__ __forceinline__ void copy_padded(const float* src,
                                            int64_t batch_off, int row0,
                                            int rows, int heads, int head,
                                            uint32_t dst, int tid) {
  constexpr int kVec = kWideDH / 4;
  constexpr int kPasses = 64 * kVec / T;
  static_assert(64 * kVec % T == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < kPasses; ++it) {
    const int u = it * T + tid;
    const int r = u / kVec, c = (u % kVec) * 4;
    const bool ok = row0 + r < rows;
    const float* p =
        ok ? src + ((batch_off + row0 + r) * heads + head) *
                       static_cast<int64_t>(kWideDH) + c
           : src;
    cp_async16(dst + (r * kWideRow + c) * 4, p, ok ? 16 : 0);
  }
}

// This thread's A fragment of k-step kk of a raw padded operand (`a` at
// its row ra, column t4: element (ra, 8kk + t4), (ra + 8, ..), (ra, 8kk +
// t4 + 4), (ra + 8, ..), a wgmma A fragment's order), split into big and
// small TF32 parts
__device__ __forceinline__ void wide_fragment(const float* a, int kk,
                                              uint32_t* big,
                                              uint32_t* small) {
  const float x[4] = {a[8 * kk], a[8 * kWideRow + 8 * kk],
                      a[8 * kk + 4], a[8 * kWideRow + 8 * kk + 4]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    big[e] = tf32_int(x[e]);
    small[e] = tf32_int(x[e] - __uint_as_float(big[e]));
  }
}

// s (64 x 16) += A . B^T over the 192-wide head dim: A the block's raw
// padded operand (this thread's fragment row at a), split in registers as
// it is loaded; B a step's 16 rows split K-major (big half at b, small
// half `bh` bytes on). In parts of kWidePart columns, each summed in fresh
// registers, small terms first; two parts in flight: part p + 1's
// fragments are loaded and its products issued before part p is waited
// for.
__device__ __forceinline__ void wide_score(float (&s)[8], const float* a,
                                           uint32_t b, uint32_t bh) {
  constexpr int kSteps = kWidePart / 8, kParts = kWideDH / kWidePart;
  constexpr int kRowBytes = 16 * 32;
  uint32_t ab[2][4 * kSteps], as[2][4 * kSteps];
  float t[2][8];
  const auto issue = [&](int p) {  // part p into t[p & 1]
    uint32_t(&fb)[4 * kSteps] = ab[p & 1];
    uint32_t(&fs)[4 * kSteps] = as[p & 1];
    float(&d)[8] = t[p & 1];
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      wide_fragment(a, p * kSteps + j, fb + 4 * j, fs + 4 * j);
#pragma unroll
    for (int x = 0; x < 8; ++x) d[x] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      wgmma_rs<16>(d, fs[4 * j], fs[4 * j + 1], fs[4 * j + 2], fs[4 * j + 3],
                   desc(b + (p * kSteps + j) * kRowBytes));
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      wgmma_rs<16>(d, fb[4 * j], fb[4 * j + 1], fb[4 * j + 2], fb[4 * j + 3],
                   desc(b + bh + (p * kSteps + j) * kRowBytes));
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      wgmma_rs<16>(d, fb[4 * j], fb[4 * j + 1], fb[4 * j + 2], fb[4 * j + 3],
                   desc(b + (p * kSteps + j) * kRowBytes));
    wgmma_commit();
  };
  const auto add = [&](int p) {
    fence_regs(t[p & 1]);
#pragma unroll
    for (int x = 0; x < 8; ++x) s[x] += t[p & 1][x];
  };
  issue(0);
#pragma unroll
  for (int p = 1; p < kParts; ++p) {
    issue(p);
    wgmma_wait<1>();  // part p - 1
    add(p - 1);
  }
  wgmma_wait<0>();
  add(kParts - 1);
}

// acc (64 x COLS) += A . B over a step's 16 positions (2 k-steps): A from
// registers (big parts ab, small parts as, each the accumulator fragment
// of a 64 x 16 product, so positions t, t+4 of k-step j are its columns
// 8j + 2t, 8j + 2t + 1), B the step's transposed split tile (192 rows a
// k-step) from its row at `bb` (small half at `bs`). N output columns a
// product, each summed in fresh registers and then added in one fp32 add,
// small terms first; two in flight.
template <int COLS, int N>
__device__ __forceinline__ void wide_product(float (&acc)[COLS / 2],
                                             const uint32_t (&ab)[8],
                                             const uint32_t (&as)[8],
                                             uint32_t bb, uint32_t bs) {
  constexpr int kChunks = COLS / N;
  static_assert(COLS % N == 0, "whole wgmma products");
  float t[2][N / 2];
  const auto issue = [&](int c) {  // columns [cN, cN + N) into t[c & 1]
    float(&d)[N / 2] = t[c & 1];
#pragma unroll
    for (int x = 0; x < N / 2; ++x) d[x] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wgmma_rs<N>(d, as[4 * j], as[4 * j + 2], as[4 * j + 1], as[4 * j + 3],
                  desc(bb + c * N * 32 + j * kWideDH * 32));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wgmma_rs<N>(d, ab[4 * j], ab[4 * j + 2], ab[4 * j + 1], ab[4 * j + 3],
                  desc(bs + c * N * 32 + j * kWideDH * 32));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wgmma_rs<N>(d, ab[4 * j], ab[4 * j + 2], ab[4 * j + 1], ab[4 * j + 3],
                  desc(bb + c * N * 32 + j * kWideDH * 32));
    wgmma_commit();
  };
  const auto add = [&](int c) {
    fence_regs(t[c & 1]);
#pragma unroll
    for (int x = 0; x < N / 2; ++x) acc[N / 2 * c + x] += t[c & 1][x];
  };
  issue(0);
#pragma unroll
  for (int c = 1; c < kChunks; ++c) {
    issue(c);
    wgmma_wait<1>();  // chunk c - 1
    add(c - 1);
  }
  wgmma_wait<0>();
  add(kChunks - 1);
}

// A step's 8 fragment values a thread (64 rows x 16 columns, fp32) handed
// between the warpgroups through shared memory, as two float4 a thread
__device__ __forceinline__ void hand_over(float4* x, int tid,
                                          const float (&v)[8]) {
  x[tid] = make_float4(v[0], v[1], v[2], v[3]);
  x[kWGThreads + tid] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void take_over(const float4* x, int tid,
                                          float (&v)[8]) {
  const float4 a = x[tid], b = x[kWGThreads + tid];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// big and small TF32 parts of a fragment
__device__ __forceinline__ void split8(const float (&v)[8], uint32_t (&big)[8],
                                       uint32_t (&small)[8]) {
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    big[x] = tf32_int(v[x]);
    small[x] = tf32_int(v[x] - __uint_as_float(big[x]));
  }
}

template <bool kPos>
__global__ void __launch_bounds__(kWideThreads, 1)
attn_bwd_dkdv_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, float* __restrict__ dk,
                          float* __restrict__ dv,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ kv_pos, int B, int Sq,
                          int Skv, int H, int KH, int causal, int window,
                          int splits, int64_t split_stride, float scale) {
  using L = DkdvWideSmem<kPos>;
  constexpr int DH = kWideDH, QT = L::kQT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 127u) & ~127u;
  uint8_t* smem = smem_raw + (base - raw_base);

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
  const int wg = threadIdx.x / kWGThreads, tid = threadIdx.x % kWGThreads;

  // the (g, query tile) steps as (b); this block takes [s_lo, s_hi), both
  // warpgroups every one of them
  const int k_last = min(k0 + kKeyTile, Skv) - 1;
  int qt0, nq;
  if constexpr (kPos) {
    int* bounds = reinterpret_cast<int*>(smem + L::kPosAt);
    if (threadIdx.x == 0) {
      bounds[0] = bounds[2] = INT_MAX;
      bounds[1] = bounds[3] = INT_MIN;
    }
    __syncthreads();
    const int j = k0 + static_cast<int>(threadIdx.x);
    const int kp = j <= k_last && threadIdx.x < kKeyTile ? kv_pos[j] : -1;
    block_min(bounds, kp >= 0 ? kp : INT_MAX);
    block_max(bounds + 1, kp);
    __syncthreads();
    const int kp_min = bounds[0], kp_max = bounds[1];
    int first, last;
    const bool any =
        kp_min <= kp_max &&
        index_range<kWideThreads>(
            q_pos, Sq,
            [=](int qp) {
              return (!causal || kp_min <= qp) &&
                     (window <= 0 || kp_max > qp - window);
            },
            bounds, first, last);
    qt0 = any ? first / QT : 0;
    nq = any ? last / QT + 1 - qt0 : 0;
  } else {
    const int q_begin = causal ? k0 : 0;
    const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
    qt0 = q_begin / QT;
    nq = q_end > q_begin ? (q_end + QT - 1) / QT - qt0 : 0;
  }
  const int64_t n = static_cast<int64_t>(G) * nq;
  const int s_lo = static_cast<int>(n * c / splits);
  const int steps = static_cast<int>(n * (c + 1) / splits) - s_lo;

  const int64_t q_batch = static_cast<int64_t>(b) * Sq;
  // the i-th step's raw Q and lse (warpgroup 0) or dO and D (1)
  auto issue = [&](int i) {
    const int s = s_lo + i;
    const int h = kh * G + s / nq, q0 = (qt0 + s % nq) * QT;
    copy_rows<QT, DH>(wg ? dout : q, q_batch, q0, Sq, H, h,
                      base + (wg ? L::kRawO : L::kRawQ), tid);
    if (tid < QT) {
      const uint32_t st =
          base + L::kStats + ((i & 1) * 2 + wg) * QT * 4 + tid * 4;
      const bool ok = q0 + tid < Sq;
      const int64_t off =
          ok ? (static_cast<int64_t>(b) * H + h) * Sq + q0 + tid : 0;
      cp_async4(st, (wg ? D : lse) + off, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  if (steps > 0) issue(0);

  // K (warpgroup 0) or V (1): this block's keys, raw, rows padded; zeros
  // past Skv
  const int64_t kv_batch = static_cast<int64_t>(b) * Skv;
  copy_padded<kWGThreads>(wg ? v : k, kv_batch, k0, Skv, KH, kh,
                          base + (wg ? L::kV : L::kK), tid);
  cp_async_commit();

  // this thread's two key rows of the accumulators and its fragment row
  // of K (or V)
  const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int ra = warp * 16 + lane / 4;
  const int keyA = k0 + ra, keyB = keyA + 8;
  int kpA = -1, kpB = -1;
  if constexpr (kPos) {
    kpA = keyA < Skv ? kv_pos[keyA] : -1;
    kpB = keyB < Skv ? kv_pos[keyB] : -1;
  }
  const float* fa = reinterpret_cast<const float*>(
                        smem + (wg ? L::kV : L::kK)) + ra * kWideRow + t4;
  // the group's tiles: the score product's B (Q or dO, K-major) and the
  // column product's (Q^T or dO^T); and the hand-over slots
  const uint32_t tile = base + (wg ? L::kO : L::kQ);
  const uint32_t tile_t = base + (wg ? L::kOt : L::kQt);
  float4* slots = reinterpret_cast<float4*>(smem + L::kX);
  float acc[DH / 2];  // dK (warpgroup 0) or dV (1)
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) acc[x] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int s = s_lo + i;
    cp_async_wait_all();
    group_sync(wg);  // step i's raw tile (and K or V) is in; the group's
                     // step i-1 products are done
    const float* raw =
        reinterpret_cast<const float*>(smem + (wg ? L::kRawO : L::kRawQ));
    to_kmajor<QT, DH>(raw, smem + (wg ? L::kO : L::kQ), L::kTh, tid);
    to_transposed<QT, DH>(raw, smem + (wg ? L::kOt : L::kQt), L::kTh, tid);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    group_sync(wg);  // the split tiles are in; the raw buffer is free
    if (i + 1 < steps) issue(i + 1);
    const int q0 = (qt0 + s % nq) * QT;
    // the step's lse (warpgroup 0) or D (1)
    const float* stat = reinterpret_cast<const float*>(
        smem + L::kStats + ((i & 1) * 2 + wg) * QT * 4);

    // S^T = K.Q^T (warpgroup 0) or dP^T = V.dO^T (1), 64 keys x 16 queries
    float sc[QT / 2];
#pragma unroll
    for (int x = 0; x < QT / 2; ++x) sc[x] = 0.f;
    wide_score(sc, fa, tile, L::kTh);

    uint32_t ab[QT / 2], as[QT / 2];
    if (wg == 0) {
      // P^T on the fragments (sc[4j + e] is (keyA, query q0 + 8j + 2t4 +
      // e), sc[4j + 2 + e] (keyB, the same query)), handed to warpgroup 1;
      // then its dS^T, split
      const bool all = !kPos && all_visible(q0, q0 + QT - 1, k0,
                                            k0 + kKeyTile - 1, Sq, Skv,
                                            causal, window);
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t4 + e, qi = q0 + col;
          const float l = stat[col];
          int qp = 0;
          if constexpr (kPos) qp = qi < Sq ? q_pos[qi] : 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 4 * j + 2 * r + e;
            bool in;
            if constexpr (kPos)
              in = qi < Sq && sees(qp, r ? kpB : kpA, causal, window);
            else
              in = all ||
                   visible(qi, r ? keyB : keyA, Sq, Skv, causal, window);
            sc[x] = in ? expf(sc[x] * scale - l) : 0.f;
          }
        }
      hand_over(slots, tid, sc);
      named_arrive<kWideThreads>(kBarP);
      named_sync<kWideThreads>(kBarDS);
      float g[QT / 2];
      take_over(slots, tid, g);
      split8(g, ab, as);
    } else {
      // P^T from warpgroup 0, split (the A operand of dV); dS^T = P^T
      // (dP^T - D), with P as its two parts (within 2^-22 of it), handed
      // back
      named_sync<kWideThreads>(kBarP);
      float p[QT / 2];
      take_over(slots, tid, p);
      split8(p, ab, as);
#pragma unroll
      for (int x = 0; x < QT / 2; ++x)
        p[x] = (__uint_as_float(ab[x]) + __uint_as_float(as[x])) *
               (sc[x] - stat[8 * (x / 4) + 2 * t4 + (x & 1)]);
      hand_over(slots, tid, p);
      named_arrive<kWideThreads>(kBarDS);
    }
    // dK += dS^T.Q (warpgroup 0; scaled at the end) or dV += P^T.dO (1)
    wide_product<DH, 64>(acc, ab, as, tile_t, tile_t + L::kTh);
  }
  cp_async_wait_all();

  // dK (warpgroup 0) or dV (1), or this split's partials: rows past Skv
  // are not written
  float* out = (wg ? dv : dk) + c * split_stride;
  const float mul = wg ? 1.f : scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? keyB : keyA;
    if (key >= Skv) continue;
    const int64_t off = ((kv_batch + key) * KH + kh) * DH + 2 * t4;
#pragma unroll
    for (int x = 0; x < DH / 8; ++x) {  // columns 8x + 2t4, +1
      const int a = 4 * x + 2 * r;
      store2(out + off + 8 * x, acc[a] * mul, acc[a + 1] * mul);
    }
  }
}

template <bool kPos>
__global__ void __launch_bounds__(kWideThreads, 1)
attn_bwd_dq_wide_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, float* __restrict__ dq,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ kv_pos, int B, int Sq,
                        int Skv, int H, int KH, int causal, int window,
                        float scale) {
  using L = DqWideSmem<kPos>;
  constexpr int DH = kWideDH, KT = L::kKT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 127u) & ~127u;
  uint8_t* smem = smem_raw + (base - raw_base);

  // block -> (query tile, batch, head) as (c), the query tile slowest:
  // the last rows (the most keys under the causal mask) of every head first
  const int n_qt = (Sq + kRowTile - 1) / kRowTile;
  const int b = (blockIdx.x % (B * H)) / H, h = blockIdx.x % H;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / (B * H))) *
                 kRowTile;
  const int kh = h / (H / KH);
  const int wg = threadIdx.x / kWGThreads, tid = threadIdx.x % kWGThreads;

  // the key tiles that rows [q0, q_last] can see, both warpgroups every one
  const int q_last = min(q0 + kRowTile, Sq) - 1;
  int kt0, nk;
  if constexpr (kPos) {
    int* bounds = reinterpret_cast<int*>(smem + L::kPosAt);
    if (threadIdx.x == 0) {
      bounds[0] = bounds[2] = INT_MAX;
      bounds[1] = bounds[3] = INT_MIN;
    }
    __syncthreads();
    const int i = q0 + static_cast<int>(threadIdx.x);
    const bool mine = i <= q_last && threadIdx.x < kRowTile;
    block_min(bounds, mine ? q_pos[i] : INT_MAX);
    block_max(bounds + 1, mine ? q_pos[i] : INT_MIN);
    __syncthreads();
    const int qp_min = bounds[0], qp_max = bounds[1];
    int first, last;
    const bool any = index_range<kWideThreads>(
        kv_pos, Skv,
        [=](int kp) {
          return kp >= 0 && (!causal || kp <= qp_max) &&
                 (window <= 0 || kp > qp_min - window);
        },
        bounds, first, last);
    kt0 = any ? first / KT : 0;
    nk = any ? last / KT + 1 - kt0 : 0;
  } else {
    const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
    const int k_end = causal ? min(Skv, q_last + 1) : Skv;
    kt0 = k_begin / KT;
    nk = k_end > k_begin ? (k_end + KT - 1) / KT - kt0 : 0;
  }

  const int64_t kv_batch = static_cast<int64_t>(b) * Skv;
  auto issue = [&](int i) {  // the i-th step's raw K (group 0) or V (1)
    const int key0 = (kt0 + i) * KT;
    copy_rows<KT, DH>(wg ? v : k, kv_batch, key0, Skv, KH, kh,
                      base + (wg ? L::kRawV : L::kRawK), tid);
    cp_async_commit();
  };
  if (nk > 0) issue(0);

  // Q (warpgroup 0) or dO (1): this block's rows, raw, rows padded; zeros
  // past Sq
  const int64_t q_batch = static_cast<int64_t>(b) * Sq;
  copy_padded<kWGThreads>(wg ? dout : q, q_batch, q0, Sq, H, h,
                          base + (wg ? L::kO : L::kQ), tid);
  cp_async_commit();

  // this thread's two query rows of the accumulators, their lse (group 0)
  // or D (1), and its fragment row of Q (or dO)
  const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int ra = warp * 16 + lane / 4;
  const int rowA = q0 + ra, rowB = rowA + 8;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * Sq;
  const float* stat = wg ? D : lse;
  const float statA = rowA < Sq ? stat[bh + rowA] : 0.f;
  const float statB = rowB < Sq ? stat[bh + rowB] : 0.f;
  int qpA = 0, qpB = 0;
  if constexpr (kPos) {
    qpA = rowA < Sq ? q_pos[rowA] : 0;
    qpB = rowB < Sq ? q_pos[rowB] : 0;
  }
  const float* fa = reinterpret_cast<const float*>(
                        smem + (wg ? L::kO : L::kQ)) + ra * kWideRow + t4;
  const uint32_t tile = base + (wg ? L::kV : L::kK);
  const uint32_t half = wg * kWideHalf * 32;
  float4* slots = reinterpret_cast<float4*>(smem + L::kX);
  float dq_acc[kWideHalf / 2];
#pragma unroll
  for (int x = 0; x < kWideHalf / 2; ++x) dq_acc[x] = 0.f;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait_all();
    group_sync(wg);  // step i's raw K or V (and Q or dO) is in; the
                     // group's step i-1 products are done
    if (wg == 0) {
      // K^T is read by both groups: warpgroup 1 must be done with the
      // last step's
      if (i > 0) named_sync<kWideThreads>(kBarKt);
      const float* rk = reinterpret_cast<const float*>(smem + L::kRawK);
      to_kmajor<KT, DH>(rk, smem + L::kK, L::kTh, tid);
      to_transposed<KT, DH>(rk, smem + L::kKt, L::kTh, tid);
    } else {
      const float* rv = reinterpret_cast<const float*>(smem + L::kRawV);
      to_kmajor<KT, DH>(rv, smem + L::kV, L::kTh, tid);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    group_sync(wg);  // the split tiles are in; the raw buffer is free
    if (i + 1 < nk) issue(i + 1);
    const int key0 = (kt0 + i) * KT;

    // S = Q.K^T (warpgroup 0) or dP = dO.V^T (1), 64 rows x 16 keys
    float sc[KT / 2];
#pragma unroll
    for (int x = 0; x < KT / 2; ++x) sc[x] = 0.f;
    wide_score(sc, fa, tile, L::kTh);

    float g[KT / 2];
    if (wg == 0) {
      // P on the fragments (sc[4j + e] is (rowA, key key0 + 8j + 2t4 + e),
      // sc[4j + 2 + e] (rowB, the same key)), handed to warpgroup 1; then
      // its dS
      const bool all = !kPos && all_visible(q0, q0 + kRowTile - 1, key0,
                                            key0 + KT - 1, Sq, Skv, causal,
                                            window);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * j + 2 * t4 + e;
          int kp = -1;
          if constexpr (kPos) kp = key < Skv ? kv_pos[key] : -1;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 4 * j + 2 * r + e;
            bool in;
            if constexpr (kPos)
              in = (r ? rowB : rowA) < Sq &&
                   sees(r ? qpB : qpA, kp, causal, window);
            else
              in = all ||
                   visible(r ? rowB : rowA, key, Sq, Skv, causal, window);
            sc[x] = in ? expf(sc[x] * scale - (r ? statB : statA)) : 0.f;
          }
        }
      hand_over(slots, tid, sc);
      named_arrive<kWideThreads>(kBarP);
      named_sync<kWideThreads>(kBarDS);
      take_over(slots, tid, g);
    } else {
      // dS = P (dP - D) from warpgroup 0's P, handed back
      named_sync<kWideThreads>(kBarP);
      take_over(slots, tid, g);
#pragma unroll
      for (int x = 0; x < KT / 2; ++x)
        g[x] *= sc[x] - ((x & 2) ? statB : statA);
      hand_over(slots, tid, g);
      named_arrive<kWideThreads>(kBarDS);
    }
    uint32_t ab[KT / 2], as[KT / 2];
    split8(g, ab, as);
    // this warpgroup's half: dQ += dS.K (scaled at the end)
    wide_product<kWideHalf, 48>(dq_acc, ab, as, base + L::kKt + half,
                                base + L::kKt + L::kTh + half);
    if (wg == 1 && i + 1 < nk) named_arrive<kWideThreads>(kBarKt);
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rowB : rowA;
    if (row >= Sq) continue;
    float* dst =
        dq + ((q_batch + row) * H + h) * DH + wg * kWideHalf + 2 * t4;
#pragma unroll
    for (int x = 0; x < kWideHalf / 8; ++x) {
      const int a = 4 * x + 2 * r;
      store2(dst + 8 * x, dq_acc[a] * scale, dq_acc[a + 1] * scale);
    }
  }
}

template <typename Kernel>
int configure(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;  // the attribute holds per function
  return 0;
}

template <int DH, bool kPos>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* D, void* dk, void* dv,
                const int* q_pos, const int* kv_pos, int B, int Sq, int Skv,
                int H, int KH, int causal, int window, int splits, float scale,
                cudaStream_t st) {
  static bool done = false;
  constexpr bool wide = DH == kWideDH;  // (b') at Dh 192, else (b)
  const auto kernel = [] {
    if constexpr (DH == kWideDH) return attn_bwd_dkdv_wide_kernel<kPos>;
    else return attn_bwd_dkdv_kernel<DH, kPos>;
  }();
  int bytes, threads;
  if constexpr (wide) {
    bytes = DkdvWideSmem<kPos>::kBytes;
    threads = kWideThreads;
  } else {
    bytes = DkdvSmem<DH, kPos>::kBytes;
    threads = Cfg<DH>::kWG * kWGThreads;
  }
  const int rc = configure(kernel, bytes, done);
  if (rc != 0) return rc;
  const int64_t blocks =
      static_cast<int64_t>((Skv + kKeyTile - 1) / kKeyTile) * B * KH * splits;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t stride =
      splits > 1 ? static_cast<int64_t>(B) * Skv * KH * DH : 0;
  const auto e = [](const void* p) { return static_cast<const float*>(p); };
  kernel<<<static_cast<unsigned>(blocks), threads, bytes, st>>>(
      e(q), e(k), e(v), e(dout), lse, D, static_cast<float*>(dk),
      static_cast<float*>(dv), q_pos, kv_pos, B, Sq, Skv, H, KH, causal,
      window, splits, stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool kPos>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* D, void* dq, const int* q_pos,
              const int* kv_pos, int B, int Sq, int Skv, int H, int KH,
              int causal, int window, float scale, cudaStream_t st) {
  static bool done = false;
  constexpr bool wide = DH == kWideDH;  // (c') at Dh 192, else (c)
  const auto kernel = [] {
    if constexpr (DH == kWideDH) return attn_bwd_dq_wide_kernel<kPos>;
    else return attn_bwd_dq_kernel<DH, kPos>;
  }();
  int bytes, threads;
  if constexpr (wide) {
    bytes = DqWideSmem<kPos>::kBytes;
    threads = kWideThreads;
  } else {
    bytes = DqSmem<DH, kPos>::kBytes;
    threads = Cfg<DH>::kWG * kWGThreads;
  }
  const int rc = configure(kernel, bytes, done);
  if (rc != 0) return rc;
  const int64_t blocks =
      static_cast<int64_t>((Sq + kRowTile - 1) / kRowTile) * B * H;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto e = [](const void* p) { return static_cast<const float*>(p); };
  kernel<<<static_cast<unsigned>(blocks), threads, bytes, st>>>(
      e(q), e(k), e(v), e(dout), lse, D, static_cast<float*>(dq), q_pos,
      kv_pos,
      B, Sq, Skv, H, KH, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// (b) at one head size: the position instantiation when q_pos is set
template <int DH>
int dkdv_at(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* D, void* dk, void* dv,
            const int* q_pos, const int* kv_pos, int B, int Sq, int Skv,
            int H, int KH, int causal, int window, int splits, float scale,
            cudaStream_t st) {
  if (q_pos != nullptr)
    return launch_dkdv<DH, true>(q, k, v, dout, lse, D, dk, dv, q_pos,
                                 kv_pos, B, Sq, Skv, H, KH, causal, window,
                                 splits, scale, st);
  return launch_dkdv<DH, false>(q, k, v, dout, lse, D, dk, dv, q_pos, kv_pos,
                                B, Sq, Skv, H, KH, causal, window, splits,
                                scale, st);
}

// (c) at one head size: the position instantiation when q_pos is set
template <int DH>
int dq_at(const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* D, void* dq, const int* q_pos,
          const int* kv_pos, int B, int Sq, int Skv, int H, int KH,
          int causal, int window, float scale, cudaStream_t st) {
  if (q_pos != nullptr)
    return launch_dq<DH, true>(q, k, v, dout, lse, D, dq, q_pos, kv_pos, B,
                               Sq, Skv, H, KH, causal, window, scale, st);
  return launch_dq<DH, false>(q, k, v, dout, lse, D, dq, q_pos, kv_pos, B,
                              Sq, Skv, H, KH, causal, window, scale, st);
}

// Calls f(std::integral_constant<int, Dh>) at a head size the kernels
// take, else returns cudaErrorInvalidValue
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

float scale_of(int Dh) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape the kernels do not take
// (Dh other than 48, 64, 96, 112, 128 or 192, H % KH != 0, more than
// 2^31 - 1 blocks). Layouts as at
// the top, every tensor fp32 and contiguous and, for q, k, v and dO,
// 16-byte aligned (cp.async). Call (a), then (b), then (r) when splits >
// 1, and (c); (b) and (c) read D.

// The tiles, for the wrapper to check its copy of the schedule against:
// (b)'s keys and query tile, (c)'s rows and key tile, and the warpgroups
// that share out a block's steps, at head size Dh ((b') and (c') at 192: 1,
// its two warpgroups taking every step, each half the head dim).
extern "C" int attn_bwd_tiles(int Dh, int* key_tile, int* query_tile,
                              int* rows, int* key_step, int* groups) {
  return at_head_dim(Dh, [&](auto dh) {
    using C = Cfg<decltype(dh)::value>;
    *key_tile = kKeyTile;
    *rows = kRowTile;
    *groups = C::kWG;
    *query_tile = C::kQ;
    *key_step = C::kK;
    return 0;
  });
}

// 1 if the library holds the position instantiations at head size Dh (at
// every head size it takes), else 0
extern "C" int attn_bwd_positions_built(int Dh) {
  int built = 0;
  at_head_dim(Dh, [&](auto) {
    built = 1;
    return 0;
  });
  return built;
}

// (a) D (B, H, Sq) from dO and o (B, Sq, H, Dh)
extern "C" int attn_bwd_dot_launch(const void* dout, const void* out,
                                   void* D, int B, int Sq, int H, int Dh,
                                   void* stream) {
  if (!shape_ok(B, Sq, 1, H, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return at_head_dim(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    const int64_t lanes =
        static_cast<int64_t>(B) * Sq * H * DotLanes<DH>::value;
    const int64_t blocks = (lanes + kDotThreads - 1) / kDotThreads;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    attn_bwd_dot_kernel<DH><<<static_cast<unsigned>(blocks), kDotThreads, 0,
                              st>>>(static_cast<const float*>(dout),
                                    static_cast<const float*>(out),
                                    static_cast<float*>(D), B, Sq, H);
    return static_cast<int>(cudaGetLastError());
  });
}

// (b) dk, dv (B, Skv, KH, Dh) with splits = 1; with splits > 1 dk and dv
// are (splits, B, Skv, KH, Dh) fp32 partials for (r). q_pos, kv_pos: both
// null (mask by index) or (Sq,) and (Skv,) int32 (mask by them).
extern "C" int attn_bwd_dkdv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* D, void* dk,
                                    void* dv, const void* q_pos,
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
    return dkdv_at<DH>(q, k, v, dout, f(lse), f(D), dk, dv, i(q_pos),
                       i(kv_pos), B, Sq, Skv, H, KH, causal, window, splits,
                       scale_of(DH), st);
  });
}

// (r) dk, dv (n elements each, n % 4 == 0) from the partials part (2,
// splits, n): dK's, then dV's
extern "C" int attn_bwd_reduce_launch(const void* part, void* dk, void* dv,
                                      long long n, int splits,
                                      void* stream) {
  if (n < 4 || n % 4 != 0 || splits < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = n / 4;
  int64_t blocks = (2 * n4 + kDotThreads - 1) / kDotThreads;
  if (blocks > 8192) blocks = 8192;  // grid-stride past that
  attn_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), kDotThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(part), static_cast<float*>(dk),
      static_cast<float*>(dv), n4, splits);
  return static_cast<int>(cudaGetLastError());
}

// (c) dq (B, Sq, H, Dh); q_pos, kv_pos as for (b)
extern "C" int attn_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* D, void* dq, const void* q_pos,
                                  const void* kv_pos, int B, int Sq, int Skv,
                                  int H, int KH, int Dh, int causal,
                                  int window, void* stream) {
  if (!shape_ok(B, Sq, Skv, H, KH) ||
      (q_pos == nullptr) != (kv_pos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto i = [](const void* p) { return static_cast<const int*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return at_head_dim(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    return dq_at<DH>(q, k, v, dout, f(lse), f(D), dq, i(q_pos), i(kv_pos), B,
                     Sq, Skv, H, KH, causal, window, scale_of(DH), st);
  });
}
