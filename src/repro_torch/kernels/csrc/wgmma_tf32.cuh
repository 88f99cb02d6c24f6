// Split-TF32 tensor-core building blocks for Hopper (sm_90a), shared by
// K3's forward (flash_attention.cu) and its backward
// (flash_attention_bwd.cu): the canonical no-swizzle operand layout and
// its descriptor, the big/small TF32 split, wgmma.mma_async ... .tf32 with
// operands from shared memory or registers, mbarriers and TMA loads,
// Ampere-style async copies, vector loads and stores, K3's mask predicates
// and block-wide reductions, and the host's cuTensorMapEncodeTiled. The
// bf16 kernels (wgmma_bf16.cuh) share all but the split-TF32 parts.
//
// Split TF32: each fp32 operand x is split into big = cvt.rna.tf32(x) and
// small = cvt.rna.tf32(x - big), both exact in TF32, and a product is
// small.big + big.small + big.big, the two small terms accumulated first
// (about fp32's accuracy). The tensor core truncates as it accumulates, so
// a caller sums each tile's product in fresh registers and adds it to its
// running sum in one fp32 add.
//
// TF32 wgmma takes only K-major operands from shared memory (the
// contraction index contiguous), so an operand needed along its other axis
// is written transposed by the caller.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// Byte offset of element (r, c) of an R-row operand whose contraction
// index c is contiguous (K-major), in wgmma's canonical no-swizzle layout:
// core matrices of 8 rows x 4 tf32 (16 B a row, 128 B in all); the two core
// matrices of one k-step of 8 lie 128 B apart (the descriptor's leading
// byte offset), 8-row groups 256 B apart (its stride byte offset), and
// k-steps R*32 B apart.
__device__ __forceinline__ uint32_t kmajor(int r, int c, int R) {
  return (c >> 3) * (R * 32) + (r >> 3) * 256 + ((c >> 2) & 1) * 128 +
         (r & 7) * 16 + (c & 3) * 4;
}

__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to about fp32's precision, both exact in TF32
__device__ __forceinline__ void split(float x, float& big, float& small) {
  big = __uint_as_float(tf32(x));
  small = __uint_as_float(tf32(x - big));
}
__device__ __forceinline__ void split4(const float4& x, float4& hi,
                                       float4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// The same rounding as tf32() for finite x (to nearest, ties away from
// zero, on the magnitude) in two integer operations instead of a
// conversion: half a TF32 unit is added to the bits and the 13 bits TF32
// drops are cleared. The backward, whose steps split every tile they
// read, uses it; the forward keeps cvt.rna, so its output keeps its bits.
__device__ __forceinline__ uint32_t tf32_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_int(float x, float& big, float& small) {
  big = __uint_as_float(tf32_int(x));
  small = __uint_as_float(tf32_int(x - big));
}
__device__ __forceinline__ void split4_int(const float4& x, float4& hi,
                                           float4& lo) {
  split_int(x.x, hi.x, lo.x);
  split_int(x.y, hi.y, lo.y);
  split_int(x.z, hi.z, lo.z);
  split_int(x.w, hi.w, lo.w);
}

// ---- vector loads and stores

// 4 consecutive elements (16 bytes, so aligned to that)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// 2 consecutive elements (8 bytes)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
// 4 consecutive elements (16 bytes)
__device__ __forceinline__ void store4(float* p, const float4& x) {
  *reinterpret_cast<float4*>(p) = x;
}

// ---- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---- async copies (cp.async): `bytes` of the `size` copied, the rest of
// the destination zero-filled (bytes = 0 reads nothing from src)

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ---- K3's masks and block-wide reductions

// whether a query at position qp sees a key at position kp
__device__ __forceinline__ bool sees(int qp, int kp, int causal,
                                     int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// whether query i sees key j by index (ragged Sq and Skv included)
__device__ __forceinline__ bool visible(int i, int j, int Sq, int Skv,
                                        int causal, int window) {
  return i < Sq && j < Skv && (!causal || j <= i) &&
         (window <= 0 || j > i - window);
}

// whether every (i, j) of queries [i_lo, i_hi] x keys [j_lo, j_hi] is
// unmasked, so that a step can skip the per-element test
__device__ __forceinline__ bool all_visible(int i_lo, int i_hi, int j_lo,
                                            int j_hi, int Sq, int Skv,
                                            int causal, int window) {
  return i_hi < Sq && j_hi < Skv && (!causal || j_hi <= i_lo) &&
         (window <= 0 || j_lo > i_hi - window);
}

// min (or max) of v over a warp, then into *dst over the block
__device__ __forceinline__ void block_min(int* dst, int v) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicMin(dst, v);
}
__device__ __forceinline__ void block_max(int* dst, int v) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicMax(dst, v);
}

// The tiles of kTile keys, [x, y), that the rows of query indices [q_lo,
// q_hi] may see by explicit positions: from the rows' least and greatest
// position and every key's (bounds: 4 ints of shared memory; all kThreads
// threads of the block call it)
template <int kTile, int kThreads>
__device__ __forceinline__ int2 position_tiles(int* bounds,
                                               const int* q_pos,
                                               const int* kv_pos, int q_lo,
                                               int q_hi, int Skv, int causal,
                                               int window) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    bounds[0] = bounds[2] = INT_MAX;
    bounds[1] = bounds[3] = INT_MIN;
  }
  __syncthreads();
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = q_lo + tid; i <= q_hi; i += kThreads) {
    lo = min(lo, q_pos[i]);
    hi = max(hi, q_pos[i]);
  }
  block_min(bounds, lo);
  block_max(bounds + 1, hi);
  __syncthreads();
  const int qmin = bounds[0], qmax = bounds[1];
  lo = INT_MAX;
  hi = INT_MIN;
  for (int j = tid; j < Skv; j += kThreads) {
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
  return make_int2(any ? bounds[2] / kTile : 0,
                   any ? bounds[3] / kTile + 1 : 0);
}

// barrier 1 over the consumer warpgroups only (the producer never joins)
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
}

// named barrier `id` (2 and up) of N threads: wait at it, or arrive and
// go on (one side of a hand-over between warpgroups)
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(N) : "memory");
}

// ---- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of accumulators above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 16) (+)= A . B^T, A and B read from shared memory by descriptor
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32) (+)= A . B^T, A and B read from shared memory by descriptor
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64) (+)= A . B^T, A and B read from shared memory by descriptor
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64) += A . B^T, A from registers (4 tf32 a thread), B read
// from shared memory by descriptor
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 48) += A . B^T, A from registers (4 tf32 a thread), B read
// from shared memory by descriptor: P.V's columns at head dims 48 and 96
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 56) += A . B^T, A from registers (4 tf32 a thread), B read
// from shared memory by descriptor: P.V's columns at head dim 112
__device__ __forceinline__ void wgmma_rs_n56(float (&d)[28], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 16) += A . B^T, A from registers (4 tf32 a thread), B read
// from shared memory by descriptor: the backward's S^T and S at head dim
// 192, whose block operand stays raw and is split in registers
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x N) += A . B^T, A from registers, N 16, 48, 56 or 64
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  static_assert(N == 16 || N == 48 || N == 56 || N == 64,
                "wgmma_rs takes N 16, 48, 56 or 64");
  if constexpr (N == 16) wgmma_rs_n16(d, a0, a1, a2, a3, db);
  else if constexpr (N == 48) wgmma_rs_n48(d, a0, a1, a2, a3, db);
  else if constexpr (N == 56) wgmma_rs_n56(d, a0, a1, a2, a3, db);
  else wgmma_rs_n64(d, a0, a1, a2, a3, db);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}

// ---- host: cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess && p)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// an encode that fails returns kEncodeError + its CUresult
constexpr int kEncodeError = 10000;

}  // namespace
