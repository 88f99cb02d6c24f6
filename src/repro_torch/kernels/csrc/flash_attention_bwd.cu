// GQA attention backward for Hopper (sm_90a): the gradients of K3.
//
// Replaces: nothing on the TPU. The reference trains through its pure-JAX
// chunked_attention (src/repro/models/attention.py:33-106), with
// jax.checkpoint per KV chunk, so its backward recomputes each chunk's
// scores; no Pallas backward exists. This file does the same recomputation
// on the card, from the row log-sum-exp that K3's training instantiation
// (csrc/flash_attention.cu, kLse) saves.
//
// Computes, for q, dO (B, Sq, H, Dh), k, v (B, Skv, KH, Dh), the forward's
// o (B, Sq, H, Dh) and lse (B, H, Sq), all fp32 and contiguous, G = H / KH
// and query head h = kh*G + g reading KV head kh, scale = 1/sqrt(Dh):
//   P_ij  = exp(scale * q_i.k_j - lse_i)     where (i, j) is unmasked, else 0
//   D_i   = sum_d dO_id o_id                 (= sum_j P_ij dP_ij)
//   dP_ij = dO_i . v_j,   dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_{g, i} dS_ij q_i,    dv_j = sum_{g, i} P_ij dO_i
// with the forward's masks: causal keeps j <= i, a window keeps
// j > i - window, positions counted from 0 on both sides, ragged Sq and
// Skv masked here. A fully masked row has lse = +inf and o = 0, so its P,
// D and dS are 0 and it adds nothing to any gradient.
//
// Three kernels, no atomics: every output element is written by one
// thread of one block, which sums its terms in a fixed order, so two runs
// give the same bits.
//   (a) attn_bwd_dot_kernel: D, one warp a (b, i, h) row.
//   (b) attn_bwd_dkdv_kernel: one block a (KV tile, KV head, batch). It
//       keeps its K and V tiles in shared memory and walks, for each of the
//       G query heads, the query tiles that the causal and window bands let
//       see its keys; each step recomputes S and dP for a 64 x 64 tile,
//       forms P and dS, and adds P^T.dO and dS^T.Q into dV and dK, held in
//       registers.
//   (c) attn_bwd_dq_kernel: one block a (query tile, head, batch). It keeps
//       its Q and dO tiles and walks the KV tiles its rows can see, adding
//       dS.K into dQ.
//
// What bounds it on this card: operations. Each unmasked (query, key)
// pair of each head costs five products of Dh multiply-adds in the
// algorithm (S, dP, dV, dK, dQ); this design computes S and dP twice (in
// (b) and in (c)), seven in all. At the training shape (B 8, S 256, H 9,
// Dh 64, causal) the five are 1.5 GFLOP, 22.5 us at 67 TFLOP/s fp32; the
// bytes (q, k, v, o, dO, lse read, dq, dk, dv written, ~8 MB) take 2.5 us
// at 3.35 TB/s.
//
// What the design does about it: fp32 FMAs on the CUDA cores (the
// gradients are checked against a float64 reference, and TF32 would need
// the forward's split into three products). 256 threads a block as a
// 16 x 16 grid; each thread owns a 4 x 4 tile of S and dP and a 4 x Dh/16
// tile of its block's gradient, rows ty + 16 i and columns tx + 16 j, so
// in every product a warp reads two broadcast addresses of one operand
// and 16 consecutive (or odd-stride) words of the other, free of bank
// conflicts with rows padded to Dh + 1 and 64 + 1 words. Tiles wholly
// outside the causal or window band are skipped.
// Left for later: tensor cores (split TF32 wgmma, as the forward), and
// a single pass for dK, dV and dQ.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kBQ = 64;        // query rows a tile
constexpr int kBK = 64;        // keys a tile
constexpr int kPad = 1;        // words added to each shared-memory row

template <int DH>
struct Smem {
  static constexpr int kLd = DH + kPad;     // Q, dO, K, V rows
  static constexpr int kLdP = kBK + kPad;   // P, dS rows
  static constexpr int kTile = kBQ * kLd;   // = kBK * kLd
  static constexpr int kPTile = kBQ * kLdP;
  // (b): K, V, Q, dO, P, dS, lse, D;  (c): Q, dO, K, V, dS, lse, D
  static constexpr int kDkdvBytes = (4 * kTile + 2 * kPTile + 2 * kBQ) * 4;
  static constexpr int kDqBytes = (4 * kTile + kPTile + 2 * kBQ) * 4;
};

// acc[i][j] += sum_{c < n} A(ty + 16 i, c) * B(c, tx + 16 j) with
// A(r, c) = a[r * ar + c * ac] and B(c, n) = b[c * bc + n * bn]
template <int RM, int RN>
__device__ __forceinline__ void tile_mma(float (&acc)[RM][RN],
                                         const float* a, int ar, int ac,
                                         const float* b, int bc, int bn,
                                         int n, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = a[(ty + 16 * i) * ar + c * ac];
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = b[c * bc + (tx + 16 * j) * bn];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// rows [r0, r0 + 64) of a (.., rows, heads, DH) tensor's head `head` into a
// padded shared tile; rows past `rows` read as 0
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t batch_off, int r0,
                                          int rows, int heads, int head,
                                          int tid) {
  for (int u = tid; u < 64 * DH; u += kThreads) {
    const int r = u / DH, c = u % DH, row = r0 + r;
    dst[r * (DH + kPad) + c] =
        row < rows
            ? src[((batch_off + row) * heads + head) * static_cast<int64_t>(DH) + c]
            : 0.f;
  }
}

__device__ __forceinline__ bool visible(int i, int j, int Sq, int Skv,
                                        int causal, int window) {
  return i < Sq && j < Skv && (!causal || j <= i) &&
         (window <= 0 || j > i - window);
}

// S and dP for the 64 x 64 tile of queries q0.. (rows of Qs, dOs) and keys
// k0.. (rows of Ks, Vs); writes P into Ps (when non-null) and dS into dSs
template <int DH>
__device__ __forceinline__ void probs_and_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* D_s, float* Ps, float* dSs, int q0,
    int k0, int Sq, int Skv, int causal, int window, float scale, int ty,
    int tx) {
  constexpr int kLd = DH + kPad, kLdP = kBK + kPad;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  tile_mma<4, 4>(s, Qs, kLd, 1, Ks, 1, kLd, DH, ty, tx);
  tile_mma<4, 4>(dp, dOs, kLd, 1, Vs, 1, kLd, DH, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = visible(q0 + r, k0 + c, Sq, Skv, causal, window)
                          ? expf(s[i][j] * scale - lse_s[r])
                          : 0.f;
      if (Ps != nullptr) Ps[r * kLdP + c] = p;
      dSs[r * kLdP + c] = p * (dp[i][j] - D_s[r]);
    }
  }
}

// lse and D of the query rows q0.. of head h; rows past Sq read as 0
__device__ __forceinline__ void load_row_stats(float* lse_s, float* D_s,
                                               const float* lse,
                                               const float* D, int64_t bh,
                                               int q0, int Sq, int tid) {
  if (tid < kBQ) {
    const int i = q0 + tid;
    lse_s[tid] = i < Sq ? lse[bh * Sq + i] : 0.f;
    D_s[tid] = i < Sq ? D[bh * Sq + i] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dot_kernel(const float* __restrict__ dout,
                    const float* __restrict__ out, float* __restrict__ D,
                    int B, int Sq, int H, int DH) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(B) * Sq * H) return;
  const float* a = dout + row * DH;
  const float* o = out + row * DH;
  float s = 0.f;
  for (int d = lane; d < DH; d += 32) s = fmaf(a[d], o[d], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {  // row = (b * Sq + i) * H + h  ->  D[(b * H + h) * Sq + i]
    const int64_t h = row % H, bi = row / H;
    const int64_t b = bi / Sq, i = bi % Sq;
    D[(b * H + h) * Sq + i] = s;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ D, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Skv, int H, int KH,
                     int causal, int window, float scale) {
  using S = Smem<DH>;
  constexpr int kLd = S::kLd, kLdP = S::kLdP, RN = DH / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + S::kTile;
  float* Qs = Vs + S::kTile;
  float* dOs = Qs + S::kTile;
  float* Ps = dOs + S::kTile;
  float* dSs = Ps + S::kPTile;
  float* lse_s = dSs + S::kPTile;
  float* D_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  load_rows<DH>(Ks, k, static_cast<int64_t>(b) * Skv, k0, Skv, KH, kh, tid);
  load_rows<DH>(Vs, v, static_cast<int64_t>(b) * Skv, k0, Skv, KH, kh, tid);

  // the queries that can see keys [k0, k_last]
  const int k_last = min(k0 + kBK, Skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;

  float dk_acc[4][RN], dv_acc[4][RN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    for (int q0 = (q_begin / kBQ) * kBQ; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // the last step is done with Qs, dOs, Ps, dSs
      load_rows<DH>(Qs, q, static_cast<int64_t>(b) * Sq, q0, Sq, H, h, tid);
      load_rows<DH>(dOs, dout, static_cast<int64_t>(b) * Sq, q0, Sq, H, h,
                    tid);
      load_row_stats(lse_s, D_s, lse, D, bh, q0, Sq, tid);
      __syncthreads();
      probs_and_ds<DH>(Qs, dOs, Ks, Vs, lse_s, D_s, Ps, dSs, q0, k0, Sq, Skv,
                       causal, window, scale, ty, tx);
      __syncthreads();
      // dV[key][d] += sum_i P[i][key] dO[i][d]; dK likewise with dS and Q
      tile_mma<4, RN>(dv_acc, Ps, 1, kLdP, dOs, kLd, 1, kBQ, ty, tx);
      tile_mma<4, RN>(dk_acc, dSs, 1, kLdP, Qs, kLd, 1, kBQ, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Skv) continue;
    const int64_t off =
        ((static_cast<int64_t>(b) * Skv + key) * KH + kh) * DH;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      dk[off + tx + 16 * j] = dk_acc[i][j] * scale;
      dv[off + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ D, float* __restrict__ dq,
                   int Sq, int Skv, int H, int KH, int causal, int window,
                   float scale) {
  using S = Smem<DH>;
  constexpr int kLd = S::kLd, kLdP = S::kLdP, RN = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + S::kTile;
  float* Ks = dOs + S::kTile;
  float* Vs = Ks + S::kTile;
  float* dSs = Vs + S::kTile;
  float* lse_s = dSs + S::kPTile;
  float* D_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  load_rows<DH>(Qs, q, static_cast<int64_t>(b) * Sq, q0, Sq, H, h, tid);
  load_rows<DH>(dOs, dout, static_cast<int64_t>(b) * Sq, q0, Sq, H, h, tid);
  load_row_stats(lse_s, D_s, lse, D, bh, q0, Sq, tid);

  // the keys that rows [q0, q_last] can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;

  float dq_acc[4][RN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) dq_acc[i][j] = 0.f;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last step is done with Ks, Vs, dSs
    load_rows<DH>(Ks, k, static_cast<int64_t>(b) * Skv, k0, Skv, KH, kh, tid);
    load_rows<DH>(Vs, v, static_cast<int64_t>(b) * Skv, k0, Skv, KH, kh, tid);
    __syncthreads();
    probs_and_ds<DH>(Qs, dOs, Ks, Vs, lse_s, D_s, nullptr, dSs, q0, k0, Sq,
                     Skv, causal, window, scale, ty, tx);
    __syncthreads();
    // dQ[i][d] += sum_key dS[i][key] K[key][d]
    tile_mma<4, RN>(dq_acc, dSs, kLdP, 1, Ks, kLd, 1, kBK, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const int64_t off = ((static_cast<int64_t>(b) * Sq + row) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < RN; ++j) dq[off + tx + 16 * j] = dq_acc[i][j] * scale;
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

template <int DH>
int launch_dkdv(const float* q, const float* k, const float* v,
                const float* dout, const float* lse, const float* D,
                float* dk, float* dv, int B, int Sq, int Skv, int H, int KH,
                int causal, int window, float scale, cudaStream_t st) {
  static bool done = false;
  const int bytes = Smem<DH>::kDkdvBytes;
  const int rc = configure(attn_bwd_dkdv_kernel<DH>, bytes, done);
  if (rc != 0) return rc;
  const dim3 grid((Skv + kBK - 1) / kBK, KH, B);
  attn_bwd_dkdv_kernel<DH><<<grid, kThreads, bytes, st>>>(
      q, k, v, dout, lse, D, dk, dv, Sq, Skv, H, KH, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* D, float* dq,
              int B, int Sq, int Skv, int H, int KH, int causal, int window,
              float scale, cudaStream_t st) {
  static bool done = false;
  const int bytes = Smem<DH>::kDqBytes;
  const int rc = configure(attn_bwd_dq_kernel<DH>, bytes, done);
  if (rc != 0) return rc;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  attn_bwd_dq_kernel<DH><<<grid, kThreads, bytes, st>>>(
      q, k, v, dout, lse, D, dq, Sq, Skv, H, KH, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int Sq, int Skv, int H, int KH, int Dh) {
  return B >= 1 && B <= 65535 && Sq >= 1 && Skv >= 1 && KH >= 1 &&
         H % KH == 0 && H <= 65535 && (Dh == 64 || Dh == 128);
}

float scale_of(int Dh) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape the kernels do not take
// (Dh other than 64 or 128, H % KH != 0, B or H past 65535). Layouts as at
// the top; every tensor fp32 and contiguous. Call (a), then (b) and (c),
// which read D.

// (a) D (B, H, Sq) from dO and o (B, Sq, H, Dh)
extern "C" int attn_bwd_dot_launch(const void* dout, const void* out,
                                   void* D, int B, int Sq, int H, int Dh,
                                   void* stream) {
  if (!shape_ok(B, Sq, 1, H, 1, Dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(B) * Sq * H;
  const int64_t blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_dot_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dout), static_cast<const float*>(out),
      static_cast<float*>(D), B, Sq, H, Dh);
  return static_cast<int>(cudaGetLastError());
}

// (b) dk, dv (B, Skv, KH, Dh)
extern "C" int attn_bwd_dkdv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* D, void* dk,
                                    void* dv, int B, int Sq, int Skv, int H,
                                    int KH, int Dh, int causal, int window,
                                    void* stream) {
  if (!shape_ok(B, Sq, Skv, H, KH, Dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_dkdv<64>(f(q), f(k), f(v), f(dout), f(lse), f(D),
                           static_cast<float*>(dk), static_cast<float*>(dv),
                           B, Sq, Skv, H, KH, causal, window, scale_of(Dh),
                           st);
  return launch_dkdv<128>(f(q), f(k), f(v), f(dout), f(lse), f(D),
                          static_cast<float*>(dk), static_cast<float*>(dv), B,
                          Sq, Skv, H, KH, causal, window, scale_of(Dh), st);
}

// (c) dq (B, Sq, H, Dh)
extern "C" int attn_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* D, void* dq, int B, int Sq,
                                  int Skv, int H, int KH, int Dh, int causal,
                                  int window, void* stream) {
  if (!shape_ok(B, Sq, Skv, H, KH, Dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_dq<64>(f(q), f(k), f(v), f(dout), f(lse), f(D),
                         static_cast<float*>(dq), B, Sq, Skv, H, KH, causal,
                         window, scale_of(Dh), st);
  return launch_dq<128>(f(q), f(k), f(v), f(dout), f(lse), f(D),
                        static_cast<float*>(dq), B, Sq, Skv, H, KH, causal,
                        window, scale_of(Dh), st);
}
