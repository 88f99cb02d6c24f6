// GQA attention forward with an online softmax, for Hopper (sm_90a): K3.
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py:77
// (flash_attention, Pallas body _attn_kernel). There the kv-block axis of
// the grid runs in order and carries the running max m, the denominator l
// and the accumulator in VMEM scratch; here one block owns a tile of query
// rows and walks the K/V tiles in a loop, with m, l and its share of the
// accumulator in registers.
//
// Computes, for q (B, Sq, H, Dh) and k, v (B, Skv, KH, Dh), all contiguous,
// G = H / KH and query head h = kh*G + g reading KV head kh:
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, kh],
//   s_ij = (q[b, i, h] / sqrt(Dh)) . k[b, j, kh]  over the unmasked j,
// masked where causal and j > i, or where window > 0 and j <= i - window
// (positions count from 0 on both sides, as in the reference). Masked
// scores are NEG_INF and their probabilities are zeroed explicitly, so a
// fully masked row gives 0 (acc / max(l, 1e-30)). fp32 arithmetic for fp32
// and bf16 inputs; the output has q's type. Ragged Sq and Skv are masked
// here, so nothing is padded.
//
// The GQA fold: the G query heads of one KV head are G adjacent rows of
// the (Sq*G, Dh) row space (row = i*G + g), read in place by stride. A
// block takes 64 such rows, so each K/V tile it loads serves all G heads.
//
// What bounds it on this card: operations at prefill lengths. Each
// unmasked (query, key) pair of each head costs 4*Dh FLOPs (Dh
// multiply-adds for the score, Dh for P.V). At smollm-135m's prefill
// (B 8, S 1024, H 9, Dh 64, causal) that is 9.7 GFLOP: 0.145 ms at 67
// TFLOP/s on the fp32 CUDA cores, or 0.0098 ms at 989 TFLOP/s bf16 on the
// tensor cores; the 50 MB it must move take 0.015 ms at 3.35 TB/s.
//
// What the simple design does and leaves on the table: both products run
// as fp32 FMAs on the CUDA cores (no TF32, for parity with the fp32
// reference at 2e-6), each thread holding a 4x4 score tile and a 4 x Dh/16
// slice of the accumulator, with operands read from shared memory as
// float4 in a conflict-free pattern (row stride Dh+4, keys and rows strided
// by 16 across threads). K/V tiles that lie wholly outside the causal or
// window band are skipped. Left for later: wgmma on the tensor cores (bf16,
// or TF32 where the tolerance allows), TMA loads into a ring of tiles
// double-buffered against compute, warp specialisation, and a persistent
// schedule that balances the causal triangle across SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid: tx picks keys/dims, ty rows
constexpr int kRows = 64;       // folded (query, head) rows per block
constexpr int kKeys = 64;       // keys per K/V tile
constexpr int kPStride = kKeys + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = u.x;
  *reinterpret_cast<uint32_t*>(&hi) = u.y;
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float get(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

template <int DH>
constexpr size_t smem_bytes() {
  return 3 * kRows * (DH + 4) * sizeof(float);   // Q, K (then P), V
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int H, int KH, int causal, int window,
                       float scale) {
  constexpr int S = DH + 4;           // floats per shared row
  constexpr int D4 = DH / 4;
  constexpr int E = DH / 64;          // float4 groups of dims per thread
  static_assert(kRows * kPStride <= kKeys * S, "P must fit in the K tile");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kRows * S;
  float* vs = ks + kKeys * S;
  float* ps = ks;                     // P reuses K once scores are in registers

  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int n_rows = Sq * G;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // this block's query rows, scaled by 1/sqrt(Dh), zeros past the end
  for (int i = tid; i < kRows * D4; i += kThreads) {
    const int r = i / D4, c = (i % D4) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) {
      const int qi = row / G, g = row % G;
      x = load4(q + ((static_cast<int64_t>(b) * Sq + qi) * H + kh * G + g) *
                        DH + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    store4(qs + r * S + c, x);
  }

  int qpos[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    row_ok[i] = row < n_rows;
    qpos[i] = row / G;
  }
  // keys this tile of rows can see: skip K/V tiles outside the band
  const int q_lo = row0 / G, q_hi = (min(row0 + kRows, n_rows) - 1) / G;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int t_begin = k_begin / kKeys;
  const int t_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : t_begin;

  float m[4], l[4], acc[4][4 * E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4 * E; ++d) acc[i][d] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();                  // the last tile's P.V is done with ps, vs
    for (int i = tid; i < kKeys * D4; i += kThreads) {
      const int r = i / D4, c = (i % D4) * 4;
      const int key = key0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < Skv) {
        const int64_t off =
            ((static_cast<int64_t>(b) * Skv + key) * KH + kh) * DH + c;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      store4(ks + r * S + c, kx);
      store4(vs + r * S + c, vx);
    }
    __syncthreads();

    // scores for rows ty + 16i and keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(qs + (ty + 16 * i) * S + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = load4(ks + (tx + 16 * j) * S + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = fmaf(a[i].x, bk[j].x, s[i][j]);
          x = fmaf(a[i].y, bk[j].y, x);
          x = fmaf(a[i].z, bk[j].z, x);
          s[i][j] = fmaf(a[i].w, bk[j].w, x);
        }
    }

    // online softmax; a row's 16 threads share one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = key0 + tx + 16 * j;
        keep[j] = row_ok[i] && kp < Skv && (!causal || kp <= qpos[i]) &&
                  (window <= 0 || kp > qpos[i] - window);
        s[i][j] = keep[j] ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = keep[j] ? expf(s[i][j] - m_new) : 0.f;   // now P
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;       // this thread's keys; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < 4 * E; ++d) acc[i][d] *= corr;
    }

    __syncthreads();                  // every thread is done reading ks
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc[rows ty + 16i, dims tx*4 + 64e .. +3] += P . V
#pragma unroll 2
    for (int kk = 0; kk < kKeys; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = load4(ps + (ty + 16 * i) * kPStride + kk);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float4 vv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) vv[e] = load4(vs + (kk + c) * S + tx * 4 + 64 * e);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = get(pr[i], c);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc[i][4 * e + 0] = fmaf(p, vv[e].x, acc[i][4 * e + 0]);
            acc[i][4 * e + 1] = fmaf(p, vv[e].y, acc[i][4 * e + 1]);
            acc[i][4 * e + 2] = fmaf(p, vv[e].z, acc[i][4 * e + 2]);
            acc[i][4 * e + 3] = fmaf(p, vv[e].w, acc[i][4 * e + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = row0 + ty + 16 * i;
    if (row < n_rows) {
      const int qi = row / G, g = row % G;
      T* dst = o + ((static_cast<int64_t>(b) * Sq + qi) * H + kh * G + g) * DH;
      const float den = fmaxf(li, 1e-30f);
#pragma unroll
      for (int e = 0; e < E; ++e)
        store4(dst + tx * 4 + 64 * e,
               make_float4(acc[i][4 * e] / den, acc[i][4 * e + 1] / den,
                           acc[i][4 * e + 2] / den, acc[i][4 * e + 3] / den));
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KH, int causal, int window,
           cudaStream_t st) {
  static bool configured = false;     // the attribute holds per function
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<DH>()));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int G = H / KH;
  const dim3 grid((Sq * G + kRows - 1) / kRows, KH, B);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  flash_attention_kernel<T, DH><<<grid, kThreads, smem_bytes<DH>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KH, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head size other than 64 or 128.
// q, o: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh); contiguous, of one type
// (fp32, or bf16 when is_bf16), 16-byte (fp32) or 8-byte (bf16) aligned.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KH, int Dh,
                                      int causal, int window, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Skv, H, KH,
                                               causal, window, st)
                   : launch<float, 64>(q, k, v, o, B, Sq, Skv, H, KH, causal,
                                       window, st);
  if (Dh == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Skv, H,
                                                KH, causal, window, st)
                   : launch<float, 128>(q, k, v, o, B, Sq, Skv, H, KH, causal,
                                        window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
