// Erasure-gated Eq-1 mix over flat parameter buffers, for Hopper (sm_90a).
//
// Replaces: the TPU kernel src/repro/kernels/weighted_agg.py::weighted_agg
// (Pallas body _agg_kernel), which reads (8, 128)-aligned tiles of own and
// the (M, P) neighbour stack and writes alpha*own + (1-alpha)*sum_m pi_m*nb_m.
//
// Computes, for p in [0, P):
//   out[p] = any_ok ? alpha*own[p] + beta*sum_m w[m]*nb[index[m]*stride + p]
//                   : own[p]
// with fp32 accumulation, cast to own's type (fp32 or bf16). beta = 1-alpha
// comes from the caller. w = masked_pi(pi, link_ok) and any_ok live on the
// device, so the round never syncs with the host to decide the erasure case.
//
// What bounds it on this card: 2*M+3 flops per element against (M+2)
// elements moved, so memory bounds it: (M+2)*P*sizeof(T) bytes. At the
// pFedWN round's shape (M = 10, P = 188,810, fp32) that is 9.06 MB, about
// 2.7 us at 3.35 TB/s (at M = 39, 31 MB and 9.2 us); in the round the
// stack is L2-resident, so a launch and two dependent load latencies
// (index, then the rows) are most of it.
//
// What the design does about it:
// - One persistent grid-stride pass, sized on the host from the occupancy
//   of the instantiation so that it runs in one wave, and no larger than
//   the work: the per-thread setup (M row numbers and M weights read
//   straight into registers, no shared memory and no barrier) is paid once.
// - M is a template parameter (0..32), so the weights and row pointers sit
//   in registers with no predication and the component loop is unrolled to
//   exactly M.
// - M has no cap: past 32 a second kernel, weighted_agg_wide (one
//   instantiation per type and vector width), runs the same one-launch
//   stream with M a runtime count. Each thread walks the rows K at a time
//   (K rows of U vectors, 128 bytes of loads in flight, the last group
//   cut short), reading each group's row numbers and weights from L1 as
//   it goes (one broadcast load each), and sums every row into the same
//   fp32 accumulators, cast to T once after the last row. A loop over the
//   rows inside the templated kernel instead took the round's M = 10
//   instantiation from 60 to 158 registers (1 block an SM in place of 4)
//   and 4.37 to 4.60 us, so the two kernels stay apart and M <= 32 runs
//   the templated one unchanged.
// - Each thread moves U vectors of VB bytes per row per iteration (VB a
//   template parameter picked by the wrapper from the alignment that every
//   row base, the row stride, own and out share), and issues all (M+1)*U
//   loads through the read-only path before the first FMA. A scalar tail
//   covers the ragged end. The round's stack has a row stride of P =
//   188,810 fp32 = 755,240 B, which is 8 (mod 16), so it gets 8-byte
//   vectors.
// - any_ok false copies own to out without reading a neighbour row.
// - No TMA: 1-D bulk copies need 16-byte-aligned addresses and sizes,
//   which the round's odd rows do not have, and a register stream with
//   enough loads in flight keeps as many bytes in flight without them.
// The neighbour rows are read in place from the stacked (N, P) client
// buffer through `index`, so the (M, P) gather is never materialised.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxComponents = 32;

template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// U = vectors per row per iteration: 2, or 1 where (M+1) rows of two
// vectors would hold more than 256 bytes of loads in registers
template <int M, int VB>
__host__ __device__ constexpr int unroll() {
  return (M + 1) * VB * 2 <= 256 ? 2 : 1;
}

template <typename T, int M, int VB>
__global__ void __launch_bounds__(kThreads)
weighted_agg_kernel(const T* __restrict__ own, const T* __restrict__ nb,
                    int64_t nb_stride, const int64_t* __restrict__ index,
                    const float* __restrict__ w,
                    const bool* __restrict__ any_ok, T* __restrict__ out,
                    int64_t P, float alpha, float beta) {
  using V = typename Vec<VB>::type;
  constexpr int E = VB / static_cast<int>(sizeof(T));   // elements a vector
  constexpr int U = unroll<M, VB>();
  const int64_t n_vec = P / E;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const V* own_v = reinterpret_cast<const V*>(own);
  V* out_v = reinterpret_cast<V*>(out);

  if (any_ok != nullptr && !*any_ok) {        // every link erased: out = own
    for (int64_t i = tid; i < n_vec; i += n_threads)
      out_v[i] = __ldg(own_v + i);
    for (int64_t p = n_vec * E + tid; p < P; p += n_threads) out[p] = own[p];
    return;
  }

  constexpr int MA = M > 0 ? M : 1;           // M = 0 mixes in nothing
  const V* rows[MA];
  float wr[MA];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int64_t r = index ? __ldg(index + m) : m;
    rows[m] = reinterpret_cast<const V*>(nb + r * nb_stride);
    wr[m] = __ldg(w + m);
  }

  for (int64_t base = tid; base < n_vec; base += U * n_threads) {
    V o[U], x[MA][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = base + u * n_threads;
      if (i < n_vec) {
        o[u] = __ldg(own_v + i);
#pragma unroll
        for (int m = 0; m < M; ++m) x[m][u] = __ldg(rows[m] + i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = base + u * n_threads;
      if (i >= n_vec) continue;
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const T* xe = reinterpret_cast<const T*>(&x[m][u]);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(wr[m], to_f32(xe[e]), acc[e]);
      }
      const T* oe = reinterpret_cast<const T*>(&o[u]);
      V res;
      T* re = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < E; ++e)
        re[e] = from_f32<T>(alpha * to_f32(oe[e]) + beta * acc[e]);
      out_v[i] = res;
    }
  }

  // the ragged end, fewer than E elements past the last whole vector
  for (int64_t p = n_vec * E + tid; p < P; p += n_threads) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m)
      acc = fmaf(wr[m], to_f32(reinterpret_cast<const T*>(rows[m])[p]), acc);
    out[p] = from_f32<T>(alpha * to_f32(own[p]) + beta * acc);
  }
}

// Rows a thread loads together in weighted_agg_wide: 128 bytes of loads
// in flight a thread, half of what unroll() lets the templated kernel hold
template <int U, int VB>
__host__ __device__ constexpr int wide_rows() {
  return U * VB <= 16 ? 8 : 4;
}

// The same mix for any M > kMaxComponents, M a runtime count: the rows are
// read K at a time (the last group may hold fewer) into one set of fp32
// accumulators; U = 2 vectors a row an iteration.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
weighted_agg_wide(const T* __restrict__ own, const T* __restrict__ nb,
                  int64_t nb_stride, const int64_t* __restrict__ index,
                  const float* __restrict__ w,
                  const bool* __restrict__ any_ok, T* __restrict__ out,
                  int64_t P, float alpha, float beta, int M) {
  using V = typename Vec<VB>::type;
  constexpr int E = VB / static_cast<int>(sizeof(T));
  constexpr int U = 2;
  constexpr int K = wide_rows<U, VB>();
  const int64_t n_vec = P / E;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const V* own_v = reinterpret_cast<const V*>(own);
  V* out_v = reinterpret_cast<V*>(out);

  if (any_ok != nullptr && !*any_ok) {        // every link erased: out = own
    for (int64_t i = tid; i < n_vec; i += n_threads)
      out_v[i] = __ldg(own_v + i);
    for (int64_t p = n_vec * E + tid; p < P; p += n_threads) out[p] = own[p];
    return;
  }

  for (int64_t base = tid; base < n_vec; base += U * n_threads) {
    V o[U];                                   // own, in flight behind the rows
    float acc[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = base + u * n_threads;
      if (i < n_vec) o[u] = __ldg(own_v + i);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[u][e] = 0.f;
    }
#pragma unroll 1
    for (int j0 = 0; j0 < M; j0 += K) {
      const int kn = M - j0 < K ? M - j0 : K;        // rows in this group
      const V* rows[K];
      float wr[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k >= kn) break;
        const int64_t r = index ? __ldg(index + j0 + k) : j0 + k;
        rows[k] = reinterpret_cast<const V*>(nb + r * nb_stride);
        wr[k] = __ldg(w + j0 + k);
      }
      V x[K][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t i = base + u * n_threads;
        if (i >= n_vec) continue;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (k < kn) x[k][u] = __ldg(rows[k] + i);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (base + u * n_threads >= n_vec) continue;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k >= kn) break;
          const T* xe = reinterpret_cast<const T*>(&x[k][u]);
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[u][e] = fmaf(wr[k], to_f32(xe[e]), acc[u][e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = base + u * n_threads;
      if (i >= n_vec) continue;
      const T* oe = reinterpret_cast<const T*>(&o[u]);
      V res;
      T* re = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < E; ++e)
        re[e] = from_f32<T>(alpha * to_f32(oe[e]) + beta * acc[u][e]);
      out_v[i] = res;
    }
  }

  // the ragged end, fewer than E elements past the last whole vector
  for (int64_t p = n_vec * E + tid; p < P; p += n_threads) {
    float acc = 0.f;
#pragma unroll 1
    for (int j = 0; j < M; ++j) {
      const int64_t r = index ? __ldg(index + j) : j;
      acc = fmaf(__ldg(w + j), to_f32(nb[r * nb_stride + p]), acc);
    }
    out[p] = from_f32<T>(alpha * to_f32(own[p]) + beta * acc);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

// Blocks for a one-wave persistent launch of `kernel` (U vectors of E
// elements a thread an iteration): no more than the work needs, no more
// than fit the card at once; 0 on error, with the error in *err.
template <typename Kernel>
int one_wave_grid(Kernel kernel, int* resident, long long P, int per_thread,
                  cudaError_t* err) {
  *err = cudaSuccess;
  if (*resident == 0) {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                         kThreads, 0);
    if (*err != cudaSuccess) return 0;
  }
  const int sms = sm_count();
  if (sms == 0) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  const long long per_block = static_cast<long long>(kThreads) * per_thread;
  const long long need = (P + per_block - 1) / per_block;
  return static_cast<int>(
      need < 1 ? 1 : (need < *resident * sms ? need : *resident * sms));
}

template <typename T, int M, int VB>
int launch(const void* own, const void* nb, long long nb_stride,
           const int64_t* idx, const float* w, const bool* ok, void* out,
           long long P, float alpha, float beta, int* grid_out,
           cudaStream_t st) {
  static int resident = 0;                    // blocks per SM, per function
  constexpr int E = VB / static_cast<int>(sizeof(T));
  cudaError_t err;
  const int grid = one_wave_grid(weighted_agg_kernel<T, M, VB>, &resident,
                                 P, unroll<M, VB>() * E, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid_out) *grid_out = grid;
  weighted_agg_kernel<T, M, VB><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(own), static_cast<const T*>(nb), nb_stride, idx,
      w, ok, static_cast<T*>(out), P, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB>
int launch_wide(const void* own, const void* nb, long long nb_stride,
                const int64_t* idx, const float* w, const bool* ok,
                void* out, int M, long long P, float alpha, float beta,
                int* grid_out, cudaStream_t st) {
  static int resident = 0;
  constexpr int E = VB / static_cast<int>(sizeof(T));
  cudaError_t err;
  const int grid = one_wave_grid(weighted_agg_wide<T, VB>, &resident, P,
                                 2 * E, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid_out) *grid_out = grid;
  weighted_agg_wide<T, VB><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(own), static_cast<const T*>(nb), nb_stride, idx,
      w, ok, static_cast<T*>(out), P, alpha, beta, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB, int M = 0>
int launch_m(int m, const void* own, const void* nb, long long nb_stride,
             const int64_t* idx, const float* w, const bool* ok, void* out,
             long long P, float alpha, float beta, int* grid_out,
             cudaStream_t st) {
  if (m == M)
    return launch<T, M, VB>(own, nb, nb_stride, idx, w, ok, out, P, alpha,
                            beta, grid_out, st);
  if constexpr (M < kMaxComponents)
    return launch_m<T, VB, M + 1>(m, own, nb, nb_stride, idx, w, ok, out, P,
                                  alpha, beta, grid_out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_vb(int vb, int m, const void* own, const void* nb,
              long long nb_stride, const int64_t* idx, const float* w,
              const bool* ok, void* out, long long P, float alpha, float beta,
              int* grid_out, cudaStream_t st) {
  if (m > kMaxComponents) {
    switch (vb) {
      case 16:
        return launch_wide<T, 16>(own, nb, nb_stride, idx, w, ok, out, m, P,
                                  alpha, beta, grid_out, st);
      case 8:
        return launch_wide<T, 8>(own, nb, nb_stride, idx, w, ok, out, m, P,
                                 alpha, beta, grid_out, st);
      case 4:
        return launch_wide<T, 4>(own, nb, nb_stride, idx, w, ok, out, m, P,
                                 alpha, beta, grid_out, st);
      case 2:
        if constexpr (sizeof(T) == 2)
          return launch_wide<T, 2>(own, nb, nb_stride, idx, w, ok, out, m,
                                   P, alpha, beta, grid_out, st);
        return static_cast<int>(cudaErrorInvalidValue);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (vb) {
    case 16:
      return launch_m<T, 16>(m, own, nb, nb_stride, idx, w, ok, out, P,
                             alpha, beta, grid_out, st);
    case 8:
      return launch_m<T, 8>(m, own, nb, nb_stride, idx, w, ok, out, P, alpha,
                            beta, grid_out, st);
    case 4:
      return launch_m<T, 4>(m, own, nb, nb_stride, idx, w, ok, out, P, alpha,
                            beta, grid_out, st);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_m<T, 2>(m, own, nb, nb_stride, idx, w, ok, out, P,
                              alpha, beta, grid_out, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for M < 0 or a vector width the type does not
// take. M <= 32 runs weighted_agg_kernel<M>, a larger M weighted_agg_wide;
// either way one launch. own, out: (P,); nb: rows of nb_stride elements, each with
// P contiguous; index: (M,) int64 row numbers, or null for rows 0..M-1; w:
// (M,) fp32; any_ok: one bool, or null for "some link survived". vec_bytes
// (16, 8, 4, or 2 for bf16) must divide own, out, nb and nb_stride in
// bytes. grid_out, when not null, receives the number of blocks launched.
extern "C" int weighted_agg_launch(const void* own, const void* nb,
                                   long long nb_stride, const void* index,
                                   const void* w, const void* any_ok,
                                   void* out, int M, long long P, float alpha,
                                   float beta, int is_bf16, int vec_bytes,
                                   int* grid_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* idx = static_cast<const int64_t*>(index);
  const float* wp = static_cast<const float*>(w);
  const bool* ok = static_cast<const bool*>(any_ok);
  if (M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch_vb<__nv_bfloat16>(vec_bytes, M, own, nb, nb_stride, idx,
                                    wp, ok, out, P, alpha, beta, grid_out,
                                    st);
  return launch_vb<float>(vec_bytes, M, own, nb, nb_stride, idx, wp, ok, out,
                          P, alpha, beta, grid_out, st);
}
