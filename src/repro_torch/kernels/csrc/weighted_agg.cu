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
// elements moved, so device memory bounds it: (M+2)*P*sizeof(T) bytes. At
// the pFedWN round's shape (M = 10, P = 188,810, fp32) that is 9.06 MB,
// about 2.7 us at 3.35 TB/s.
//
// What the design does about it: every input byte is read once and every
// output byte written once, in one grid-stride pass with neighbouring
// threads on neighbouring addresses. The neighbour rows are read in place
// from the stacked (N, P) client buffer through `index`, so the (M, P)
// gather is never materialised. The M weights are held in registers (the
// component loop is unrolled to the maximum, 32, and predicated) and the M
// row pointers are staged once per block in shared memory. The tail needs
// no padding: the loop bound masks it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxComponents = 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
weighted_agg_kernel(const T* __restrict__ own, const T* __restrict__ nb,
                    int64_t nb_stride, const int64_t* __restrict__ index,
                    const float* __restrict__ w,
                    const bool* __restrict__ any_ok, T* __restrict__ out,
                    int M, int64_t P, float alpha, float beta) {
  __shared__ const T* rows[kMaxComponents];
  if (threadIdx.x < M) {
    const int64_t r = index ? index[threadIdx.x] : threadIdx.x;
    rows[threadIdx.x] = nb + r * nb_stride;
  }
  __syncthreads();
  const bool keep_own = any_ok != nullptr && !*any_ok;
  float wr[kMaxComponents];
#pragma unroll
  for (int m = 0; m < kMaxComponents; ++m) wr[m] = m < M ? w[m] : 0.f;

  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < P; p += step) {
    const float o = to_f32(own[p]);
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxComponents; ++m)
      if (m < M) acc += wr[m] * to_f32(rows[m][p]);
    out[p] = from_f32<T>(keep_own ? o : alpha * o + beta * acc);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// own, out: (P,); nb: rows of nb_stride elements, each with P contiguous;
// index: (M,) int64 row numbers, or null for rows 0..M-1; w: (M,) fp32;
// any_ok: one bool, or null for "some link survived". M <= 32.
extern "C" int weighted_agg_launch(const void* own, const void* nb,
                                   long long nb_stride, const void* index,
                                   const void* w, const void* any_ok,
                                   void* out, int M, long long P, float alpha,
                                   float beta, int is_bf16, int n_blocks,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* idx = static_cast<const int64_t*>(index);
  const float* wp = static_cast<const float*>(w);
  const bool* ok = static_cast<const bool*>(any_ok);
  if (is_bf16) {
    weighted_agg_kernel<__nv_bfloat16><<<n_blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(own),
        static_cast<const __nv_bfloat16*>(nb), nb_stride, idx, wp, ok,
        static_cast<__nv_bfloat16*>(out), M, P, alpha, beta);
  } else {
    weighted_agg_kernel<float><<<n_blocks, kThreads, 0, st>>>(
        static_cast<const float*>(own), static_cast<const float*>(nb),
        nb_stride, idx, wp, ok, static_cast<float*>(out), M, P, alpha, beta);
  }
  return static_cast<int>(cudaGetLastError());
}
