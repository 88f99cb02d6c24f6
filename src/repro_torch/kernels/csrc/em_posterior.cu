// EM E-step with the cross-entropy fused in (paper Eq 9), for Hopper (sm_90a).
//
// Replaces: the TPU kernel src/repro/kernels/em_posterior.py::em_posterior
// (Pallas body _em_kernel), which streams V through VMEM with a running max,
// a running sum of exponentials and the captured label logit.
//
// Computes, for component logits (M, T, V), labels (T,) and weights pi (M,):
//   ell[t, m] = logsumexp_v logits[m, t, v] - logits[m, t, y_t]
//   lam[t, m] = softmax_m(log max(pi_m, 1e-30) - ell[t, m])
// both (T, M) fp32, with fp32 arithmetic whatever the logits' type.
//
// What bounds it on this card: it reads each logit once and does a few
// flops per logit, far below the H100's ~20 flops/byte balance point for
// fp32, so device memory bounds it: M*T*V*sizeof(logit) bytes in, 8*T*M out.
// At the pFedWN round's shape (M = 10, T = 512, V = 10) that is ~0.25 MB,
// well under a microsecond at 3.35 TB/s, so launch latency sets its time.
//
// What the design does about it: one warp per token row t, eight rows per
// block. For each component m the 32 lanes stride over V (neighbouring lanes
// on neighbouring addresses) keeping a running max and sum of exponentials,
// a butterfly of warp shuffles combines them, and the lane whose v == y_t
// supplies the label logit. Lane m keeps component m's score, so the softmax
// over M is one more shuffle reduction and needs no shared memory: M is at
// most 32 (the wrapper raises above that). Logits never round-trip through
// device memory as log-probabilities. Ragged T and V are handled by the row
// guard and the strided loop, so no padding is needed (the TPU kernel
// required T % 128 == 0 and V % 512 == 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Merge the (max, sum of exp(x - max)) pair (m2, s2) into (m, s).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both halves saw no element
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
em_posterior_kernel(const float* __restrict__ pi, const T* __restrict__ logits,
                    const int64_t* __restrict__ labels,
                    float* __restrict__ lam, float* __restrict__ ell, int M,
                    int n_tokens, int V) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= n_tokens) return;  // the whole warp leaves together
  const int64_t y = labels[t];

  float my_score = -INFINITY;  // lane m: log pi_m - ell[t, m]
  float my_ell = 0.f;          // lane m: ell[t, m]
  for (int m = 0; m < M; ++m) {
    const T* row = logits + (static_cast<int64_t>(m) * n_tokens + t) * V;
    float mx = -INFINITY, s = 0.f, picked = 0.f;
    for (int v = lane; v < V; v += 32) {
      const float x = to_f32(row[v]);
      if (x > mx) {
        s = s * expf(mx - x) + 1.f;
        mx = x;
      } else {
        s += expf(x - mx);
      }
      if (v == y) picked = x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(kFullMask, mx, off);
      const float s2 = __shfl_xor_sync(kFullMask, s, off);
      lse_merge(mx, s, m2, s2);
      picked += __shfl_xor_sync(kFullMask, picked, off);
    }
    if (lane == m) {
      my_ell = mx + logf(fmaxf(s, 1e-30f)) - picked;
      my_score = logf(fmaxf(pi[m], 1e-30f)) - my_ell;
    }
  }

  // softmax over the M components, one per lane
  float mx = my_score;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
  const float e = lane < M ? expf(my_score - mx) : 0.f;
  float sum = e;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFullMask, sum, off);
  if (lane < M) {
    const int64_t o = static_cast<int64_t>(t) * M + lane;
    lam[o] = e / sum;
    ell[o] = my_ell;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// logits: (M, T, V) contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// pi: (M,) fp32; labels: (T,) int64 in [0, V); lam, ell: (T, M) fp32.
extern "C" int em_posterior_launch(const void* pi, const void* logits,
                                   const void* labels, void* lam, void* ell,
                                   int M, int T, int V, int is_bf16,
                                   void* stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((T + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pi);
  const int64_t* y = static_cast<const int64_t*>(labels);
  float* l = static_cast<float*>(lam);
  float* c = static_cast<float*>(ell);
  if (is_bf16) {
    em_posterior_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        p, static_cast<const __nv_bfloat16*>(logits), y, l, c, M, T, V);
  } else {
    em_posterior_kernel<float><<<grid, block, 0, st>>>(
        p, static_cast<const float*>(logits), y, l, c, M, T, V);
  }
  return static_cast<int>(cudaGetLastError());
}
