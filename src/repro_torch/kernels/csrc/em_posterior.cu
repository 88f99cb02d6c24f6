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
// At a vocabulary's width (M = 8, T = 512, V = 49,152) that is 805 MB in
// fp32, 0.24 ms at 3.35 TB/s, and the kernel has to keep ~2 MB of loads in
// flight to get there. At the pFedWN round's shape (M = 10, T = 512,
// V = 10) it is ~0.25 MB: one load round trip and the launch set the time.
//
// What the design does about it:
// - A team of G lanes (G a power of two, 1..32, a template parameter the
//   wrapper picks from V) owns one (t, m) row. A block's rows are numbered
//   m * tile + t, so neighbouring teams take neighbouring tokens of one
//   component, and a warp covers 32 / (G * tile) components, each over
//   `tile` consecutive tokens: at the round's plan (G 2, tile 4) four
//   stretches of 160 bytes, T * V elements apart. The tile stays that
//   small so that the grid reaches the 132 SMs (see below). At the
//   round's V = 10 two lanes share a row (8-byte vectors, 3 and 2 a lane:
//   the shorter chain per lane beat one lane a row by 0.2 us in fp32 and
//   0.6 us in bf16); at vocabulary widths a warp streams one.
// - A lane loads its whole share of a chunk (kVectors = 4 vectors of VB
//   bytes, VB picked by the wrapper from the alignment every row shares)
//   into registers before any arithmetic, then takes the chunk's max and
//   the label logit (one compare a vector), and its sum of exp(x - max),
//   with no shuffle. Only between chunks (a row wider than G * 4 vectors)
//   is the running (max, sum) rescaled, once a chunk, and only at a row's
//   end do the G lanes combine through log2(G) shuffle levels. Four
//   vectors a lane keep every instantiation within 64 registers, so four
//   blocks of 256 threads fit an SM and a vocabulary-wide grid of 512
//   blocks runs in one wave (8 vectors took 69-72 registers without
//   spilling, 3 blocks an SM, and ran 12 % slower there).
// - A block takes a tile of tokens x all M components. The labels are read
//   once per token into shared memory, behind the first row's loads; each
//   team leaves its row's score log pi_m - ell and its ell in shared memory;
//   after one barrier one thread per token takes the softmax over M and
//   writes that token's M values of lam and ell contiguously.
// - M has no cap. Where a tile's rows (tile x M) outgrow the block's stage
//   of kMaxThreads rows, which happens only past M = kMaxThreads (the
//   wrapper then plans one token a block), the kernel stages in its
//   outputs instead (kStageOut): each team writes its ell to ell[t, m] and
//   its score to lam[t, m], and after the barrier one warp per token takes
//   the softmax over M in steps of 32 components, reading the scores back
//   from lam (L1/L2: the block has just written them). That costs one more
//   read and write of lam, 8 bytes a row beside the row's V logits, and
//   needs no shared memory that grows with M. Every plan with tile x M <=
//   kMaxThreads runs the shared-memory stage as before.
// - The wrapper sizes the token tile so that the grid covers the 132 SMs
//   even at the round's 5,120 rows (128 blocks of 96 threads there).
// - ell is summed as (max - label logit) + log(sum), the order
//   torch.log_softmax rounds in, so a row's ell keeps its small absolute
//   error when the logits are large. A row of all -inf gives NaN and a
//   label logit of -inf gives +inf, as the plain version does.
// Ragged T and V need no padding (the TPU kernel required T % 128 == 0 and
// V % 512 == 0): rows past T and vectors past V are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The kernel's tuning; the wrapper's plan reads both through
// em_posterior_limits. A tile's rows (tokens x M) are at most kMaxThreads.
constexpr int kMaxThreads = 256;  // a block's threads, at most
constexpr int kVectors = 4;       // vectors a lane holds a chunk

template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The largest of a vector's E elements, in fp32. bf16 pairs are compared
// as bf16x2 (one instruction a pair, exact) and only the winner converted.
template <typename T, int VB, typename Vt>
__device__ __forceinline__ float vector_max(const Vt& v) {
  constexpr int E = VB / static_cast<int>(sizeof(T));
  if constexpr (sizeof(T) == 2 && VB >= 4) {
    const __nv_bfloat162* w = reinterpret_cast<const __nv_bfloat162*>(&v);
    __nv_bfloat162 m2 = w[0];
#pragma unroll
    for (int k = 1; k < VB / 4; ++k) m2 = __hmax2(m2, w[k]);
    return fmaxf(__low2float(m2), __high2float(m2));
  } else {
    const T* x = reinterpret_cast<const T*>(&v);
    float m = to_f32(x[0]);
#pragma unroll
    for (int e = 1; e < E; ++e) m = fmaxf(m, to_f32(x[e]));
    return m;
  }
}

// Merge the (max, sum of exp(x - max)) pair (m2, s2) into (m, s).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both halves saw no finite element
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T, int G, int VB, bool kStageOut>
__global__ void __launch_bounds__(kMaxThreads, 4)
em_posterior_kernel(const float* __restrict__ pi, const T* __restrict__ logits,
                    const int64_t* __restrict__ labels,
                    float* __restrict__ lam, float* __restrict__ ell, int M,
                    int n_tokens, int V, int tile) {
  using Vt = typename Vec<VB>::type;
  constexpr int E = VB / static_cast<int>(sizeof(T));  // elements a vector
  constexpr int kStride = G * kVectors;                // vectors a chunk
  constexpr int kStage = kStageOut ? 1 : kMaxThreads;  // rows staged here
  __shared__ int64_t s_label[kMaxThreads];
  __shared__ float s_score[kStage];
  __shared__ float s_ell[kStage];

  const int tid = threadIdx.x;
  const int team = tid / G, g = tid % G;
  const int n_teams = blockDim.x / G;
  const int t0 = blockIdx.x * tile;
  const int n_tok = min(tile, n_tokens - t0);
  const int n_rows = tile * M;  // row r: component r / tile, token r % tile
  const int n_vec = V / E;      // whole vectors a row (E divides V)

  Vt buf[kVectors];
  const Vt* row = nullptr;
  bool active = false;
  float pi_m = 0.f;
  int r = team;
  // Point at row r and issue its first chunk's loads and its pi_m.
  auto start_row = [&]() {
    const int m = r / tile, tl = r - m * tile;
    active = r < n_rows && tl < n_tok;
    if (!active) return;
    row = reinterpret_cast<const Vt*>(
        logits + (static_cast<int64_t>(m) * n_tokens + t0 + tl) * V);
    pi_m = __ldg(pi + m);
#pragma unroll
    for (int j = 0; j < kVectors; ++j)
      if (j * G + g < n_vec) buf[j] = __ldg(row + j * G + g);
  };

  start_row();
  if (tid < n_tok) s_label[tid] = __ldg(labels + t0 + tid);
  __syncthreads();

  // Every team of the block runs the same number of row and chunk steps,
  // so the warps stay converged for the shuffles; idle teams mask.
  for (int base = 0; base < n_rows; base += n_teams) {
    // labels are in [0, V), so they fit an int; -1 matches no logit
    const int y = active ? static_cast<int>(s_label[r % tile]) : -1;
    float mx = -INFINITY, s = 0.f, picked = 0.f;
    for (int c = 0;;) {  // c: the chunk's first vector; buf holds it
      // pass 1: the chunk's max, and the label logit where this lane has it
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < kVectors; ++j) {
        const int i = c + j * G + g;
        if (!active || i >= n_vec) continue;
        cm = fmaxf(cm, vector_max<T, VB>(buf[j]));
        const unsigned k = static_cast<unsigned>(y - i * E);
        if (k < E) {
          const T* x = reinterpret_cast<const T*>(&buf[j]);
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (k == e) picked = to_f32(x[e]);
        }
      }
      // pass 2: the chunk's sum of exp(x - max)
      float cs = 0.f;
#pragma unroll
      for (int j = 0; j < kVectors; ++j) {
        if (!active || c + j * G + g >= n_vec) continue;
        const T* x = reinterpret_cast<const T*>(&buf[j]);
#pragma unroll
        for (int e = 0; e < E; ++e) cs += expf(to_f32(x[e]) - cm);
      }
      if (cm == -INFINITY) cs = 0.f;  // exp(-inf - -inf) is NaN
      if (c == 0) {
        mx = cm;
        s = cs;
      } else {
        lse_merge(mx, s, cm, cs);
      }
      c += kStride;
      if (c >= n_vec) break;
      if (active) {
#pragma unroll
        for (int j = 0; j < kVectors; ++j)
          if (c + j * G + g < n_vec) buf[j] = __ldg(row + c + j * G + g);
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      picked += __shfl_xor_sync(0xffffffffu, picked, off);
      lse_merge(mx, s, m2, s2);
    }
    if (active && g == 0) {
      const float l = (mx - picked) + logf(fmaxf(s, 1e-30f));
      const float score = logf(fmaxf(pi_m, 1e-30f)) - l;
      if constexpr (kStageOut) {
        const int m = r / tile;
        const int64_t o = static_cast<int64_t>(t0 + r - m * tile) * M + m;
        ell[o] = l;
        lam[o] = score;
      } else {
        s_ell[r] = l;
        s_score[r] = score;
      }
    }
    r += n_teams;
    start_row();
  }
  __syncthreads();

  if constexpr (kStageOut) {
    // softmax over the M components, one warp per token, 32 at a time
    const int warp = tid / 32, lane = tid % 32;
    for (int tl = warp; tl < n_tok; tl += blockDim.x / 32) {
      float* row = lam + static_cast<int64_t>(t0 + tl) * M;
      float mx = -INFINITY;
      for (int m = lane; m < M; m += 32) mx = fmaxf(mx, row[m]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int m = lane; m < M; m += 32) sum += expf(row[m] - mx);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int m = lane; m < M; m += 32) row[m] = expf(row[m] - mx) / sum;
    }
  } else if (tid < n_tok) {
    // softmax over the M components, one thread per token
    float mx = -INFINITY;
    for (int m = 0; m < M; ++m) mx = fmaxf(mx, s_score[m * tile + tid]);
    float sum = 0.f;
    for (int m = 0; m < M; ++m) {
      const float e = expf(s_score[m * tile + tid] - mx);
      s_score[m * tile + tid] = e;
      sum += e;
    }
    const int64_t o = static_cast<int64_t>(t0 + tid) * M;
    for (int m = 0; m < M; ++m) {
      lam[o + m] = s_score[m * tile + tid] / sum;
      ell[o + m] = s_ell[m * tile + tid];
    }
  }
}

template <typename T, int G, int VB>
int launch(const float* pi, const void* logits, const int64_t* labels,
           float* lam, float* ell, int M, int T_, int V, int tile,
           int threads, cudaStream_t st) {
  const int grid = (T_ + tile - 1) / tile;
  if (static_cast<long long>(tile) * M > kMaxThreads)
    em_posterior_kernel<T, G, VB, true><<<grid, threads, 0, st>>>(
        pi, static_cast<const T*>(logits), labels, lam, ell, M, T_, V, tile);
  else
    em_posterior_kernel<T, G, VB, false><<<grid, threads, 0, st>>>(
        pi, static_cast<const T*>(logits), labels, lam, ell, M, T_, V, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_vb(int vb, const float* pi, const void* logits,
              const int64_t* labels, float* lam, float* ell, int M, int T_,
              int V, int tile, int threads, cudaStream_t st) {
  switch (vb) {
    case 16:
      return launch<T, G, 16>(pi, logits, labels, lam, ell, M, T_, V, tile,
                              threads, st);
    case 8:
      return launch<T, G, 8>(pi, logits, labels, lam, ell, M, T_, V, tile,
                             threads, st);
    case 4:
      return launch<T, G, 4>(pi, logits, labels, lam, ell, M, T_, V, tile,
                             threads, st);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, G, 2>(pi, logits, labels, lam, ell, M, T_, V, tile,
                               threads, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int G = 1>
int launch_team(int team, int vb, const float* pi, const void* logits,
                const int64_t* labels, float* lam, float* ell, int M, int T_,
                int V, int tile, int threads, cudaStream_t st) {
  if (team == G)
    return launch_vb<T, G>(vb, pi, logits, labels, lam, ell, M, T_, V, tile,
                           threads, st);
  if constexpr (G < 32)
    return launch_team<T, 2 * G>(team, vb, pi, logits, labels, lam, ell, M,
                                 T_, V, tile, threads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The tuning the wrapper plans with: vectors a lane holds a chunk, and a
// block's threads (and the rows a tile stages in shared memory) at most.
extern "C" void em_posterior_limits(int* vectors, int* max_threads) {
  *vectors = kVectors;
  *max_threads = kMaxThreads;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan the kernel does not take.
// logits: (M, T, V) contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// pi: (M,) fp32; labels: (T,) int64 in [0, V); lam, ell: (T, M) fp32.
// The plan comes from the wrapper (em_posterior.plan): team lanes a row
// (1, 2, ..., 32), vec_bytes dividing the logits' address and V's bytes,
// tile tokens a block, and threads a block (a multiple of 32, at least
// tile, at most kMaxThreads). Any M >= 1: a tile of more than kMaxThreads
// rows stages in lam and ell.
extern "C" int em_posterior_launch(const void* pi, const void* logits,
                                   const void* labels, void* lam, void* ell,
                                   int M, int T, int V, int is_bf16, int team,
                                   int vec_bytes, int tile, int threads,
                                   void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if (M < 1 || T < 1 || V < 1 || tile < 1 || tile > threads ||
      threads % 32 != 0 ||
      threads > kMaxThreads || vec_bytes < elem ||
      V % (vec_bytes / elem) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pi);
  const int64_t* y = static_cast<const int64_t*>(labels);
  float* l = static_cast<float*>(lam);
  float* c = static_cast<float*>(ell);
  if (is_bf16)
    return launch_team<__nv_bfloat16>(team, vec_bytes, p, logits, y, l, c, M,
                                      T, V, tile, threads, st);
  return launch_team<float>(team, vec_bytes, p, logits, y, l, c, M, T, V,
                            tile, threads, st);
}
