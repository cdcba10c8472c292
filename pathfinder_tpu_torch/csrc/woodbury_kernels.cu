// Woodbury sample+logq (B1) and whiten+sumsq (B2) kernels for Hopper (sm_90a).
//
// They replace the two Pallas TPU kernels of the JAX package,
// pathfinder_tpu/ops/pallas/woodbury_kernels.py at commit c548d16^:
//   B1  _sample_kernel  (pl.pallas_call at :96)
//       x = a½ ∘ (u + X (C (Xᵀ u))) + μ  and  logq = −(d·log2π + logdet + ‖u‖²)/2
//   B2  _whiten_kernel  (pl.pallas_call at :167)
//       v = (x − μ)/a½,  w = v + X (Ci (Xᵀ v)),  maha = ‖w‖²
// per column of a (d, N) block, for a batch of B independent factors.
//
// What bounds them: each element of u (or x) is read once and, for B1,
// written once (8 bytes), against about 4m flops (two skinny products with
// m = 12 on the main path): roughly 4 flops per byte, far below the card's
// balance point, so the kernels are memory- and latency-bound. The TPU
// kernels tiled the draw axis N into 128-wide blocks, but on the main path
// N is 5 or 10, so here the parallelism comes from the batch (one thread
// block per factor) and from d (threads stride over the rows):
//   pass 1: each thread accumulates its rows' share of Xᵀu (m × NT) and
//           ‖u‖² (NT) in registers; warp shuffles, then one fixed-order sum
//           over warps in shared memory, reduce them;
//   core:   s = C t, an (m × m)·(m × NT) product in shared memory;
//   pass 2: the same rows again (now in L1/L2) to write x = a½(u + X s) + μ,
//           or for B2 to accumulate ‖w‖², reduced like pass 1.
// N is processed in tiles of NT columns. m is capped by the template's MM.
// No atomics: every sum has a fixed order, so results repeat bitwise.
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2Pi = 1.8378770664093453f;

// Sum `vals[0..n)` across the block; the result lands in out[0..n).
// `scratch` holds kWarps * n floats. Ends with __syncthreads().
template <int NV>
__device__ void block_sum(float (&vals)[NV], float* scratch, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float v = vals[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) scratch[warp * NV + k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NV; k += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += scratch[w * NV + k];
    out[k] = acc;
  }
  __syncthreads();
}

// s[k][j] = sum_l M[k, l] t[l][j] for k < m, j < NT (row-major M, m × m).
template <int MM, int NT>
__device__ void small_core(const float* __restrict__ Mb, int m, const float* t, float* s) {
  for (int e = threadIdx.x; e < MM * NT; e += blockDim.x) {
    const int k = e / NT, j = e % NT;
    float acc = 0.f;
    if (k < m)
      for (int l = 0; l < m; ++l) acc += Mb[k * m + l] * t[l * NT + j];
    s[e] = acc;
  }
  __syncthreads();
}

// B1: x = a½ (u + X C Xᵀ u) + μ and logq, one block per batch element.
template <int MM, int NT>
__global__ void __launch_bounds__(kThreads)
sample_logq_kernel(const float* __restrict__ u, const float* __restrict__ a_half,
                   const float* __restrict__ X, const float* __restrict__ C,
                   const float* __restrict__ mu, const float* __restrict__ logdet,
                   float* __restrict__ x, float* __restrict__ logq, int d, int m, int N) {
  __shared__ float scratch[kWarps * (MM * NT + NT)];
  __shared__ float t[MM * NT + NT];
  __shared__ float s[MM * NT];
  const size_t b = blockIdx.x;
  const float* ub = u + b * d * N;
  const float* Xb = X + b * d * m;
  const float* ab = a_half + b * d;
  const float* mb = mu + b * d;
  float* xb = x + b * d * N;

  for (int n0 = 0; n0 < N; n0 += NT) {
    const int nt = min(NT, N - n0);
    float acc[MM * NT + NT];
#pragma unroll
    for (int k = 0; k < MM * NT + NT; ++k) acc[k] = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      float uv[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) uv[j] = (j < nt) ? ub[(size_t)i * N + n0 + j] : 0.f;
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        const float xk = (k < m) ? Xb[(size_t)i * m + k] : 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[k * NT + j] += xk * uv[j];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[MM * NT + j] += uv[j] * uv[j];
    }
    block_sum(acc, scratch, t);  // t[0..MM*NT) = Xᵀu, t[MM*NT..) = ‖u‖²
    small_core<MM, NT>(C + b * m * m, m, t, s);
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      float xs[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) xs[j] = 0.f;
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        const float xk = (k < m) ? Xb[(size_t)i * m + k] : 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) xs[j] += xk * s[k * NT + j];
      }
      const float a = ab[i], mv = mb[i];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) {
          const size_t o = (size_t)i * N + n0 + j;
          xb[o] = a * (ub[o] + xs[j]) + mv;
        }
    }
    if (threadIdx.x < nt)
      logq[b * N + n0 + threadIdx.x] =
          -0.5f * ((float)d * kLog2Pi + logdet[b] + t[MM * NT + threadIdx.x]);
    __syncthreads();  // t and s are rewritten by the next tile
  }
}

// B2: maha = ‖v + X Ci Xᵀ v‖², v = (x − μ)/a½, one block per batch element.
template <int MM, int NT>
__global__ void __launch_bounds__(kThreads)
whiten_sumsq_kernel(const float* __restrict__ x, const float* __restrict__ a_half,
                    const float* __restrict__ X, const float* __restrict__ Ci,
                    const float* __restrict__ mu, float* __restrict__ maha,
                    int d, int m, int N) {
  __shared__ float scratch[kWarps * MM * NT];
  __shared__ float t[MM * NT];
  __shared__ float s[MM * NT];
  const size_t b = blockIdx.x;
  const float* xb = x + b * d * N;
  const float* Xb = X + b * d * m;
  const float* ab = a_half + b * d;
  const float* mb = mu + b * d;

  for (int n0 = 0; n0 < N; n0 += NT) {
    const int nt = min(NT, N - n0);
    float acc[MM * NT];
#pragma unroll
    for (int k = 0; k < MM * NT; ++k) acc[k] = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float a = ab[i], mv = mb[i];
      float v[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) v[j] = (j < nt) ? (xb[(size_t)i * N + n0 + j] - mv) / a : 0.f;
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        const float xk = (k < m) ? Xb[(size_t)i * m + k] : 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[k * NT + j] += xk * v[j];
      }
    }
    block_sum(acc, scratch, t);  // t = Xᵀv
    small_core<MM, NT>(Ci + b * m * m, m, t, s);
    float sq[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) sq[j] = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float a = ab[i], mv = mb[i];
      float w[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) w[j] = (j < nt) ? (xb[(size_t)i * N + n0 + j] - mv) / a : 0.f;
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        const float xk = (k < m) ? Xb[(size_t)i * m + k] : 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) w[j] += xk * s[k * NT + j];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) sq[j] += w[j] * w[j];
    }
    block_sum(sq, scratch, t);  // t[0..NT) = ‖w‖²
    if (threadIdx.x < nt) maha[b * N + n0 + threadIdx.x] = t[threadIdx.x];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// m <= 16 runs with 8-column tiles, 16 < m <= 32 with 4-column tiles; the
// Python wrapper rejects larger m and empty shapes before calling.
int pf_max_rank() { return 32; }

int pf_sample_logq(const float* u, const float* a_half, const float* X, const float* C,
                   const float* mu, const float* logdet, float* x, float* logq,
                   int B, int d, int m, int N, cudaStream_t stream) {
  if (m <= 16)
    sample_logq_kernel<16, 8><<<B, kThreads, 0, stream>>>(u, a_half, X, C, mu, logdet, x, logq, d, m, N);
  else
    sample_logq_kernel<32, 4><<<B, kThreads, 0, stream>>>(u, a_half, X, C, mu, logdet, x, logq, d, m, N);
  return (int)cudaGetLastError();
}

int pf_whiten_sumsq(const float* x, const float* a_half, const float* X, const float* Ci,
                    const float* mu, float* maha, int B, int d, int m, int N,
                    cudaStream_t stream) {
  if (m <= 16)
    whiten_sumsq_kernel<16, 8><<<B, kThreads, 0, stream>>>(x, a_half, X, Ci, mu, maha, d, m, N);
  else
    whiten_sumsq_kernel<32, 4><<<B, kThreads, 0, stream>>>(x, a_half, X, Ci, mu, maha, d, m, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
