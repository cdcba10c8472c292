// Woodbury sample+logq (B1) and whiten+sumsq (B2) for any rank and any float
// dtype, for Hopper (sm_90a): the general kernel beside the fast one.
//
// It replaces the same two Pallas TPU kernels as woodbury_kernels.cu,
// pathfinder_tpu/ops/pallas/woodbury_kernels.py at commit c548d16^:
//   B1  _sample_kernel  (:70, pl.pallas_call at :96)
//   B2  _whiten_kernel  (:146, pl.pallas_call at :167)
// for every case that the fast kernel (float32, rank m <= 32) does not take:
// storage dtype T in {float16, bfloat16, float32, float64} and any rank m >= 0.
// The TPU kernels accumulated in promote_types(dtype, float32); so does this
// one, in Acc = double for float64 and float otherwise:
//   - every input is read in T and converted to Acc once;
//   - X^T v, C (X^T v), X s, ||u||^2 and ||w||^2 are computed in Acc;
//   - the outputs x, logq and maha are rounded to T once.
//
// What bounds it: bytes, as for the fast kernel (each factor's slab, X, a½
// and μ read once, x written once; a few flops a byte). This kernel is the
// simple design, written to be right for every case first:
//
//   grid      one CTA per (factor, column tile of nt <= 16 columns), 256
//             threads; a grid-stride loop over the column tiles where there
//             are more than a grid's 65535 rows.
//   pass 1    the factor's rows are walked in tiles of `rows` rows, each
//             staged in shared memory in Acc (X with a row stride of m + 1,
//             so that neighbouring rank columns and rows fall in other
//             banks; v, a½ and μ); B2 whitens v = (x − μ)/a½ there. Thread
//             (g, k, j) sums X[i, k] v[i, j] over the rows i ≡ g (mod G) of
//             every tile into its own slot; the G partials are then summed in
//             order into t = X^T v (m × nt).
//   pass 2    s = M t (M = C for B1, Ci for B2), M read in panels of pk rows
//             through shared memory, each panel transposed so that
//             neighbouring threads read neighbouring words.
//   pass 3    the rows again (kept from pass 1 where one tile holds them all):
//             thread (r, j) forms r = v + X s for its rows and column j; B1
//             writes x = a½ r + μ and sums u², B2 sums r². The per-thread sums
//             are added in thread order.
//   memory    t, s and the pass-1 partials are m × nt values each. The plan
//             halves nt until they fit beside a tile of rows; where even
//             nt = 1 does not fit, they live in a global workspace the
//             wrapper allocates, one slice a CTA. No rank is refused short of
//             one row of X (m + 1 values) overflowing shared memory.
//   order     every sum runs in a fixed order and no atomics are used, so a
//             launch repeats bit for bit.
//
// Plain C interface, loaded with ctypes. The Python wrapper computes the plan
// (threads, nt, rows, pk, shared memory bytes, workspace or not); the entry
// points check it against the layout below, return -1 if they disagree, and
// otherwise the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxColTile = 16;
constexpr int kMaxSmem = 232448;
constexpr double kLog2Pi = 1.8378770664093453;
// the kernel's modes: B1, B2 with a block of columns per factor, B2 with one
// block of columns shared by all factors (x given in the (P, d) layout)
constexpr int kSample = 0, kWhiten = 1, kWhitenShared = 2;
// dtype codes of the entry points (ops/kernels/woodbury_kernels.py mirrors them)
constexpr int kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3;

// the accumulation type of a storage type, and the one rounding back to it
template <typename T>
struct Num;
template <>
struct Num<float> {
  using Acc = float;
  __device__ static float narrow(float v) { return v; }
};
template <>
struct Num<double> {
  using Acc = double;
  __device__ static double narrow(double v) { return v; }
};
template <>
struct Num<__half> {
  using Acc = float;
  __device__ static __half narrow(float v) { return __float2half_rn(v); }
};
template <>
struct Num<__nv_bfloat16> {
  using Acc = float;
  __device__ static __nv_bfloat16 narrow(float v) { return __float2bfloat16_rn(v); }
};

__device__ inline float widen(float v) { return v; }
__device__ inline double widen(double v) { return v; }
__device__ inline float widen(__half v) { return __half2float(v); }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ inline float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ inline double mad(double a, double b, double c) { return fma(a, b, c); }

// Offsets, in Acc values, into the dynamic shared memory. With a workspace
// (ws) t, s and the pass-1 partials live in global memory instead.
// ops/kernels/woodbury_kernels.py (_general_layout) mirrors this layout.
struct GLayout {
  int t, s, tp, qp, panel, sx, sv, sa, smu, total;
  __host__ __device__ GLayout(int m, int nt, int rows, int pk, int threads, int ws) {
    const int p = m * nt;
    const int g = p > 0 && p < threads ? threads / p : 1;
    int o = 0;
    t = o;     o += (1 - ws) * p;          // X^T v, column-major: t[j·m + k]
    s = o;     o += (1 - ws) * p;          // M X^T v, the same layout
    tp = o;    o += (1 - ws) * g * p;      // pass-1 partials, one set per row group
    qp = o;    o += threads;               // pass-3 partials, one per thread
    panel = o; o += pk * m;                // a panel of M, transposed
    sx = o;    o += rows * (m + 1);        // a tile of X rows
    sv = o;    o += rows * nt;             // the tile's v (u for B1)
    sa = o;    o += rows;                  // its a½
    smu = o;   o += rows;                  // its μ
    total = o;
  }
};

// The row groups G of pass 1: with fewer (k, j) pairs than threads, G sets of
// them split the rows.
__host__ __device__ inline int row_groups(int p, int threads) {
  return p > 0 && p < threads ? threads / p : 1;
}

// One CTA per (factor b = blockIdx.x, column tile); the columns [col0, col0 +
// nc) of the factor's N (B1/B2) or of the shared x's N = P columns.
// in: u (B1) or x (B2), (B, d, N); with kWhitenShared x in the (P, d) layout.
// M: C (B1) or Ci (B2). logdet and x_out for B1 only. col_out: logq (B1) or
// maha (B2), (B, N).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
general_kernel(const T* __restrict__ in, const T* __restrict__ a_half, const T* __restrict__ X,
               const T* __restrict__ M, const T* __restrict__ mu, const T* __restrict__ logdet,
               T* __restrict__ x_out, T* __restrict__ col_out, int d, int m, int N, int nt,
               int rows, int pk, typename Num<T>::Acc* __restrict__ ws) {
  using Acc = typename Num<T>::Acc;
  constexpr bool SAMPLE = MODE == kSample;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* sm = reinterpret_cast<Acc*>(smem_raw);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const GLayout L(m, nt, rows, pk, nthr, ws != nullptr);
  const int P = m * nt, G = row_groups(P, nthr);
  const size_t b = blockIdx.x;
  Acc *t = sm + L.t, *s = sm + L.s, *tp = sm + L.tp;
  if (ws != nullptr) {
    Acc* w = ws + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                      static_cast<size_t>(2 * P + G * P);
    t = w;
    s = w + P;
    tp = w + 2 * P;
  }
  Acc *qp = sm + L.qp, *panel = sm + L.panel, *sx = sm + L.sx, *sv = sm + L.sv;
  Acc *sa = sm + L.sa, *smu = sm + L.smu;
  const int ldx = m + 1;
  const T* Xb = X + b * d * m;
  const T* Mb = M + b * m * m;
  const T* ab = a_half + b * d;
  const T* mub = mu + b * d;
  const T* inb = MODE == kWhitenShared ? in : in + b * d * N;
  const int ntiles = (N + nt - 1) / nt;
  // one tile holds every row: pass 3 reuses what pass 1 staged
  const bool resident = m > 0 && d <= rows;

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int col0 = tile * nt;
    const int nc = min(nt, N - col0);

    // Stage rows [i0, i0 + n): X, v (zero in the columns j >= nc), a½, μ,
    // all in Acc; B2 whitens v in place.
    auto stage = [&](int i0, int n) {
      __syncthreads();  // earlier readers of the tile are done
      for (int e = tid; e < n * m; e += nthr) {
        const int r = e / m, k = e - r * m;
        sx[r * ldx + k] = widen(Xb[static_cast<size_t>(i0 + r) * m + k]);
      }
      for (int r = tid; r < n; r += nthr) {
        sa[r] = widen(ab[i0 + r]);
        smu[r] = widen(mub[i0 + r]);
      }
      if (MODE == kWhitenShared) {
        for (int e = tid; e < n * nt; e += nthr) {  // rows fastest: a column is contiguous
          const int j = e / n, r = e - j * n;
          sv[r * nt + j] = j < nc ? widen(inb[static_cast<size_t>(col0 + j) * d + i0 + r]) : Acc(0);
        }
      } else {
        for (int e = tid; e < n * nt; e += nthr) {  // columns fastest: a row is contiguous
          const int r = e / nt, j = e - r * nt;
          sv[r * nt + j] = j < nc ? widen(inb[static_cast<size_t>(i0 + r) * N + col0 + j]) : Acc(0);
        }
      }
      __syncthreads();
      if (MODE != kSample) {  // v = (x − μ)/a½
        for (int e = tid; e < n * nt; e += nthr) {
          const int r = e / nt, j = e - r * nt;
          if (j < nc) sv[e] = (sv[e] - smu[r]) / sa[r];
        }
        __syncthreads();
      }
    };

    if (m > 0) {
      // pass 1: t = X^T v; slot e = (g, j, k) is its one thread's own
      for (int e = tid; e < G * P; e += nthr) tp[e] = Acc(0);
      for (int i0 = 0; i0 < d; i0 += rows) {
        const int n = min(rows, d - i0);
        stage(i0, n);
        for (int e = tid; e < G * P; e += nthr) {
          const int g = e / P, p = e - g * P, j = p / m, k = p - j * m;
          Acc acc = tp[e];
          for (int r = g; r < n; r += G) acc = mad(sx[r * ldx + k], sv[r * nt + j], acc);
          tp[e] = acc;
        }
      }
      __syncthreads();
      for (int p = tid; p < P; p += nthr) {
        Acc acc = Acc(0);
        for (int g = 0; g < G; ++g) acc += tp[g * P + p];
        t[p] = acc;
      }
      __syncthreads();
      // pass 2: s = M t, M in panels of pk rows, transposed in shared memory
      for (int k0 = 0; k0 < m; k0 += pk) {
        const int kn = min(pk, m - k0);
        for (int e = tid; e < kn * m; e += nthr) {
          const int kk = e / m, l = e - kk * m;
          panel[l * kn + kk] = widen(Mb[static_cast<size_t>(k0 + kk) * m + l]);
        }
        __syncthreads();
        for (int e = tid; e < kn * nt; e += nthr) {
          const int j = e / kn, kk = e - j * kn;
          Acc acc = Acc(0);
          for (int l = 0; l < m; ++l) acc = mad(panel[l * kn + kk], t[j * m + l], acc);
          s[j * m + k0 + kk] = acc;
        }
        __syncthreads();
      }
    }

    // pass 3: thread (rl, j) takes column j and the rows rl, rl + rstep, ...
    const int j = tid % nt, rl = tid / nt, rstep = nthr / nt;
    Acc q = Acc(0);
    for (int i0 = 0; i0 < d; i0 += rows) {
      const int n = min(rows, d - i0);
      if (!resident) stage(i0, n);
      if (j < nc)
        for (int r = rl; r < n; r += rstep) {
          const Acc v = sv[r * nt + j];
          Acc xs = Acc(0);
          for (int k = 0; k < m; ++k) xs = mad(sx[r * ldx + k], s[j * m + k], xs);
          if (SAMPLE) {
            q = mad(v, v, q);
            const Acc xv = sa[r] * (v + xs) + smu[r];
            x_out[(b * d + i0 + r) * N + col0 + j] = Num<T>::narrow(xv);
          } else {
            const Acc w = v + xs;
            q = mad(w, w, q);
          }
        }
    }
    qp[tid] = q;
    __syncthreads();
    if (tid < nc) {
      Acc total = Acc(0);
      for (int c = 0; c < rstep; ++c) total += qp[c * nt + tid];
      const Acc out = SAMPLE ? Acc(-0.5) * (Acc(d) * Acc(kLog2Pi) + widen(logdet[b]) + total) : total;
      col_out[b * N + col0 + tid] = Num<T>::narrow(out);
    }
    __syncthreads();  // qp and the tile are free for the next column tile
  }
}

struct GPlan {
  int threads, nt, rows, pk, smem;
};

// The plan the wrapper computed, checked against this file's layout.
template <typename Acc>
bool plan_ok(const GPlan& p, int B, int d, int m, int N, bool ws) {
  if (B < 1 || d < 1 || m < 0 || N < 1) return false;
  if (p.threads != kThreads || p.nt < 1 || p.nt > kMaxColTile || (p.nt & (p.nt - 1))) return false;
  if (p.rows < 1 || p.rows > d || p.pk < 1 || p.smem > kMaxSmem) return false;
  const GLayout L(m, p.nt, p.rows, p.pk, p.threads, ws ? 1 : 0);
  return static_cast<long long>(p.smem) == static_cast<long long>(L.total) * sizeof(Acc);
}

template <typename T, int MODE>
int launch(const GPlan& p, int B, const void* in, const void* a_half, const void* X, const void* M,
           const void* mu, const void* logdet, void* x_out, void* col_out, int d, int m, int N,
           void* ws, cudaStream_t stream) {
  using Acc = typename Num<T>::Acc;
  if (!plan_ok<Acc>(p, B, d, m, N, ws != nullptr)) return -1;
  auto kernel = general_kernel<T, MODE>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const int ntiles = (N + p.nt - 1) / p.nt;
  const dim3 grid(B, ntiles < 65535 ? ntiles : 65535);
  general_kernel<T, MODE><<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(in), static_cast<const T*>(a_half), static_cast<const T*>(X),
      static_cast<const T*>(M), static_cast<const T*>(mu), static_cast<const T*>(logdet),
      static_cast<T*>(x_out), static_cast<T*>(col_out), d, m, N, p.nt, p.rows, p.pk,
      static_cast<Acc*>(ws));
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch(int dtype, const GPlan& p, int B, const void* in, const void* a_half, const void* X,
             const void* M, const void* mu, const void* logdet, void* x_out, void* col_out, int d,
             int m, int N, void* ws, cudaStream_t stream) {
  switch (dtype) {
    case kF32:
      return launch<float, MODE>(p, B, in, a_half, X, M, mu, logdet, x_out, col_out, d, m, N, ws, stream);
    case kF64:
      return launch<double, MODE>(p, B, in, a_half, X, M, mu, logdet, x_out, col_out, d, m, N, ws, stream);
    case kF16:
      return launch<__half, MODE>(p, B, in, a_half, X, M, mu, logdet, x_out, col_out, d, m, N, ws, stream);
    case kBF16:
      return launch<__nv_bfloat16, MODE>(p, B, in, a_half, X, M, mu, logdet, x_out, col_out, d, m, N, ws,
                                         stream);
  }
  return -1;
}

}  // namespace

extern "C" {

int pfg_max_col_tile() { return kMaxColTile; }

int pfg_sample_logq(int dtype, const void* u, const void* a_half, const void* X, const void* C,
                    const void* mu, const void* logdet, void* x, void* logq, int B, int d, int m,
                    int N, int threads, int nt, int rows, int pk, int smem, void* ws,
                    cudaStream_t stream) {
  return dispatch<kSample>(dtype, {threads, nt, rows, pk, smem}, B, u, a_half, X, C, mu, logdet, x,
                           logq, d, m, N, ws, stream);
}

int pfg_whiten_sumsq(int dtype, const void* x, const void* a_half, const void* X, const void* Ci,
                     const void* mu, void* maha, int B, int d, int m, int N, int threads, int nt,
                     int rows, int pk, int smem, void* ws, cudaStream_t stream) {
  return dispatch<kWhiten>(dtype, {threads, nt, rows, pk, smem}, B, x, a_half, X, Ci, mu, nullptr,
                           nullptr, maha, d, m, N, ws, stream);
}

// B2 over a shared x: xt is x in the (P, d) layout, maha is (B, P).
int pfg_whiten_sumsq_shared(int dtype, const void* xt, const void* a_half, const void* X,
                            const void* Ci, const void* mu, void* maha, int B, int d, int m, int P,
                            int threads, int nt, int rows, int pk, int smem, void* ws,
                            cudaStream_t stream) {
  return dispatch<kWhitenShared>(dtype, {threads, nt, rows, pk, smem}, B, xt, a_half, X, Ci, mu,
                                 nullptr, nullptr, maha, d, m, P, ws, stream);
}

}  // extern "C"
