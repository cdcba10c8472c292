// One Hager-Zhang evaluation's state update for every lane of a batched search,
// in one launch, for Hopper (sm_90a).
//
// It replaces no TPU kernel. The JAX package runs the search as a
// lax.while_loop under vmap, which XLA compiles into one program; the port's
// plain version (ops/linesearch.py, _hz_step_torch) runs the same update as
// about 175 eager torch ops on (K,) tensors an evaluation, each costing the
// host more than the card spends on it. This kernel is that update as one
// launch: the Wolfe and approximate-Wolfe tests, the bracket updates, the
// five-stage machine, the three secants with their safeguards, the snapshot
// of the interval, the accepted point and the freeze of lanes that do not run,
// then the copies of the evaluated gradient's row into g_a and g_acc where the
// lane takes it, the next trial point x + c p of every lane, and the flag that
// says whether any lane runs on.
//
// What bounds it: nothing on the card. It reads and writes about 24 values a
// lane and three rows of d (x, p and the trial point; g_c where a row is
// taken), a few microseconds at K = 100, d = 1000; the host's launch is the
// cost. Design: a CTA a lane. Its thread 0 runs the lane's stage machine on
// scalars and hands the next step and the row selects to the CTA through
// shared memory; the CTA's threads then walk the rows. The scalar state of a
// lane is read and written by one thread only, so a launch needs no order
// between CTAs.
//
// Same bits as the plain version. Every lane follows the path the eager ops
// give it: each eager op rounds once to T (float or double), so each is one
// round-to-nearest intrinsic here and nothing contracts into an FMA; a Python
// constant is cast to T as torch casts a scalar operand (static_cast from the
// double; 2*delta - 1 is formed in double by the caller); torch.minimum and
// torch.maximum propagate a NaN operand, and so do minimum() and maximum()
// below; isfinite tests as torch.isfinite does. 16-bit dtypes round
// differently in eager torch (each op in float, then to storage) and take the
// plain version.
//
// The flag: flags[parity] is set by every lane that still runs after this
// evaluation, and flags[parity ^ 1] is cleared by CTA 0 for the next launch,
// which sets it. The host reads flags[parity] once the launch is done.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// rows of the (kFields, K) state tensor (ops/kernels/linesearch_kernels.py:
// FIELDS, then CONSTANTS)
enum Field : int {
  kC, kA, kPhiA, kDphiA, kB, kPhiB, kDphiB, kA0, kB0, kPhiA0, kDphiA0, kPhiB0, kDphiB0, kAAcc,
  kPhiAcc, kF0, kDphi0, kEpsK, kFields
};

// the stage machine (ops/linesearch.py: _HZ_BRACKET ... _HZ_DONE)
enum Stage : int64_t { kBracket = 0, kU3 = 1, kSecant1 = 2, kSecant2 = 3, kBisectG = 4, kDone = 5 };

constexpr int kThreads = 256;

// one rounding an eager op
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float absval(float a) { return fabsf(a); }
__device__ __forceinline__ double absval(double a) { return fabs(a); }

// torch.minimum / torch.maximum: a NaN operand is the result
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  return a != a ? a : b != b ? b : (a < b ? a : b);
}
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return a != a ? a : b != b ? b : (a > b ? a : b);
}

// ops/linesearch.py _secant: the root of the linear interpolant of phi' on
// [a, b], the midpoint where it is not finite or the slopes are too close
template <typename T>
__device__ __forceinline__ T secant(T a, T dphi_a, T b, T dphi_b) {
  const T denom = sub(dphi_b, dphi_a);
  const T c = quo(sub(mul(a, dphi_b), mul(b, dphi_a)), denom);
  const bool ok = isfinite(c) && absval(denom) > static_cast<T>(1e-32);
  return ok ? c : mul(static_cast<T>(0.5), add(a, b));
}

struct Consts {
  double delta, sigma, approx, gamma, theta, expand;  // approx = 2 delta - 1
  int max_evals;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
hz_step_kernel(T* __restrict__ st, int64_t* __restrict__ ist, bool* __restrict__ accepted,
               T* __restrict__ g_a, T* __restrict__ g_acc, const T* __restrict__ phi_c,
               const T* __restrict__ dphi_c, const T* __restrict__ g_c,
               const T* __restrict__ x, const T* __restrict__ p, T* __restrict__ x_next,
               int* __restrict__ flags, int parity, int K, int d, Consts q) {
  __shared__ T step_s;  // the lane's next (or kept) trial step
  __shared__ int take_s;  // bit 0: g_a takes g_c's row; bit 1: g_acc does
  const int k = blockIdx.x;
  if (threadIdx.x == 0) {
    T* s = st + k;  // field f of lane k at s[f * K]
    const T c = s[kC * K];
    const int64_t stage = ist[k];
    const int64_t nev = ist[K + k];
    const bool running = stage != kDone && nev < q.max_evals;
    T step = c;
    int take = 0;
    bool more = false;
    if (running) {
      const T a = s[kA * K], phi_a = s[kPhiA * K], dphi_a = s[kDphiA * K];
      const T b = s[kB * K], phi_b = s[kPhiB * K], dphi_b = s[kDphiB * K];
      const T a0 = s[kA0 * K], b0 = s[kB0 * K];
      const T dphi_a0 = s[kDphiA0 * K], dphi_b0 = s[kDphiB0 * K];
      const T f0 = s[kF0 * K], dphi0 = s[kDphi0 * K], eps_k = s[kEpsK * K];
      const T phi = phi_c[k], dphi = dphi_c[k];
      const T zero = static_cast<T>(0);

      const bool bad = !(isfinite(phi) && isfinite(dphi));
      const T f0_eps = add(f0, eps_k);
      const T curv = mul(static_cast<T>(q.sigma), dphi0);
      const bool wolfe =
          phi <= add(f0, mul(mul(static_cast<T>(q.delta), c), dphi0)) && dphi >= curv;
      const bool approx =
          phi <= f0_eps && dphi >= curv && dphi <= mul(static_cast<T>(q.approx), dphi0);
      const bool accept = !bad && c > zero && (wolfe || approx);

      const bool upd_b = !bad && dphi >= zero;
      const bool upd_a = !bad && !upd_b && phi <= f0_eps;
      const bool upd_u3 = !bad && !upd_b && !upd_a;
      const bool in_sec1 = stage == kSecant1;
      const bool in_sec2 = stage == kSecant2 || stage == kBisectG;

      const T new_a = upd_a ? c : a;
      const T new_phi_a = upd_a ? phi : phi_a;
      const T new_dphi_a = upd_a ? dphi : dphi_a;
      const bool move_b = upd_b || upd_u3;
      const T new_b = move_b ? c : b;
      const T new_phi_b = move_b ? phi : phi_b;
      const T new_dphi_b = move_b ? dphi : dphi_b;

      const T width_new = absval(sub(new_b, new_a));
      const bool gamma_ok = width_new <= mul(static_cast<T>(q.gamma), absval(sub(b0, a0)));

      int64_t next;
      if (bad) {
        next = stage;
      } else if (stage == kBracket) {
        next = upd_b ? kSecant1 : upd_a ? kBracket : kU3;
      } else if (stage == kU3) {
        next = upd_b ? kSecant1 : kU3;
      } else if (upd_u3) {
        next = kU3;
      } else if (in_sec1) {
        next = kSecant2;
      } else {
        next = gamma_ok ? kSecant1 : kBisectG;
      }
      if (accept) next = kDone;

      const T mid = add(new_a, mul(static_cast<T>(q.theta), sub(new_b, new_a)));
      const T sec = secant(new_a, new_dphi_a, new_b, new_dphi_b);
      const T sec2 = upd_b ? secant(b0, dphi_b0, new_b, new_dphi_b)
                           : secant(a0, dphi_a0, new_a, new_dphi_a);
      const T lo = minimum(new_a, new_b), hi = maximum(new_a, new_b);
      const T sec_safe = sec > lo && sec < hi ? sec : mid;
      const T sec2_safe = sec2 > lo && sec2 < hi ? sec2 : mid;
      if (bad) {
        step = add(a, mul(static_cast<T>(0.3), sub(c, a)));  // back toward the low end
      } else if (next == kBracket) {
        step = mul(c, static_cast<T>(q.expand));
      } else if (next == kU3 || next == kBisectG) {
        step = mid;
      } else if (next == kSecant2) {
        step = sec2_safe;
      } else {
        step = sec_safe;
      }

      // the interval at entry to a secant^2 cycle, refreshed when a cycle restarts
      const bool snap = (next == kSecant1 && !in_sec1) || (in_sec2 && next == kSecant1);
      ist[k] = next;
      ist[K + k] = nev + 1;
      s[kC * K] = step;
      s[kA * K] = new_a;
      s[kPhiA * K] = new_phi_a;
      s[kDphiA * K] = new_dphi_a;
      s[kB * K] = new_b;
      s[kPhiB * K] = new_phi_b;
      s[kDphiB * K] = new_dphi_b;
      if (snap) {
        s[kA0 * K] = new_a;
        s[kB0 * K] = new_b;
        s[kPhiA0 * K] = new_phi_a;
        s[kDphiA0 * K] = new_dphi_a;
        s[kPhiB0 * K] = new_phi_b;
        s[kDphiB0 * K] = new_dphi_b;
      }
      if (accept) {
        s[kAAcc * K] = c;
        s[kPhiAcc * K] = phi;
        accepted[k] = true;
      }
      take = (upd_a ? 1 : 0) | (accept ? 2 : 0);
      more = next != kDone && nev + 1 < q.max_evals;
    }
    if (more) flags[parity] = 1;
    if (k == 0) flags[parity ^ 1] = 0;
    step_s = step;
    take_s = take;
  }
  __syncthreads();
  const T step = step_s;
  const int take = take_s;
  const size_t row = static_cast<size_t>(k) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const size_t i = row + j;
    x_next[i] = add(x[i], mul(step, p[i]));
    if (take) {
      const T g = g_c[i];
      if (take & 1) g_a[i] = g;
      if (take & 2) g_acc[i] = g;
    }
  }
}

template <typename T>
int launch(void* st, void* ist, void* accepted, void* g_a, void* g_acc, const void* phi_c,
           const void* dphi_c, const void* g_c, const void* x, const void* p, void* x_next,
           void* flags, int parity, int K, int d, Consts q, cudaStream_t stream) {
  hz_step_kernel<T><<<K, kThreads, 0, stream>>>(
      static_cast<T*>(st), static_cast<int64_t*>(ist), static_cast<bool*>(accepted),
      static_cast<T*>(g_a), static_cast<T*>(g_acc), static_cast<const T*>(phi_c),
      static_cast<const T*>(dphi_c), static_cast<const T*>(g_c), static_cast<const T*>(x),
      static_cast<const T*>(p), static_cast<T*>(x_next), static_cast<int*>(flags), parity, K, d,
      q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pf_hz_fields() { return kFields; }

// dtype: 0 float32, 1 float64 (the woodbury sources' codes); -1 for another
int pf_hz_step(int dtype, void* st, void* ist, void* accepted, void* g_a, void* g_acc,
               const void* phi_c, const void* dphi_c, const void* g_c, const void* x,
               const void* p, void* x_next, void* flags, int parity, int K, int d, int max_evals,
               double delta, double sigma, double approx, double gamma, double theta,
               double expand, cudaStream_t stream) {
  const Consts q{delta, sigma, approx, gamma, theta, expand, max_evals};
  if (dtype == 0)
    return launch<float>(st, ist, accepted, g_a, g_acc, phi_c, dphi_c, g_c, x, p, x_next, flags,
                         parity, K, d, q, stream);
  if (dtype == 1)
    return launch<double>(st, ist, accepted, g_a, g_acc, phi_c, dphi_c, g_c, x, p, x_next, flags,
                          parity, K, d, q, stream);
  return -1;
}

}  // extern "C"
