// Two kernels of the batched L-BFGS loop with the Hager-Zhang search, for every lane
// at once, for Hopper (sm_90a): one launch for each Hager-Zhang evaluation's state
// update (hz_step_kernel), and one launch for each L-BFGS iteration's own work
// between the last evaluation of one search and the first of the next
// (lbfgs_iter_kernel, below).
//
// Neither replaces a TPU kernel. The JAX package runs the optimizer and its search
// as lax.while_loops under vmap, which XLA compiles into one program; the port's
// plain versions run the same updates as eager torch ops on (K,) and (K, d)
// tensors, each costing the host more than the card spends on it.
//
// hz_step_kernel replaces ops/linesearch.py's _hz_step_torch, about 175 eager ops
// an evaluation: the Wolfe and approximate-Wolfe tests, the bracket updates, the
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
// launch, and flags[parity ^ 1] is cleared by CTA 0 for the next launch,
// which sets it. The host reads flags[parity] once the launch is done. Both
// kernels take their parity from one count of the search's launches, so they
// share the two slots.

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

// ---------------------------------------------------------------------------
// One L-BFGS iteration's own work, for every lane (lbfgs_iter_kernel).
//
// It replaces the plain iteration of ops/trajectory.py and ops/lbfgs.py, about
// 200 eager ops an iteration. From the search's state as hz_step_kernel left it:
// (1) the search's result (ops/linesearch.py _hz_result) and x + a p;
// (2) the body of minimize_trace on the lanes that ran: the non-finite abort,
//     the iteration count, the trace rows written in place, the gradient-norm
//     and ftol tests, the counts and done;
// (3) the curvature-guarded history update (ops/lbfgs.py _lbfgs_update): the
//     new row of the circular S and Y written in place, pos, hlen, nrej and
//     gilbert_init's diagonal;
// (4) the next iteration's run mask and direction (_lbfgs_direction: the
//     compact two-loop over the chronological window, the descent safeguard,
//     alpha0 with initial_step_size at it == 0);
// (5) the next search's start (_hz_start): its state, the copies of g into
//     g_a and g_acc, its first trial point x + c p, and the flag, set where a
//     lane runs on. A launch in start mode does (4) and (5) from the initial
//     point.
//
// What bounds it: nothing on the card. It reads each lane's S and Y (2 J d
// values) and a few rows of d and writes a few rows, about K (2 J + 8) d values:
// 14 MB at (K, d, J) = (100, 1000, 6) in float64, 4 us at 3.35 TB/s. Its cost is
// the launch.
//
// Design: a CTA a lane, its block following d (64 threads up to d = 256, 512
// above d = 1024). Each thread owns the elements tid + n * blockDim of the
// lane's rows in every elementwise pass, so an element written in place is read
// again by the thread that wrote it or after a barrier. A pass's sums over d
// are one block reduction (warp shuffles, then the warps' partials in warp
// order). The direction's h (h + 1) + 2 h dot products (h the history's
// length) are dealt out to the warps, a warp a dot, and thread 0 solves the two
// h x h triangular systems in shared memory. S and Y are read through L1 (96 KB
// a lane at d = 1000, J = 6, float64), not staged in shared memory.
//
// Bits. The elementwise parts (x + a p, the trace rows, s and y, the merges,
// the trial point) and the integers and booleans are computed as the plain
// version's eager ops compute them, one rounding an op, so they equal it bit for
// bit wherever the sums they depend on agree. The sums over d (the curvature
// test's two, gilbert_init's three, the direction's dots and solves, its descent
// test and dphi0, initial_step_size's |g|^2) run in the kernel's order and differ
// from torch's at rounding level; the maxima (|g|inf, |x|inf) are exact.

constexpr int kMaxHistory = 32;  // the longest history a launch takes
constexpr int kIterMaxThreads = 512;
constexpr int kIterMaxWarps = kIterMaxThreads / 32;
constexpr int kMaxPairs = kMaxHistory * (kMaxHistory + 1) / 2;
constexpr int kMaxDots = 2 * kMaxPairs + 2 * kMaxHistory + 3;
constexpr int kReduced = 5;  // the values of the first pass's block reduction

// rows of the (kLbfgsInts, K) int64 tensor (ops/kernels/linesearch_kernels.py: INTS)
enum LbfgsInt : int { kIt, kNev, kNexh, kPos, kHlen, kNrej, kLbfgsInts };

// one batch of trajectories (ops/kernels/linesearch_kernels.py: _LbfgsArgs)
struct LbfgsArgs {
  void* x;      // (K, d) the iterates
  void* f;      // (K,) the objective there
  void* g;      // (K, d) its gradient there
  void* alpha;  // (K, d) diag H0
  void* S;      // (K, J, d) the circular history
  void* Y;
  void* p;      // (K, d) the search's direction
  void* x_c;    // (K, d) the search's first trial point, written
  void* xs;     // (K, maxiters + 1, d) the trace, in the log-density view
  void* fs;     // (K, maxiters + 1)
  void* gs;     // (K, maxiters + 1, d)
  void* gtol;   // (K,) the effective gtol
  int64_t* ints;  // (kLbfgsInts, K)
  bool* done;   // (K,)
  bool* run;    // (K,) the lanes of the search under way
  void* hz;     // (kFields, K) the search's floats and constants
  int64_t* hz_ints;  // (2, K) its stage and evaluation count
  bool* accepted;
  void* g_a;
  void* g_acc;
  int* flags;
  double ftol_rel, eps_curv, hz_epsilon, psi0;
  int K, d, J, maxiters, fail_nonfinite, parity, start;
};

// the butterfly leaves every lane of the warp with the same bits
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {  // NaN propagates, as in amax
  for (int o = 16; o > 0; o >>= 1) v = maximum(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the CTA's sum of v, the same bits in every thread; red holds a value a warp
template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = static_cast<T>(0);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  __syncthreads();
  return s;
}

__host__ __device__ constexpr int pair_index(int i, int j, int h) {  // (i, j), i <= j
  return i * h - i * (i - 1) / 2 + (j - i);
}

template <typename T>
__global__ void __launch_bounds__(kIterMaxThreads) lbfgs_iter_kernel(const LbfgsArgs q) {
  __shared__ T red[kIterMaxWarps * kReduced];
  __shared__ T dots[kMaxDots];
  __shared__ T w_s[kMaxHistory];
  __shared__ T d2_s[kMaxHistory];
  __shared__ unsigned char pair_i[kMaxPairs], pair_j[kMaxPairs];
  __shared__ T step_s, gil_a_s, gil_b_s, gil_aoc_s, alpha0_s;
  __shared__ int gsel_s, act_s, slot_s, h_s, first_s, it0_s;
  __shared__ long long row_s;

  const int K = q.K, d = q.d, J = q.J, k = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = nt >> 5;
  const size_t row = static_cast<size_t>(k) * d;
  T* x = static_cast<T*>(q.x) + row;
  T* g = static_cast<T*>(q.g) + row;
  T* alpha = static_cast<T*>(q.alpha) + row;
  T* p = static_cast<T*>(q.p) + row;
  T* x_c = static_cast<T*>(q.x_c) + row;
  T* g_a = static_cast<T*>(q.g_a) + row;
  T* g_acc = static_cast<T*>(q.g_acc) + row;
  T* S = static_cast<T*>(q.S) + row * J;
  T* Y = static_cast<T*>(q.Y) + row * J;
  T* hz = static_cast<T*>(q.hz) + k;  // field f of the lane at hz[f * K]
  int64_t* ints = q.ints + k;         // entry i of the lane at ints[i * K]
  T& f = static_cast<T*>(q.f)[k];
  const T zero = static_cast<T>(0), one = static_cast<T>(1);

  if (!q.start) {
    // (1) the search's result: the accepted point, else the low endpoint if it
    // decreased f, else no step (thread 0's registers, kept across the barriers)
    bool ok = false, exhausted = false;
    T f_new = zero;
    if (tid == 0) {
      const bool acc = q.accepted[k];
      const T f0 = hz[kF0 * K], a = hz[kA * K], phi_a = hz[kPhiA * K];
      const bool fallback = a > zero && isfinite(phi_a) && phi_a < f0;
      ok = acc || fallback;
      exhausted = fallback && !acc;
      f_new = acc ? hz[kPhiAcc * K] : fallback ? phi_a : f0;
      step_s = acc ? hz[kAAcc * K] : fallback ? a : zero;
      gsel_s = acc ? 2 : fallback ? 1 : 0;
    }
    __syncthreads();
    const T step = step_s;
    const int gsel = gsel_s;
    const T* g_new = gsel == 2 ? g_acc : gsel == 1 ? g_a : g;

    // (2), (3): the first pass's sums, the decisions, then the rows
    T sy = zero, yy = zero, yay = zero, sas = zero, gmax = zero;
    bool nonfinite = false;
    for (int j = tid; j < d; j += nt) {
      const T xo = x[j];
      const T s = sub(add(xo, mul(step, p[j])), xo);
      const T gn = g_new[j];
      const T y = sub(gn, g[j]), al = alpha[j];
      sy += y * s;
      yy += y * y;
      yay += mul(y, al) * y;
      sas += quo(s, al) * s;
      gmax = maximum(gmax, absval(gn));
      nonfinite = nonfinite || !isfinite(gn);
    }
    sy = warp_sum(sy);
    yy = warp_sum(yy);
    yay = warp_sum(yay);
    sas = warp_sum(sas);
    gmax = warp_max(gmax);
    if (lane == 0) {
      T* r = red + warp * kReduced;
      r[0] = sy;
      r[1] = yy;
      r[2] = yay;
      r[3] = sas;
      r[4] = gmax;
    }
    const bool any_nonfinite = __syncthreads_or(nonfinite) != 0;
    if (tid == 0) {
      T sum[4] = {zero, zero, zero, zero};
      T ginf = zero;
      for (int w = 0; w < nw; ++w) {
        for (int i = 0; i < 4; ++i) sum[i] += red[w * kReduced + i];
        ginf = maximum(ginf, red[w * kReduced + 4]);
      }
      const bool run = q.run[k];
      const int64_t it = ints[kIt * K];
      const int64_t it_new = ok ? it + 1 : it;
      const bool abort = q.fail_nonfinite != 0 &&
                         (isnan(f_new) || (isinf(f_new) && f_new < zero) || any_nonfinite);
      const bool converged = ginf <= static_cast<const T*>(q.gtol)[k];
      const T ftol = static_cast<T>(q.ftol_rel);
      const bool stalled =
          q.ftol_rel > 0 && ok && sub(f, f_new) <= mul(ftol, add(absval(f_new), ftol));
      const bool accept = ok && sum[0] > mul(static_cast<T>(q.eps_curv), sum[1]);
      int act = 0, slot = 0;
      if (run) {
        ints[kIt * K] = it_new;
        ints[kNev * K] += q.hz_ints[K + k];
        if (exhausted) ints[kNexh * K] += 1;
        if (ok && !accept) ints[kNrej * K] += 1;
        if (accept) {
          const int64_t hlen = ints[kHlen * K] + 1;
          ints[kHlen * K] = hlen < J ? hlen : J;
          if (J > 0) {
            slot = static_cast<int>((ints[kPos * K] + 1) % J);
            ints[kPos * K] = slot;
          }
        }
        q.done[k] = !ok || converged || stalled || (ok && abort);
        if (ok) {
          f = f_new;
          static_cast<T*>(q.fs)[static_cast<size_t>(k) * (q.maxiters + 1) + it_new] = -f_new;
        }
        act = (ok ? 1 : 0) | (accept ? 2 : 0) | (accept && J > 0 ? 4 : 0);
      }
      act_s = act;
      slot_s = slot;
      row_s = it_new;
      gil_a_s = sum[2];
      gil_b_s = sum[0];
      gil_aoc_s = quo(sum[2], sum[3]);
    }
    __syncthreads();
    const int act = act_s;
    if (act != 0) {
      const size_t trace = (static_cast<size_t>(k) * (q.maxiters + 1) + row_s) * d;
      T* xs = static_cast<T*>(q.xs) + trace;
      T* gs = static_cast<T*>(q.gs) + trace;
      T* s_row = S + static_cast<size_t>(slot_s) * d;
      T* y_row = Y + static_cast<size_t>(slot_s) * d;
      const T ga = gil_a_s, gb = gil_b_s, aoc = gil_aoc_s;
      for (int j = tid; j < d; j += nt) {
        const T xo = x[j], xn = add(xo, mul(step, p[j]));
        const T gn = g_new[j];  // g_a or g_acc: a lane that moved took one
        if (act & 2) {
          const T s = sub(xn, xo), y = sub(gn, g[j]), al = alpha[j];
          const T t = quo(s, al);  // gilbert_init
          alpha[j] = quo(gb, sub(add(quo(ga, al), mul(y, y)), mul(aoc, mul(t, t))));
          if (act & 4) {
            s_row[j] = s;
            y_row[j] = y;
          }
        }
        if (act & 1) {
          xs[j] = xn;
          gs[j] = -gn;
          x[j] = xn;
          g[j] = gn;
        }
      }
    }
    __syncthreads();
  }

  // (4) the next iteration: its run mask, the history's window
  if (tid == 0) {
    const int64_t it = ints[kIt * K];
    q.run[k] = !q.done[k] && it < q.maxiters;
    const int64_t hlen = ints[kHlen * K];
    const int h = static_cast<int>(hlen < J ? hlen : J);
    h_s = h;
    first_s = J > 0 ? static_cast<int>(((ints[kPos * K] + 1 - h) % J + J) % J) : 0;
    it0_s = it == 0;
    int n = 0;
    for (int i = 0; i < h; ++i)
      for (int j = i; j < h; ++j) {
        pair_i[n] = static_cast<unsigned char>(i);
        pair_j[n] = static_cast<unsigned char>(j);
        ++n;
      }
  }
  __syncthreads();
  const int h = h_s, first = first_s, npairs = h * (h + 1) / 2;
  const bool it0 = it0_s != 0;
  // chronological row i (oldest first) of the window
  auto hist = [&](const T* base, int i) {
    const int slot = first + i;
    return base + static_cast<size_t>(slot >= J ? slot - J : slot) * d;
  };
  // the dots: S_i.Y_j and Y_i.(alpha Y_j) for i <= j, Y_i.(alpha g), S_i.g, and
  // at it == 0 initial_step_size's |x|inf, |g|inf and |g|^2; a warp a dot
  const int ndots = 2 * npairs + 2 * h + (it0 ? 3 : 0);
  for (int n = warp; n < ndots; n += nw) {
    T acc = zero;
    if (n < npairs) {
      const T* sr = hist(S, pair_i[n]);
      const T* yr = hist(Y, pair_j[n]);
      for (int j = lane; j < d; j += 32) acc += sr[j] * yr[j];
      acc = warp_sum(acc);
    } else if (n < 2 * npairs) {
      const T* yi = hist(Y, pair_i[n - npairs]);
      const T* yj = hist(Y, pair_j[n - npairs]);
      for (int j = lane; j < d; j += 32) acc += yi[j] * mul(alpha[j], yj[j]);
      acc = warp_sum(acc);
    } else if (n < 2 * npairs + h) {
      const T* yr = hist(Y, n - 2 * npairs);
      for (int j = lane; j < d; j += 32) acc += yr[j] * mul(alpha[j], g[j]);
      acc = warp_sum(acc);
    } else if (n < 2 * npairs + 2 * h) {
      const T* sr = hist(S, n - 2 * npairs - h);
      for (int j = lane; j < d; j += 32) acc += sr[j] * g[j];
      acc = warp_sum(acc);
    } else if (n == 2 * npairs + 2 * h) {
      for (int j = lane; j < d; j += 32) acc = maximum(acc, absval(x[j]));
      acc = warp_max(acc);
    } else if (n == 2 * npairs + 2 * h + 1) {
      for (int j = lane; j < d; j += 32) acc = maximum(acc, absval(g[j]));
      acc = warp_max(acc);
    } else {
      for (int j = lane; j < d; j += 32) acc += g[j] * g[j];
      acc = warp_sum(acc);
    }
    if (lane == 0) dots[n] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    // R = triu(S Y^T), E = diag(R): w = R^-1 u2, then R^T d2 = -u1 + E w + (Y a Y^T) w
    const T* sy = dots;
    const T* yay = dots + npairs;
    const T* u1 = dots + 2 * npairs;
    const T* u2 = u1 + h;
    for (int i = h - 1; i >= 0; --i) {
      T v = u2[i];
      for (int j = i + 1; j < h; ++j) v -= sy[pair_index(i, j, h)] * w_s[j];
      w_s[i] = v / sy[pair_index(i, i, h)];
    }
    for (int i = 0; i < h; ++i) {
      T v = sy[pair_index(i, i, h)] * w_s[i] - u1[i];
      for (int j = 0; j < h; ++j)
        v += yay[j <= i ? pair_index(j, i, h) : pair_index(i, j, h)] * w_s[j];
      d2_s[i] = v;
    }
    for (int i = 0; i < h; ++i) {
      T v = d2_s[i];
      for (int j = 0; j < i; ++j) v -= sy[pair_index(j, i, h)] * d2_s[j];
      d2_s[i] = v / sy[pair_index(i, i, h)];
    }
    T a0 = one;
    if (it0) {  // initial_step_size (psi0 = q.psi0)
      const T* e = dots + 2 * npairs + 2 * h;
      const T psi = static_cast<T>(q.psi0), tiny = static_cast<T>(1e-32), fa = absval(f);
      const T a_x = quo(mul(psi, e[0]), maximum(e[1], tiny));
      const T a_f = quo(mul(psi, fa), maximum(e[2], tiny));
      const T a = e[0] > zero ? a_x : fa > zero ? a_f : one;
      a0 = isfinite(a) && a > zero ? a : one;
    }
    alpha0_s = a0;
  }
  __syncthreads();
  // -H g, and the descent safeguard: -alpha g where it is no descent direction
  T gd = zero;
  for (int j = tid; j < d; j += nt) {
    const T al = alpha[j], gj = g[j], ag = mul(al, gj);
    T hg = ag;
    if (h > 0) {
      T yw = zero, sd = zero;
      for (int i = 0; i < h; ++i) {
        yw += hist(Y, i)[j] * w_s[i];
        sd += hist(S, i)[j] * d2_s[i];
      }
      hg = add(sub(ag, mul(al, yw)), sd);
    }
    p[j] = -hg;
    gd += gj * -hg;
  }
  gd = block_sum(gd, red);
  T dphi0 = gd;
  if (!(gd < zero)) {  // every thread holds the same gd
    T gp = zero;
    for (int j = tid; j < d; j += nt) {
      const T gj = g[j], dir = mul(-alpha[j], gj);
      p[j] = dir;
      gp += gj * dir;
    }
    dphi0 = block_sum(gp, red);
  }

  // (5) the next search's start
  const T a0 = alpha0_s;
  if (tid == 0) {
    const T fv = f;
    hz[kC * K] = a0;
    hz[kA * K] = zero;
    hz[kPhiA * K] = fv;
    hz[kDphiA * K] = dphi0;
    hz[kB * K] = zero;
    hz[kPhiB * K] = fv;
    hz[kDphiB * K] = dphi0;
    hz[kA0 * K] = zero;
    hz[kB0 * K] = zero;
    hz[kPhiA0 * K] = fv;
    hz[kDphiA0 * K] = dphi0;
    hz[kPhiB0 * K] = fv;
    hz[kDphiB0 * K] = dphi0;
    hz[kAAcc * K] = zero;
    hz[kPhiAcc * K] = fv;
    hz[kF0 * K] = fv;
    hz[kDphi0 * K] = dphi0;
    hz[kEpsK * K] = mul(static_cast<T>(q.hz_epsilon), absval(fv));
    const bool run_next = q.run[k];
    q.hz_ints[k] = run_next ? kBracket : kDone;
    q.hz_ints[K + k] = 0;
    q.accepted[k] = false;
    if (run_next) q.flags[q.parity] = 1;
    if (k == 0) q.flags[q.parity ^ 1] = 0;
  }
  for (int j = tid; j < d; j += nt) {
    const T gj = g[j];
    g_a[j] = gj;
    g_acc[j] = gj;
    x_c[j] = add(x[j], mul(a0, p[j]));
  }
}

// threads a CTA: about four elements a thread, 64 to 512
int iter_threads(int d) {
  int t = 64;
  while (t < kIterMaxThreads && t * 4 < d) t *= 2;
  return t;
}

template <typename T>
int launch_iter(const LbfgsArgs& q, cudaStream_t stream) {
  lbfgs_iter_kernel<T><<<q.K, iter_threads(q.d), 0, stream>>>(q);
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

// the size of LbfgsArgs and the longest history, for the wrapper's checks
int pf_lbfgs_args_size() { return static_cast<int>(sizeof(LbfgsArgs)); }
int pf_lbfgs_max_history() { return kMaxHistory; }

// one L-BFGS iteration's own work (start != 0: the first launch of a batch);
// dtype: 0 float32, 1 float64; -1 for another, or a batch the kernel does not take
// (args: a LbfgsArgs, passed as void* so that the function keeps C linkage)
int pf_lbfgs_iter(int dtype, const void* args, cudaStream_t stream) {
  const LbfgsArgs& q = *static_cast<const LbfgsArgs*>(args);
  if (q.K <= 0 || q.J < 0 || q.J > kMaxHistory) return -1;
  if (dtype == 0) return launch_iter<float>(q, stream);
  if (dtype == 1) return launch_iter<double>(q, stream);
  return -1;
}

}  // extern "C"
