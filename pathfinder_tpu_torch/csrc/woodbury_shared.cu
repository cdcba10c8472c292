// Woodbury whiten+sumsq (B2) over one block of columns shared by every factor
// (the mixture denominator), for Hopper (sm_90a): every float dtype, every rank.
//
// It replaces, for an x (d, P) shared by B factors, the Pallas TPU kernel of
// the JAX package, pathfinder_tpu/ops/pallas/woodbury_kernels.py at commit
// c548d16^:
//   B2  _whiten_kernel  (:146, pl.pallas_call at :167)
//       v = (x_j − μ_b)/a½_b,  w = v + X_b (Ci_b (X_bᵀ v)),  maha[b, j] = ‖w‖²
// for every factor b and column j. x comes in the (P, d) layout the pooled
// draws already have (a column's rows side by side). Storage dtype T is
// float16, bfloat16, float32 or float64; the sums run in Acc =
// promote_types(T, float32), and maha is rounded to T once.
//
// What bounds it: operations. Every factor meets every column: B·P·(4·d·m +
// 2·m² + 5·d) operations against d·P + B·d·(m + 2) + B·m² values read, some
// hundred operations a byte at the mixture shape (B, m, P) = (100, 12, 1000).
// The design puts the two products on the tensor cores and shares x between
// factors:
//
//   work      a CTA of 8 computing warps takes W (factor, 16-column tile)
//             pairs of one factor group of F factors and one column tile of
//             NC = 16·W/F columns; W is 8 where the rank leaves room, fewer
//             above, and S = 8/W warps then share a pair, splitting its rows.
//             A persistent grid walks the (factor group, column tile) items
//             (no grid-axis limit).
//   streaming x is streamed over d in chunks of R rows, double-buffered: a
//             ninth warp copies each step's runs (a column of x, a factor's
//             μ, a½ and rows of X) by TMA bulk copies a step ahead, on
//             full/empty mbarriers, while the others compute. A run is copied
//             as the 16-byte blocks that hold it, so rows at any alignment
//             (d = 999, any dtype) take the same path, and a chunk of x is
//             read once for the F factors of the group. (Copies issued by
//             the computing warps, 16 bytes a cp.async, cost them ~2k cycles
//             a step.) μ and 1/a½ are converted to Acc each chunk; X's
//             fragments are formed from its rows as stored (a conversion
//             pass cost as much as the products and its shared memory held W
//             down), but with X's ranks in windows, where a window is
//             converted to Acc (and split for 3xTF32) each step. x is
//             whitened as each factor's fragments are formed. Pass 1 and
//             pass 3 each stream x once.
//   pass 1    tᵀ (NC × m) += Vᵀ (NC × R) · X (R × m) by mma.sync m16n8k8:
//             columns are the MMA's M (m = 12 is too narrow for it), ranks its
//             N, padded to 8 with zeros, rows its K. Up to 4 rank tiles (m <=
//             32) a warp holds all of a pair's sums in registers and the S
//             warps of a pair take every S-th k-step, their partial sums
//             added in order at the end; above, a warp takes groups of up to 4
//             rank tiles and keeps them in shared memory between steps. The
//             tensor cores round each MMA's sum toward zero; chained over the
//             125 k-steps of d = 1000 that bias broke the tolerance where
//             draws lie far out (a float32 emulation: 8.3e-4 against 6.8e-5
//             relative), so each k-step's three products go to a fresh
//             accumulator, added to the sums by a round-to-nearest FADD
//             (tests/test_torch_shared_tf32.py; fresh every 2 or 4 k-steps
//             also held the tolerance but ran 1.1-1.15x slower, by registers).
//   pass 2    s = Ci t on the CUDA cores, m² a column against 4·d·m for the
//             two products, a thread forming 4 entries over Ci's columns in
//             order. The group's Ci comes into shared memory by cp.async
//             while pass 1 runs, where it fits (32 KB): read from global
//             memory, pass 2 took as long as pass 1 at m = 12, a load's
//             latency a term.
//   pass 3    (X s)ᵀ (NC × R) = sᵀ (NC × m) · Xᵀ (m × R) by the same MMA, s's
//             fragments held in registers up to m = 32, then w = v + X s and
//             ‖w‖² on the C fragments: a lane sums its two rows of each row
//             tile, its quad is summed by two shuffles, and the warps sharing
//             a pair in order.
//   3xTF32    float32 and 16-bit (widened to float32): each operand split as
//             hi = tf32(a) (cvt.rna), lo = a − hi, which the tensor cores
//             read as TF32 (its low 13 bits dropped), the products summed as
//             lo·hi + hi·lo + hi·hi in float32 (plain TF32 would break the
//             1e-4 tolerance on the sums). Pass 1 multiplies x − μ by X's rows
//             scaled by 1/a½; a 16-bit X is exact in TF32, so pass 3 skips its
//             lo product. float64: DMMA (m16n8k8 .f64), exact products.
//   rank 0    no product: its own instantiation of the streamed loop, ‖v‖²
//             on the CUDA cores, in chunks of 128 rows.
//   row split the mesh's dim axis holds a block of d_r rows of x, μ, a½ and X
//             on each device, and B2's sums over d span the blocks. Two more
//             parts of the same kernel, each its own instantiation: the
//             partial runs pass 1 alone over the block's rows and writes t for
//             every (factor, column) pair, t (B, P, m) in Acc, where the whole
//             kernel keeps it in shared memory (no Ci staged, no pass 2); the
//             caller sums t over the blocks. The resume loads the summed t
//             where pass 1 would leave it, runs passes 2 and 3 over the block's
//             rows and writes the block's ‖w‖² (B, P) in Acc, unrounded: the
//             caller sums those and rounds once. At rank 0 the partial has
//             nothing to form (no launch) and the resume is the block's ‖v‖².
//             The plan is the whole kernel's at d_r rows, so the order of each
//             block's sums is fixed as the whole kernel's is.
//   memory    X's rows go into shared memory with all of m where they fit,
//             else in windows of kw ranks; t and s live in shared memory, or,
//             where they do not fit, in a global workspace slice per CTA.
//   order     every sum runs in an order fixed by (d, m, dtype): rows chunk
//             by chunk in k-steps of 8, the rows split between warps by W,
//             which the rank and dtype alone decide. P, the column tile and
//             the factor group move no bits, so a repeated launch, and a
//             mixture computed in column blocks, repeat bit for bit.
//
// The arithmetic keeps the reference's form: x − μ before any scaling (never
// x/a½ − μ/a½), and ‖w‖² of w = (x − μ)·(1/a½) + X s (never ‖v‖² + 2tᵀs +
// sᵀXᵀXs): both expansions cancel where draws lie far out or along a
// factor's widest direction.
//
// Plain C interface, loaded with ctypes. The Python wrapper
// (ops/kernels/woodbury_kernels.py: _shared_plan) computes the plan; the entry
// point checks it against SLayout below, returns -1 if they disagree, and
// otherwise the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;  // computing threads a CTA (a copying warp besides)
constexpr int kWarps = kThreads / 32;
constexpr int kColTile = 16;   // columns of an MMA tile (its M)
constexpr int kRankTiles = 4;  // rank tiles of 8 a warp sums at once in pass 1
constexpr int kMaxSmem = 232448;

// The kernel's dynamic shared memory limit holds for the device it was set
// on: set it once for each device (the current one at the launch), safe from
// several host threads.
template <typename F>
cudaError_t allow_max_smem(F kernel, std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (ready.load() & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess) ready.fetch_or(bit);
  return e;
}

// dtype codes of the entry point (ops/kernels/woodbury_kernels.py mirrors them)
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

__host__ __device__ inline int r16(int bytes) { return (bytes + 15) & ~15; }
// m rounded up to whole rank tiles of 8
__host__ __device__ inline int rank_pad(int m) { return (m + 7) / 8 * 8; }
// Bytes of a staged run of n bytes at any offset: the 16-byte blocks that
// hold it, one more than n needs where it does not start on 16 bytes.
__host__ __device__ inline int run_bytes(int n) { return r16(n) + 16; }
// Row stride (in Acc values) of a staged window of kw ranks of X: its
// fragment loads then hit distinct banks (float: ≡ 8 mod 16; double: ≡ 4 mod 8).
__host__ __device__ inline int x_stride(int asz, int kw) {
  return asz == 8 ? kw + 4 : (kw % 16 == 0 ? kw + 8 : kw);
}
// Bytes between two staged columns of a chunk of x: a run of R values, and
// for float64 16 more, so that an A fragment's loads hit distinct banks.
__host__ __device__ inline int x_col_bytes(int esz, int R) {
  return run_bytes(R * esz) + (esz == 8 ? 16 : 0);
}
// The kernel's modes: rank 0 (pass 3 alone); every rank of X staged at once,
// its fragments formed from the rows as stored; X's ranks in windows,
// converted to Acc a window at a time.
constexpr int kRank0 = 0, kOne = 1, kWin = 2;
// The kernel's parts: the whole B2; its row-split partial (pass 1, t written
// out) and resume (passes 2 and 3 from the summed t, the block's ‖w‖² in Acc).
constexpr int kWhole = 0, kPartial = 1, kResume = 2;
// Whether the group's Ci is staged in shared memory for pass 2 (up to 32 KB
// of it as stored); above, pass 2 reads it from global memory.
__host__ __device__ inline int ci_staged(int esz, int F, int m) {
  return m > 0 && F * run_bytes(m * m * esz) <= 32768 ? 1 : 0;
}
// Pass 1's k-step split: with at most kRankTiles rank tiles the S warps of a
// pair take every S-th k-step, each summing a partial Xᵀv; above, one.
__host__ __device__ inline int kstep_split(int W, int m) {
  return m > 0 && rank_pad(m) / 8 <= kRankTiles ? kWarps / W : 1;
}

// Byte offsets into the dynamic shared memory, each array on 16 bytes. esz,
// asz: bytes of T and Acc; lo: X keeps a TF32 lo part (Acc = float); W, F, R,
// kw: the plan's pairs, factors, chunk rows and rank window; ws: t and s live
// in the global workspace. The pairs hold F·NC = 16·W (factor, column) slots.
// Each of the two stages holds a step's runs as stored (a column of x a run,
// a factor's μ and a½ a run each, its rows of X one run where one window
// holds every rank, else a run of kw a row) and μ, 1/a½ (and, with windows,
// the window of X) converted to Acc.
// ops/kernels/woodbury_kernels.py (_shared_layout) mirrors this layout.
struct SLayout {
  int bar, x, ma, Xr, Xh, Xl, mu, ra, t, s, q, ci, total;
  __host__ __device__ SLayout(int esz, int asz, int lo, int W, int F, int R, int m, int kw,
                              int ws) {
    const int nc = kColTile * W / F, mp = rank_pad(m), keep = m > 0 ? 1 : 0;
    const int inner = keep * (1 - ws), one = kw >= mp ? 1 : 0, conv = keep * (1 - one);
    const int xrun = one * run_bytes(R * m * esz) + (1 - one) * R * run_bytes(kw * esz);
    int o = 0;
    bar = o; o += 32;                                                  // four mbarriers
    x = o;  o += r16(2 * nc * x_col_bytes(esz, R));                    // x, a stage each
    ma = o; o += r16(2 * 2 * F * run_bytes(R * esz));                  // μ and a½
    Xr = o; o += r16(keep * 2 * F * xrun);                             // X's rows
    Xh = o; o += r16(conv * 2 * F * R * x_stride(asz, kw) * asz);      // a window of X in Acc
    Xl = o; o += r16(conv * lo * 2 * F * R * x_stride(asz, kw) * asz); // its TF32 lo parts
    mu = o; o += r16(2 * F * R * asz);                                 // μ in Acc
    ra = o; o += r16(2 * F * R * asz);                                 // 1/a½
    t = o;  o += r16(inner * kstep_split(W, m) * kColTile * W * (mp + 1) * asz);  // Xᵀv (partials)
    s = o;  o += r16(inner * kColTile * W * (mp + 4) * asz);           // Ci Xᵀv
    q = o;  o += r16(kWarps * kColTile * asz);                         // pass-3 column sums a warp
    ci = o; o += r16(ci_staged(esz, F, m) * F * run_bytes(m * m * esz));  // the group's Ci
    total = o;
  }
};

// Values of Acc one CTA's workspace slice holds (t, then s).
__host__ __device__ inline int ws_values(int W, int m) {
  return kColTile * W * (2 * rank_pad(m) + 5);
}

// -- cp.async, mbarriers and the tensor cores ---------------------------------

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// A copy that never lands traps (a launch error) instead of hanging the card.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  }
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

__device__ inline void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ inline void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}

__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// A barrier of the compute warps alone (the copying warp does not take part).
__device__ inline void compute_sync() { asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory"); }

// The 16-byte blocks [lo, lo + bytes) that hold n values of T at p (none for n = 0).
template <typename T>
__device__ inline uint32_t blocks_of(const T* p, int n, uintptr_t& lo) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  lo = a & ~static_cast<uintptr_t>(15);
  return n > 0 ? static_cast<uint32_t>(((a + n * sizeof(T) + 15) & ~static_cast<uintptr_t>(15)) - lo)
               : 0u;
}

// Where value 0 of a run starting at p lies in its staged copy: the run's
// offset within 16 bytes, in values.
template <typename T>
__device__ inline int pad_of(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

__device__ inline uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// hi = tf32(v) rounded to nearest; lo = v − hi, exact in float32, which the
// tensor cores read as TF32 by dropping its low 13 bits
__device__ inline void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c += a·b for a 16×8 tile: a (16×8, row-major) and b (8×8, column-major)
// as the m16n8k8 fragments, TF32 with float32 sums
__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same in float64 (DMMA)
__device__ inline void mma(double (&c)[4], const double (&a)[4], double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// An A fragment of a 16 × 8 tile of Acc values: as they are for float64, split
// into TF32 hi and lo parts otherwise.
template <typename Acc>
struct AFrag;
template <>
struct AFrag<float> {
  uint32_t hi[4], lo[4];
  __device__ void set(const float (&v)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) split(v[k], hi[k], lo[k]);
  }
};
template <>
struct AFrag<double> {
  double v[4];
  __device__ void set(const double (&a)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = a[k];
  }
};

// c += A·B with B's fragment (b0, b1) read from the staged X: hi at bh, lo at
// bl (float32 X); 3xTF32 as lo·hi + hi·lo + hi·hi, DMMA for float64.
template <bool LO>
__device__ inline void product(float (&c)[4], const AFrag<float>& a, const float* bh,
                               const float* bl, int o0, int o1) {
  const uint32_t h0 = __float_as_uint(bh[o0]), h1 = __float_as_uint(bh[o1]);
  mma(c, a.lo, h0, h1);
  if (LO) mma(c, a.hi, __float_as_uint(bl[o0]), __float_as_uint(bl[o1]));
  mma(c, a.hi, h0, h1);
}
template <bool LO>
__device__ inline void product(double (&c)[4], const AFrag<double>& a, const double* bh,
                               const double*, int o0, int o1) {
  mma(c, a.v, bh[o0], bh[o1]);
}

// The same with B's fragment given as values of Acc, split here.
template <bool LO>
__device__ inline void product_v(float (&c)[4], const AFrag<float>& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(c, a.lo, h0, h1);
  if (LO) mma(c, a.hi, l0, l1);
  mma(c, a.hi, h0, h1);
}
template <bool LO>
__device__ inline void product_v(double (&c)[4], const AFrag<double>& a, double b0, double b1) {
  mma(c, a.v, b0, b1);
}

// Phase stamps for tools/woodbury_shared_bench.py --phases, compiled only with
// -DPFS_PHASES: thread 0 of CTA 0, and of the middle CTA, records clock64() at
// the end of each phase of its first item; threads 0 and 224 of CTA 0 sum
// the cycles of that item's steps spent waiting for copies, converting μ and
// a½, converting X (with windows) and at the barrier after, and computing.
#ifdef PFS_PHASES
__device__ long long pfs_stamps[2][6];
__device__ long long pfs_steps[2][4];
#define PFS_STAMP(k)                                                                    \
  do {                                                                                  \
    if (threadIdx.x == 0 && it == static_cast<int>(blockIdx.x)) {                       \
      if (blockIdx.x == 0) pfs_stamps[0][k] = clock64();                                \
      else if (blockIdx.x == gridDim.x / 2) pfs_stamps[1][k] = clock64();               \
    }                                                                                   \
  } while (0)
#else
#define PFS_STAMP(k)
#endif


// -- the kernel ----------------------------------------------------------------

// Item it of the persistent loop is column tile it % ntiles of factor group
// it / ntiles. xt: x in the (P, d) layout; M: Ci; out: maha (B, P) in T
// (kWhole), t (B, P, m) in Acc (kPartial) or the block's ‖w‖² (B, P) in Acc
// (kResume); tin: the summed t (B, P, m) in Acc (kResume). W, F, R, kw as in
// SLayout; ws: the workspace, or nullptr; MODE: kRank0, kOne or kWin; PART:
// kWhole, kPartial or kResume.
//
// Each pass streams the chunks of R rows; with X's ranks in several windows a
// chunk takes one step a window. Warp 8 copies: for each step, once the
// compute warps have released its stage (mbarrier empty), it sends the
// step's runs by TMA bulk copies, each as the 16-byte blocks that hold it,
// announced on mbarrier full. Warps 0-7 compute. A run's rows past d and
// factors past B are not copied; the conversion writes zeros there and
// zeroes x's and X's rows past d.
// Two CTAs of 288 threads an SM (three at rank 0). ptxas then gives a thread
// 96 registers with some spills; a cap of 112 (__maxnreg__) spilled less and
// ran 1.3-1.5x slower at every rank measured, three CTAs an SM 1.35x slower.
template <typename T, int MODE, int PART>
__global__ void __launch_bounds__(kThreads + 32, MODE == kRank0 ? 3 : 2)
shared_kernel(const T* __restrict__ xt, const T* __restrict__ a_half, const T* __restrict__ X,
              const T* __restrict__ M, const T* __restrict__ mu,
              const typename Num<T>::Acc* __restrict__ tin, void* __restrict__ out, int B,
              int d, int m, int P, int W, int F, int R, int kw,
              typename Num<T>::Acc* __restrict__ ws) {
  using Acc = typename Num<T>::Acc;
  static_assert(!(MODE == kRank0 && PART == kPartial), "the rank-0 partial has nothing to form");
  constexpr int ESZ = sizeof(T);
  constexpr bool RANK0 = MODE == kRank0, one = MODE == kOne;
  // X has a TF32 lo part in Acc = float: scaled by 1/a½ in pass 1 whatever T,
  // and in pass 3 unless T is 16-bit (exact in TF32)
  constexpr bool kSplit = sizeof(Acc) == 4, kLo = kSplit && ESZ == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NC = kColTile * W / F, CT = NC / kColTile, S = kWarps / W;
  const int mp = rank_pad(m), NR = mp / 8, ldx = x_stride(sizeof(Acc), kw);
  const int ldt = mp + 1, lds = mp + 4, slots = kColTile * W;
  const int nwin = MODE == kWin ? (mp + kw - 1) / kw : 1;  // steps a chunk
  const int xcb = x_col_bytes(ESZ, R), rrow = run_bytes(R * ESZ);
  const int xrun = one ? run_bytes(R * m * ESZ) : R * run_bytes(kw * ESZ);
  const SLayout L(ESZ, sizeof(Acc), kSplit ? 1 : 0, W, F, R, m, kw, ws != nullptr);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L.bar);  // [2]: a stage's copies landed
  uint64_t* const empty = full + 2;                                   // [2]: a stage's readers done
  Acc* const sq = reinterpret_cast<Acc*>(smem + L.q);
  Acc* st = reinterpret_cast<Acc*>(smem + L.t);
  Acc* ss = reinterpret_cast<Acc*>(smem + L.s);
  if (ws != nullptr) {
    st = ws + static_cast<size_t>(blockIdx.x) * ws_values(W, m);
    ss = st + slots * ldt;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const int nchunks = (d + R - 1) / R, steps = nchunks * nwin, lgR = __ffs(R) - 1;
  const int ntiles = (P + NC - 1) / NC, items = ntiles * ((B + F - 1) / F);
  const int passes = RANK0 || PART != kWhole ? 1 : 2;  // the split parts stream x once

  // a stage's buffers
  auto xbuf = [&](int stage) { return smem + L.x + stage * NC * xcb; };
  auto mabuf = [&](int stage, int which, int f) {
    return smem + L.ma + ((stage * 2 + which) * F + f) * rrow;
  };
  auto xrbuf = [&](int stage, int f) { return smem + L.Xr + (stage * F + f) * xrun; };

  if (threadIdx.x == 0) {
    mbar_init(full, 32);
    mbar_init(full + 1, 32);
    mbar_init(empty, kThreads);
    mbar_init(empty + 1, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // The copying warp: every step of every pass of every item, in order.
    // Its lanes take the runs in turn, each announcing its bytes on the
    // stage's full mbarrier before its copies.
    int gs = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int col0 = (it % ntiles) * NC, b0 = (it / ntiles) * F;
      for (int pass = 0; pass < passes; ++pass)
        for (int s = 0; s < steps; ++s, ++gs) {
          const int stage = gs & 1, c = s / nwin, w = s - c * nwin, i0 = c * R;
          const int rows = min(R, d - i0), k0 = w * kw;
          if (gs >= 2) mbar_wait(empty + stage, ((gs >> 1) - 1) & 1);
          const int nruns = NC + 2 * F + (RANK0 ? 0 : one ? F : F * R);
          auto run_of = [&](int q, const T*& src, int& n, unsigned char*& dst) {
            if (q < NC) {
              src = xt + static_cast<size_t>(col0 + q) * d + i0;
              n = col0 + q < P ? rows : 0;
              dst = xbuf(stage) + q * xcb;
            } else if (q < NC + 2 * F) {
              const int which = q >= NC + F, f = q - NC - which * F;
              src = (which ? a_half : mu) + static_cast<size_t>(b0 + f) * d + i0;
              n = b0 + f < B ? rows : 0;
              dst = mabuf(stage, which, f);
            } else if (one) {
              const int f = q - NC - 2 * F;
              src = X + (static_cast<size_t>(b0 + f) * d + i0) * m;
              n = b0 + f < B ? rows * m : 0;
              dst = xrbuf(stage, f);
            } else {
              const int qq = q - NC - 2 * F, f = qq >> lgR, r = qq & (R - 1);
              src = X + (static_cast<size_t>(b0 + f) * d + i0 + r) * m + k0;
              n = b0 + f < B && r < rows ? min(kw, m - k0) : 0;
              dst = xrbuf(stage, f) + r * run_bytes(kw * ESZ);
            }
          };
          uint32_t bytes = 0;
          for (int q = lane; q < nruns; q += 32) {
            const T* src;
            int n;
            unsigned char* dst;
            uintptr_t lo;
            run_of(q, src, n, dst);
            bytes += blocks_of(src, n, lo);
          }
          mbar_arrive_expect(full + stage, bytes);
          for (int q = lane; q < nruns; q += 32) {
            const T* src;
            int n;
            unsigned char* dst;
            uintptr_t lo;
            run_of(q, src, n, dst);
            const uint32_t nb = blocks_of(src, n, lo);
            if (nb) bulk_load(dst, reinterpret_cast<const void*>(lo), nb, full + stage);
          }
        }
    }
    return;
  }

  // -- the compute warps ---------------------------------------------------------
  // pass 1: KSPL warps split a pair's k-steps (m <= 32); above, groups of GR
  // rank tiles of a window, one a warp item
  const int KSPL = kstep_split(W, m), tiles_win = kw / 8;
  const int NG = KSPL > 1 ? 1 : max((tiles_win + kRankTiles - 1) / kRankTiles,
                                    min(tiles_win, kWarps / W));
  const int GR = (tiles_win + NG - 1) / NG, items1 = W * NG * KSPL;
  const bool single = nwin == 1 && items1 <= kWarps;  // a warp's sums stay in registers
  // pass 3: warp = pair·S + sub; the sub takes row tiles sub, sub + S, ... of a chunk
  const int pair3 = warp / S, sub = warp - pair3 * S, f3 = pair3 / CT, ct3 = pair3 - f3 * CT;
  const int tiles3 = max(0, (R / 8 - sub + S - 1) / S);  // row tiles a warp takes, 4 at a time
  const bool held = one && mp <= 4 * 8;  // s's fragments stay in registers
  int gs = 0;  // the compute warps' steps so far: the stage and phase of the next

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int col0 = (it % ntiles) * NC;
    const int b0 = (it / ntiles) * F;
    PFS_STAMP(0);

    auto smu = [&](int stage) { return reinterpret_cast<Acc*>(smem + L.mu) + stage * F * R; };
    auto sra = [&](int stage) { return reinterpret_cast<Acc*>(smem + L.ra) + stage * F * R; };
    auto Xh = [&](int stage) {
      return reinterpret_cast<Acc*>(smem + L.Xh) + stage * F * R * ldx;
    };
    auto Xl = [&](int stage) {
      return reinterpret_cast<Acc*>(smem + L.Xl) + stage * F * R * ldx;
    };
    // factor f's rows of X as stored at a stage (one window), row stride m
    auto xrows = [&](int stage, int f) {
      return reinterpret_cast<const T*>(xrbuf(stage, f)) +
             pad_of(X + static_cast<size_t>(b0 + f) * d * m);
    };

    // μ and 1/a½ of chunk c in Acc, zeros past d and B, and x's rows past d
    // (and X's, as stored) zeroed: v = (x − μ)·(1/a½) is zero there
    auto convert_rows = [&](int c, int stage) {
      const int i0 = c * R, rows = min(R, d - i0);
      Acc* const mu_s = smu(stage);
      Acc* const ra_s = sra(stage);
      for (int e = threadIdx.x; e < F * R; e += kThreads) {
        const int f = e >> lgR, r = e & (R - 1), b = b0 + f;
        const bool ok = b < B && i0 + r < d;
        const size_t o = static_cast<size_t>(b) * d + i0;
        const T* m0 = reinterpret_cast<const T*>(mabuf(stage, 0, f));
        const T* a0 = reinterpret_cast<const T*>(mabuf(stage, 1, f));
        mu_s[e] = ok ? widen(m0[pad_of(mu + o) + r]) : Acc(0);
        ra_s[e] = ok ? Acc(1) / widen(a0[pad_of(a_half + o) + r]) : Acc(0);
      }
      if (rows < R) {  // the last chunk
        for (int e = threadIdx.x; e < NC * (R - rows); e += kThreads) {
          const int col = e / (R - rows), r = rows + e - col * (R - rows);
          T* xp = reinterpret_cast<T*>(xbuf(stage) + col * xcb) +
                  pad_of(xt + static_cast<size_t>(col0 + col) * d + i0);
          xp[r] = Num<T>::narrow(Acc(0));
        }
        if (one)
          for (int f = 0; f < F && b0 + f < B; ++f) {
            T* xr = reinterpret_cast<T*>(xrbuf(stage, f)) +
                    pad_of(X + static_cast<size_t>(b0 + f) * d * m) + rows * m;
            for (int e = threadIdx.x; e < (R - rows) * m; e += kThreads)
              xr[e] = Num<T>::narrow(Acc(0));
          }
        fence_async_smem();  // these writes before the copies that reuse the stage
      }
    };

    // step s's window of X (ranks [k0, k0 + kw)) in Acc, its rows scaled by
    // 1/a½ for pass 1 (scaled), float32 split into TF32 hi and lo; zeros past
    // m, d and B. Thread t takes rank t % wl of rows t / wl, t / wl + per, ...
    auto convert_window = [&](int s, int stage, bool scaled) {
      const int c = s / nwin, w = s - c * nwin, i0 = c * R, k0 = w * kw;
      const int wl = min(kw, mp - k0), rows = min(R, d - i0);
      const int per = max(1, kThreads / wl), k1 = threadIdx.x % wl;
      if (threadIdx.x >= per * wl) return;
      Acc* const xh = Xh(stage);
      Acc* const xl = Xl(stage);
      const Acc* const ra_s = sra(stage);
      for (int f = 0; f < F; ++f) {
        const int b = b0 + f;
        const int rend = b < B ? rows : 0;
        for (int r = threadIdx.x / wl; r < R; r += per) {
          const int row = f * R + r;
          for (int k = k1; k < wl; k += kThreads) {
            Acc v = Acc(0);
            if (r < rend && k0 + k < m) {
              const T* src = reinterpret_cast<const T*>(xrbuf(stage, f) + r * run_bytes(kw * ESZ)) +
                             pad_of(X + (static_cast<size_t>(b) * d + i0 + r) * m + k0);
              v = widen(src[k]);
              if (scaled) v *= ra_s[row];
            }
            if constexpr (kSplit) {
              uint32_t h, l;
              split(v, h, l);
              xh[row * ldx + k] = __uint_as_float(h);
              xl[row * ldx + k] = __uint_as_float(l);
            } else {
              xh[row * ldx + k] = v;
            }
          }
        }
      }
    };

    // Run the steps of one pass: compute(c, w, stage) once the stage's runs
    // have landed and μ, 1/a½ (and window w of X) are converted; then
    // release the stage to the copying warp.
    auto stream = [&](bool pass1, auto&& compute) {
      for (int s = 0; s < steps; ++s, ++gs) {
        const int c = s / nwin, w = s - c * nwin, stage = gs & 1;
#ifdef PFS_PHASES
        const long long t0 = clock64();
#endif
        mbar_wait(full + stage, (gs >> 1) & 1);
#ifdef PFS_PHASES
        const long long t1 = clock64();
#endif
        convert_rows(c, stage);
#ifdef PFS_PHASES
        const long long t1b = clock64();
#endif
        if (MODE == kWin) {
          if (pass1) compute_sync();  // 1/a½ before X is scaled by it
          convert_window(s, stage, pass1);
        }
        compute_sync();
#ifdef PFS_PHASES
        const long long t2 = clock64();
#endif
        compute(c, w, stage);
        mbar_arrive(empty + stage);
#ifdef PFS_PHASES
        if (blockIdx.x == 0 && it == 0 && (threadIdx.x == 0 || threadIdx.x == 224)) {
          long long* acc = pfs_steps[threadIdx.x ? 1 : 0];
          acc[0] += t1 - t0;
          acc[1] += t1b - t1;
          acc[2] += t2 - t1b;
          acc[3] += clock64() - t2;
        }
#endif
      }
    };

    // column col of chunk c of x as staged at a stage
    auto xcol = [&](int stage, int c, int col) {
      return reinterpret_cast<const T*>(xbuf(stage) + col * xcb) +
             pad_of(xt + static_cast<size_t>(col0 + col) * d + c * R);
    };

    // the group's Ci into shared memory (where it fits) while pass 1 runs
    const bool cis = !RANK0 && PART != kPartial && ci_staged(ESZ, F, m);
    if (cis)
      for (int f = 0; f < F && b0 + f < B; ++f) {
        uintptr_t lo;
        const int nb = static_cast<int>(blocks_of(M + static_cast<size_t>(b0 + f) * m * m, m * m, lo) / 16);
        unsigned char* dst = smem + L.ci + f * run_bytes(m * m * ESZ);
        for (int k = threadIdx.x; k < nb; k += kThreads)
          cp_async16(dst + 16 * k, reinterpret_cast<const void*>(lo + 16 * static_cast<uintptr_t>(k)));
      }

    if constexpr (!RANK0 && PART == kResume) {
      // the summed t of the item's (factor, column) pairs where pass 1 would
      // leave it; zeros past m, B and P
      for (int e = threadIdx.x; e < slots * mp; e += kThreads) {
        const int p = e / mp, k = e - p * mp, f = p / NC, b = b0 + f, j = col0 + p - f * NC;
        st[p * ldt + k] =
            k < m && b < B && j < P ? tin[(static_cast<size_t>(b) * P + j) * m + k] : Acc(0);
      }
      compute_sync();
    }
    if constexpr (!RANK0 && PART != kResume) {
      // pass 1: tᵀ += Vᵀ X. Item q is (pair, group, k-step share): q % KSPL,
      // then q / KSPL % NG, then q / KSPL / NG.
      Acc acc[kRankTiles][4];
      stream(true, [&](int c, int w, int stage) {
        const int k0 = w * kw, nend = min(NR, (k0 + kw) / 8);  // the window's rank tiles end
        const int ksteps = (min(R, d - c * R) + 7) / 8;        // k-steps holding rows < d
        const Acc* const mu_s = smu(stage);
        const Acc* const ra_s = sra(stage);
        for (int q = warp; q < items1; q += kWarps) {
          const int ksp = q % KSPL, pg = q / KSPL, grp = pg % NG, pair = pg / NG;
          const int f = pair / CT, ct = pair - f * CT;
          const int n0 = k0 / 8 + grp * GR;  // the group's first rank tile
          if (b0 + f >= B || n0 >= nend) continue;
          Acc* const tp = st + (ksp * slots + f * NC + ct * kColTile) * ldt;
          if (c == 0 || !single) {
#pragma unroll
            for (int j = 0; j < kRankTiles; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int n = n0 + j, row = g + (e >> 1) * 8, rk = n * 8 + 2 * tg + (e & 1);
                acc[j][e] = c > 0 && j < GR && n < nend ? tp[row * ldt + rk] : Acc(0);
              }
          }
          const Acc* const bh = Xh(stage) + f * R * ldx;
          const Acc* const bl = Xl(stage) + f * R * ldx;
          const T* const xr = one ? xrows(stage, f) : nullptr;
          const T* const x0 = xcol(stage, c, ct * kColTile + g);
          const T* const x8 = xcol(stage, c, ct * kColTile + g + 8);
#pragma unroll 2
          for (int ks = ksp; ks < ksteps; ks += KSPL) {
            const int r = ks * 8 + tg;
            const Acc m0 = mu_s[f * R + r], m4 = mu_s[f * R + r + 4];
            const Acc v[4] = {widen(x0[r]) - m0, widen(x8[r]) - m0, widen(x0[r + 4]) - m4,
                              widen(x8[r + 4]) - m4};
            AFrag<Acc> a;
            a.set(v);
            const Acc ra0 = ra_s[f * R + r], ra4 = ra_s[f * R + r + 4];
#pragma unroll
            for (int j = 0; j < kRankTiles; ++j) {
              const int nl = (n0 + j) * 8 - k0;  // the tile's first rank in the window
              if (j < GR && n0 + j < nend) {
                // the k-step's products in a fresh accumulator, added to the sums
                // in float32 (see pass 1 in the notes above); DMMA sums in place
                Acc fresh[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
                Acc (&cj)[4] = kSplit ? fresh : acc[j];
                if constexpr (one) {  // B = X's rows scaled by 1/a½, zero past m
                  const int k = nl + g;
                  const Acc b0v = k < m ? widen(xr[r * m + k]) * ra0 : Acc(0);
                  const Acc b1v = k < m ? widen(xr[(r + 4) * m + k]) * ra4 : Acc(0);
                  product_v<kSplit>(cj, a, b0v, b1v);
                } else {
                  product<kSplit>(cj, a, bh, bl, r * ldx + nl + g, (r + 4) * ldx + nl + g);
                }
                if constexpr (kSplit)
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[j][e] += fresh[e];
              }
            }
          }
          if (!single || c == nchunks - 1) {
#pragma unroll
            for (int j = 0; j < kRankTiles; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int n = n0 + j, row = g + (e >> 1) * 8, rk = n * 8 + 2 * tg + (e & 1);
                if (j < GR && n < nend) tp[row * ldt + rk] = acc[j][e];
              }
          }
        }
      });
      compute_sync();
      if (KSPL > 1) {  // the k-step shares' partial sums, added in order
        for (int e = threadIdx.x; e < slots * ldt; e += kThreads) {
          Acc a = st[e];
          for (int k = 1; k < KSPL; ++k) a += st[k * slots * ldt + e];
          st[e] = a;
        }
        compute_sync();
      }
    }
    if constexpr (!RANK0) PFS_STAMP(1);
    if constexpr (PART == kPartial) {
      // t of every (factor, column) pair of the item, (B, P, m) in Acc; the
      // item ends here
      Acc* const tout = static_cast<Acc*>(out);
      for (int e = threadIdx.x; e < slots * m; e += kThreads) {
        const int p = e / m, k = e - p * m, f = p / NC, b = b0 + f, j = col0 + p - f * NC;
        if (b < B && j < P) tout[(static_cast<size_t>(b) * P + j) * m + k] = st[p * ldt + k];
      }
      compute_sync();  // t is read before the next item writes it
      continue;
    }
    if constexpr (!RANK0) {
      // pass 2: s = Ci t; a thread forms 4 ranks k..k+3 of one slot p = f·NC +
      // col, summing over Ci's columns in order, Ci read from shared memory
      // where it is staged, else from global memory
      const int quads = mp / 4;
      if (cis) {
        cp_async_wait_all();
        compute_sync();
      }
      for (int e = threadIdx.x; e < slots * quads; e += kThreads) {
        const int p = e % slots, k = 4 * (e / slots), f = p / NC, b = b0 + f;
        Acc s4[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
        if (b < B) {
          const T* const Mg = M + static_cast<size_t>(b) * m * m;
          const T* const Mb = cis ? reinterpret_cast<const T*>(smem + L.ci + f * run_bytes(m * m * ESZ)) +
                                        pad_of(Mg)
                                  : Mg;
          const Acc* const tp = st + p * ldt;
#pragma unroll 4
          for (int l = 0; l < m; ++l) {
            const Acc tl = tp[l];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (k + j < m) s4[j] = mad(widen(Mb[static_cast<size_t>(k + j) * m + l]), tl, s4[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) ss[p * lds + k + j] = s4[j];
      }
      compute_sync();
      PFS_STAMP(2);
    }

    // pass 3: w = v + X s at the C fragments, ‖w‖² summed per column
    Acc q0 = Acc(0), q1 = Acc(0);  // columns g and g + 8 of the warp's pair
    const bool live = b0 + f3 < B;
    const Acc* const sp = ss + (f3 * NC + ct3 * kColTile) * lds;  // the pair's s
    AFrag<Acc> sfr[4];  // s's A fragments, rank tiles 0..3, where held
    if (held && live) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < NR) {
          const int kk = 8 * k;
          const Acc v[4] = {sp[g * lds + kk + tg], sp[(g + 8) * lds + kk + tg],
                            sp[g * lds + kk + tg + 4], sp[(g + 8) * lds + kk + tg + 4]};
          sfr[k].set(v);
        }
    }
    Acc cacc[4][4];
    stream(false, [&](int c, int w, int stage) {
      const int i0 = c * R;
      if (!live) return;
      const Acc* const mu_s = smu(stage);
      const Acc* const ra_s = sra(stage);
      const T* const x0 = xcol(stage, c, ct3 * kColTile + g);
      const T* const x8 = xcol(stage, c, ct3 * kColTile + g + 8);
      // w = (x − μ)·(1/a½) + xs at row r of column xp
      auto wat = [&](const T* xp, int r, Acc xs) -> Acc {
        return mad(widen(xp[r]) - mu_s[f3 * R + r], ra_s[f3 * R + r], xs);
      };
      if constexpr (RANK0) {
        for (int rt = sub; rt < R / 8 && i0 + rt * 8 < d; rt += S) {
          const int r = rt * 8 + 2 * tg;
          const Acc w00 = wat(x0, r, Acc(0)), w01 = wat(x0, r + 1, Acc(0));
          const Acc w10 = wat(x8, r, Acc(0)), w11 = wat(x8, r + 1, Acc(0));
          q0 = mad(w00, w00, q0);
          q0 = mad(w01, w01, q0);
          q1 = mad(w10, w10, q1);
          q1 = mad(w11, w11, q1);
        }
      } else {
        const Acc* const bh = Xh(stage) + f3 * R * ldx;
        const Acc* const bl = Xl(stage) + f3 * R * ldx;
        const T* const xr = one ? xrows(stage, f3) : nullptr;
        // B = Xᵀ at x-row rr, ranks kk + tg and kk + tg + 4 (zero past m)
        auto bx = [&](Acc (&cc)[4], const AFrag<Acc>& a, int rr, int kk) {
          if constexpr (one) {
            const int k = kk + tg;
            const Acc b0v = k < m ? widen(xr[rr * m + k]) : Acc(0);
            const Acc b1v = k + 4 < m ? widen(xr[rr * m + k + 4]) : Acc(0);
            product_v<kLo>(cc, a, b0v, b1v);
          } else {
            product<kLo>(cc, a, bh, bl, rr * ldx + kk + tg, rr * ldx + kk + tg + 4);
          }
        };
        // the warp's row tiles, 4 at a time (one group where X's ranks come in
        // windows: a pair has one warp to each row tile then)
        for (int h = 0; h < tiles3; h += 4) {
          if (w == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) cacc[j][e] = Acc(0);
          }
          if (held) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (k < NR)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const int rt = sub + (h + j) * S;
                  if (h + j < tiles3 && i0 + rt * 8 < d) bx(cacc[j], sfr[k], rt * 8 + g, 8 * k);
                }
          } else {
            const int k0 = w * kw, wl = min(kw, mp - k0);
            for (int kk = 0; kk < wl; kk += 8) {
              const int ko = k0 + kk;
              const Acc v[4] = {sp[g * lds + ko + tg], sp[(g + 8) * lds + ko + tg],
                                sp[g * lds + ko + tg + 4], sp[(g + 8) * lds + ko + tg + 4]};
              AFrag<Acc> a;
              a.set(v);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int rt = sub + (h + j) * S;
                if (h + j < tiles3 && i0 + rt * 8 < d) bx(cacc[j], a, rt * 8 + g, one ? ko : kk);
              }
            }
          }
          if (w == nwin - 1) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int r = (sub + (h + j) * S) * 8 + 2 * tg;
              if (h + j < tiles3 && i0 + r - 2 * tg < d) {
                const Acc w00 = wat(x0, r, cacc[j][0]), w01 = wat(x0, r + 1, cacc[j][1]);
                const Acc w10 = wat(x8, r, cacc[j][2]), w11 = wat(x8, r + 1, cacc[j][3]);
                q0 = mad(w00, w00, q0);
                q0 = mad(w01, w01, q0);
                q1 = mad(w10, w10, q1);
                q1 = mad(w11, w11, q1);
              }
            }
          }
        }
      }
    });
    PFS_STAMP(3);
    // the quad's four lanes hold a column's rows 2tg, 2tg + 1 of each row tile
    q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
    q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
    if (tg == 0) {
      sq[warp * kColTile + g] = q0;
      sq[warp * kColTile + g + 8] = q1;
    }
    compute_sync();
    for (int e = threadIdx.x; e < F * NC; e += kThreads) {  // the S warps of a pair in order
      const int f = e / NC, col = e - f * NC, b = b0 + f, j = col0 + col;
      const int pair = f * CT + col / kColTile;
      Acc tot = sq[pair * S * kColTile + col % kColTile];
      for (int k = 1; k < S; ++k) tot += sq[(pair * S + k) * kColTile + col % kColTile];
      if (b < B && j < P) {
        if constexpr (PART == kResume)
          static_cast<Acc*>(out)[static_cast<size_t>(b) * P + j] = tot;  // summed and rounded by the caller
        else
          static_cast<T*>(out)[static_cast<size_t>(b) * P + j] = Num<T>::narrow(tot);
      }
    }
    compute_sync();  // sq, t and s are read before the next item writes them
    PFS_STAMP(4);
  }
}

// The plan: pairs W, factors F, chunk rows R, rank window kw, whether t and s
// live in the workspace, shared memory bytes.
struct SPlan {
  int W, F, R, kw, ws, smem;
};

template <typename T>
bool plan_ok(const SPlan& p, int B, int d, int m, int P) {
  using Acc = typename Num<T>::Acc;
  if (B < 1 || d < 1 || m < 0 || P < 1) return false;
  if (p.W != 1 && p.W != 2 && p.W != 4 && p.W != 8) return false;
  if (p.F < 1 || p.F > p.W || (p.F & (p.F - 1))) return false;
  if (m == 0 ? p.R != 128 : p.R != 32 && p.R != 64) return false;
  if (p.ws != 0 && p.ws != 1) return false;
  if (m > 0 && (p.kw < 8 || p.kw % 8 || p.kw > rank_pad(m))) return false;
  if (m == 0 && (p.kw != 0 || p.ws)) return false;
  if (p.smem < 0 || p.smem > kMaxSmem) return false;
  const SLayout L(sizeof(T), sizeof(Acc), sizeof(Acc) == 4 ? 1 : 0, p.W, p.F, p.R, m, p.kw, p.ws);
  return p.smem == L.total;
}

template <typename T, int MODE, int PART>
int launch(const SPlan& p, int ctas, const void* xt, const void* a_half, const void* X,
           const void* M, const void* mu, const void* tin, void* out, int B, int d, int m, int P,
           void* ws, cudaStream_t stream) {
  using Acc = typename Num<T>::Acc;
  auto kernel = shared_kernel<T, MODE, PART>;
  static std::atomic<unsigned long long> ready{0};
  if (const cudaError_t e = allow_max_smem(kernel, ready); e != cudaSuccess) {
    return static_cast<int>(e);
  }
  kernel<<<ctas, kThreads + 32, p.smem, stream>>>(
      static_cast<const T*>(xt), static_cast<const T*>(a_half), static_cast<const T*>(X),
      static_cast<const T*>(M), static_cast<const T*>(mu), static_cast<const Acc*>(tin), out, B,
      d, m, P, p.W, p.F, p.R, p.kw, static_cast<Acc*>(ws));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PART>
int checked(const SPlan& p, int ctas, const void* xt, const void* a_half, const void* X,
            const void* M, const void* mu, const void* tin, void* out, int B, int d, int m, int P,
            void* ws, cudaStream_t stream) {
  if (!plan_ok<T>(p, B, d, m, P) || ctas < 1 || (p.ws != 0) != (ws != nullptr)) return -1;
  if (m == 0) {
    if constexpr (PART == kPartial) return -1;  // nothing to form: the caller launches nothing
    else return launch<T, kRank0, PART>(p, ctas, xt, a_half, X, M, mu, tin, out, B, d, m, P, ws, stream);
  }
  if (p.kw >= rank_pad(m))
    return launch<T, kOne, PART>(p, ctas, xt, a_half, X, M, mu, tin, out, B, d, m, P, ws, stream);
  return launch<T, kWin, PART>(p, ctas, xt, a_half, X, M, mu, tin, out, B, d, m, P, ws, stream);
}

template <int PART>
int dispatch(int dtype, const SPlan& p, int ctas, const void* xt, const void* a_half,
             const void* X, const void* M, const void* mu, const void* tin, void* out, int B,
             int d, int m, int P, void* ws, cudaStream_t stream) {
  switch (dtype) {
    case kF32:
      return checked<float, PART>(p, ctas, xt, a_half, X, M, mu, tin, out, B, d, m, P, ws, stream);
    case kF64:
      return checked<double, PART>(p, ctas, xt, a_half, X, M, mu, tin, out, B, d, m, P, ws, stream);
    case kF16:
      return checked<__half, PART>(p, ctas, xt, a_half, X, M, mu, tin, out, B, d, m, P, ws, stream);
    case kBF16:
      return checked<__nv_bfloat16, PART>(p, ctas, xt, a_half, X, M, mu, tin, out, B, d, m, P, ws,
                                          stream);
  }
  return -1;
}

}  // namespace

extern "C" {

int pfs_col_tile() { return kColTile; }

int pfs_rank_tiles() { return kRankTiles; }

// B2 over a shared x: xt is x in the (P, d) layout, maha is (B, P); ctas the
// grid of the persistent loop; ws the workspace where the plan has one.
int pfs_whiten_sumsq(int dtype, const void* xt, const void* a_half, const void* X, const void* Ci,
                     const void* mu, void* maha, int B, int d, int m, int P, int W, int F, int R,
                     int kw, int ws_flag, int smem, int ctas, void* ws, cudaStream_t stream) {
  const SPlan p = {W, F, R, kw, ws_flag, smem};
  return dispatch<kWhole>(dtype, p, ctas, xt, a_half, X, Ci, mu, nullptr, maha, B, d, m, P, ws,
                          stream);
}

// B2's row-split partial over a shared x on a block of d rows (rank m > 0):
// t (B, P, m) in the accumulation type. The plan is the whole kernel's at d.
int pfs_whiten_sumsq_partial(int dtype, const void* xt, const void* a_half, const void* X,
                             const void* mu, void* t, int B, int d, int m, int P, int W, int F,
                             int R, int kw, int ws_flag, int smem, int ctas, void* ws,
                             cudaStream_t stream) {
  const SPlan p = {W, F, R, kw, ws_flag, smem};
  return dispatch<kPartial>(dtype, p, ctas, xt, a_half, X, nullptr, mu, nullptr, t, B, d, m, P,
                            ws, stream);
}

// Its resume on the block from the summed t (B, P, m): the block's ‖w‖² (B, P)
// in the accumulation type, unrounded.
int pfs_whiten_sumsq_resume(int dtype, const void* xt, const void* a_half, const void* X,
                            const void* Ci, const void* mu, const void* t, void* sums, int B, int d,
                            int m, int P, int W, int F, int R, int kw, int ws_flag, int smem,
                            int ctas, void* ws, cudaStream_t stream) {
  const SPlan p = {W, F, R, kw, ws_flag, smem};
  return dispatch<kResume>(dtype, p, ctas, xt, a_half, X, Ci, mu, t, sums, B, d, m, P, ws, stream);
}


#ifdef PFS_PHASES
// The phase stamps of the launches since the last read: 2 × 6 values, then
// 2 × 4 step sums, into out; the step sums start again from zero.
int pfs_read_stamps(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pfs_stamps, sizeof(pfs_stamps));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 12, pfs_steps, sizeof(pfs_steps));
  static const long long zeros[8] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pfs_steps, zeros, sizeof(zeros));
  return static_cast<int>(e);
}
#endif

}  // extern "C"
