// Woodbury sample+logq (B1) and whiten+sumsq (B2) for any rank and any float
// dtype, for Hopper (sm_90a): the general kernel beside the fast one.
//
// They replace the same two Pallas TPU kernels as woodbury_kernels.cu,
// pathfinder_tpu/ops/pallas/woodbury_kernels.py at commit c548d16^:
//   B1  _sample_kernel  (:70, pl.pallas_call at :96)
//   B2  _whiten_kernel  (:146, pl.pallas_call at :167)
// for every case that the fast kernel (float32, rank m <= 32) does not take:
// storage dtype T in {float16, bfloat16, float32, float64} and any rank m >= 0.
// The TPU kernels accumulated in promote_types(dtype, float32); so do these,
// in Acc = double for float64 and float otherwise:
//   - every input is read in T and converted to Acc once, where it is read;
//   - X^T v, C (X^T v), X s, ||u||^2 and ||w||^2 are computed in Acc;
//   - the outputs x, logq and maha are rounded to T once.
// Float32 at rank m >= d is the exception: there the register chains of
// X^T v, C (X^T v) and X s, and x itself, run in S = double (t and s are kept
// in float between the passes). Those sums are m or d long with a random,
// ill-conditioned C, and float chains leave x as far from the truth as
// cuBLAS's float32 result, past a 1e-5 tolerance (the chain's products of two
// floats are exact in double).
// Every sum runs in a fixed order and no atomics are used, so a launch
// repeats bit for bit.
//
// factor_kernel: B1, and B2 with a block of columns per factor (B2 over one
// block of columns shared by all factors is woodbury_shared.cu's). What bounds
// it: bytes (each factor's slab, X, a½ and μ read once, x written once: 2.5
// flops a byte in float64, 5 in float32 at m = 12, N = 5), and, at B = 100,
// the latency of one CTA's load and passes. It is the fast kernel's structure
// with storage-dtype staging and rank tiles:
//
//   cluster   a factor's rows are split over a cluster of CS = 1, 2, 4 or 8
//             CTAs of 256 threads (two an SM by their registers), each owning
//             a contiguous range; the plan takes the fewest that fill the
//             card, more where a CTA's slab would not leave room for a second
//             CTA on its SM (a launch of many waves keeps one CTA a factor
//             where its slab fits alone).
//   staging   a CTA's rows of X, a½, μ, (where all N columns fit) u or x, and
//             the rows of M it needs go into shared memory once, in T, by TMA
//             1-D bulk copies on an mbarrier; the unaligned head and tail of
//             each run by plain loads. Pass 3 reads the same slab, so X
//             crosses HBM once. With too many columns, u comes in blocks of a
//             round's columns by plain loads; where not even X fits at
//             CS = 8, the rows are walked in tiles, staged for pass 1 and
//             again for pass 3. B2 whitens x in place where T is Acc, and as
//             it reads it otherwise.
//   columns   rounds of NC <= kRound columns; with too few factors to fill
//             the card, the grid's y axis gives each cluster a block of whole
//             column tiles. A thread's register tile is NT = 5 columns (N a
//             multiple of 5: N = 5 and 10 run exactly) or 4.
//   pass 1    t = X^T v. A thread takes a slot, a (rank tile of kRK ranks,
//             column tile) pair, and a row part: kRK × NT sums in registers
//             over its rows, X read as a vector where the row is aligned, v
//             read as a broadcast. Row parts within a warp are summed by a
//             shuffle butterfly, then across warps in order; the CTAs'
//             partials over distributed shared memory in rank order 0..CS-1.
//   pass 2    s = M t from the staged rows of M. Up to rank kSplitM every CTA
//             forms all of s, a thread per entry summing over M's columns in
//             order; above it the cluster splits M by rows (read once a
//             factor), a warp per (row, column tile) with its lanes over M's
//             columns and a butterfly, and every CTA gathers s over
//             distributed shared memory.
//   pass 3    r = v + X s: a thread per (row, column tile), X's row from the
//             slab, s read as a broadcast, the rank sum in order. B1 writes
//             x = a½ r + μ (in place in the slab and out by one bulk store,
//             or straight to memory) and sums u², B2 sums r²; the sums go
//             warp by warp, then CTA by CTA in rank order.
//   row split B1 on a block of the rows of d (the mesh's dim axis) runs as two
//             launches in two more modes: kPartial stops after the
//             cluster's sum of pass 1 and writes t = X^T u of the block,
//             (m, N) a factor in Acc, and pass 3 sums the block's u² only
//             (nothing of a½, μ or M is staged); kResume skips pass 1,
//             reads the t and ||u||^2 summed over the blocks outside the
//             kernel, and runs passes 2 and 3 as B1 does, with logq from the
//             summed ||u||^2 and the full dimension.
//   memory    where the m × NC sums do not fit beside one row, the round
//             narrows to one column tile, then M is read from global memory
//             (after an L2 prefetch), then the sums live in a global
//             workspace the wrapper allocates, one slice a CTA of a cluster
//             of one; no rank is refused short of one row of X overflowing
//             shared memory.
//
// Plain C interface, loaded with ctypes. The Python wrapper computes each
// launch's plan (ops/kernels/woodbury_kernels.py: _general_rows_plan); the
// entry points check it against the layout below, return -1 if they
// disagree, and otherwise the CUDA error of the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 40;   // the most columns of a round
constexpr int kRK = 4;       // ranks of a pass-1 register tile
constexpr int kSplitM = 64;  // above this rank a cluster splits s = M t
constexpr int kMaxCluster = 8;
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

constexpr double kLog2Pi = 1.8378770664093453;
// factor_kernel's modes: B1, and B2 with a block of columns per factor; B1's
// partial and resume on a block of rows
constexpr int kSample = 0, kWhiten = 1, kPartial = 2, kResume = 3;
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

// TMA bulk copies and the mbarrier, as in woodbury_kernels.cu
__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ inline void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ inline void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
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

__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ inline void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// A hint: bring [src, src + bytes) into L2 (16-byte aligned, a multiple of 16).
__device__ inline void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src), "r"(bytes) : "memory");
}

// Value k of a staged run lives in shared memory at buf[pad + k], with pad
// the run's offset within 16 bytes (in values of T), so that every 16-byte
// aligned stretch of the run is aligned in shared memory too.
template <typename T>
__device__ inline int pad_of(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// The aligned middle [h, h + nb) of a run of n values with offset pad, al
// values to 16 bytes; the head [0, h) and the tail [h + nb, n) hold at most
// al − 1 values each.
struct Span {
  int h, nb;
  __device__ Span(int pad, int n, int al) {
    h = min((al - pad) % al, n);
    nb = (n - h) / al * al;
  }
};

// Write the n values of the run staged at sbuf (its pad spad) to dst: the
// aligned middle by bulk store where dst has the same offset, the rest by
// plain stores. Call with the staged values visible to all threads and to
// the async proxy.
template <typename T>
__device__ inline void store_run(T* dst, const T* sbuf, int spad, int n) {
  constexpr int AL = 16 / sizeof(T), HT = AL - 1;
  const Span sp(spad, n, AL);
  const int nb = pad_of(dst) == spad ? sp.nb : 0;
  if (threadIdx.x == 0 && nb) bulk_store(dst + sp.h, sbuf + sp.h, nb * sizeof(T));
  if (!nb)
    for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = sbuf[e];
  else if (threadIdx.x < 2 * HT) {
    const int o = threadIdx.x, e = o < HT ? o : sp.h + nb + o - HT;
    if (o < HT ? e < sp.h : e < n) dst[e] = sbuf[e];
  }
}

// Four consecutive values, 16-byte aligned (8-byte for 16-bit types), in Acc.
__device__ inline void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ inline void load4(const double* p, double (&o)[4]) {
  const double2 v0 = reinterpret_cast<const double2*>(p)[0];
  const double2 v1 = reinterpret_cast<const double2*>(p)[1];
  o[0] = v0.x; o[1] = v0.y; o[2] = v1.x; o[3] = v1.y;
}
__device__ inline void load4(const __half* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  __half2 h0, h1;
  __builtin_memcpy(&h0, &v.x, 4);
  __builtin_memcpy(&h1, &v.y, 4);
  const float2 f0 = __half22float2(h0), f1 = __half22float2(h1);
  o[0] = f0.x; o[1] = f0.y; o[2] = f1.x; o[3] = f1.y;
}
__device__ inline void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 h0, h1;
  __builtin_memcpy(&h0, &v.x, 4);
  __builtin_memcpy(&h1, &v.y, 4);
  const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
  o[0] = f0.x; o[1] = f0.y; o[2] = f1.x; o[3] = f1.y;
}

// Each value summed over the lanes that differ in the bits of 16..lo by a
// butterfly: every such lane ends with the same bits, run after run. The
// values' shuffles of one level go back to back.
template <typename A, int NV>
__device__ inline void warp_sum(A (&v)[NV], int lo = 1) {
#pragma unroll
  for (int off = 16; off >= lo; off >>= 1)
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
}

// v[lane] for lane < NV, without indexing the register array at run time.
template <typename A, int NV>
__device__ inline A lane_value(const A (&v)[NV], int lane) {
  A out = v[0];
#pragma unroll
  for (int k = 1; k < NV; ++k) out = lane == k ? v[k] : out;
  return out;
}

__host__ __device__ inline int r16(int bytes) { return (bytes + 15) & ~15; }
// m rounded up to whole rank tiles
__host__ __device__ inline int rank_pad(int m) { return (m + kRK - 1) / kRK * kRK; }
// a thread's column tile NT: N a multiple of 5 runs in tiles of 5, else of 4
__host__ __device__ inline int col_tile(int N) { return N % 5 == 0 ? 5 : 4; }
// a round's nc columns in whole column tiles
__host__ __device__ inline int col_pad(int nc, int nt) { return (nc + nt - 1) / nt * nt; }
// Pass 1's slots: the (rank tile, column tile) pairs of a round, rounded up
// to a power of two, at most one a thread. Thread t takes slot t mod L and
// row part t / L.
__host__ __device__ inline int pair_slots(int m, int nc, int nt) {
  const int pairs = rank_pad(m) / kRK * ((nc + nt - 1) / nt);
  int l = 1;
  while (l < pairs && l < kThreads) l *= 2;
  return l;
}
// Rows of M (and of s) a CTA of a cluster of cs forms: a share of them above
// rank kSplitM, where reading M once a factor matters; all of them below,
// where a second cluster barrier and a gather would cost more.
__host__ __device__ inline int s_rows(int m, int cs) {
  return cs > 1 && m > kSplitM ? (m + cs - 1) / cs : m;
}
// Pass 1's partial sums a value: one a warp where a warp holds whole row
// parts of every slot (their lanes summed first), else one a row part.
__host__ __device__ inline int row_parts(int m, int nc, int nt) {
  const int l = pair_slots(m, nc, nt);
  return l <= 32 ? kWarps : kThreads / l;
}

// Byte offsets into factor_kernel's dynamic shared memory, each array on 16
// bytes; a run staged by bulk copy gets al values (16 bytes) of slack for its
// shift. esz and asz are the bytes of T and Acc; whole: the slab holds all N
// columns of u (B1) or x (B2), else a block of a round's nc columns; mres:
// the CTA's rows of M are staged too; cs the cluster; ws: the sums tl, tp,
// tg, s and sl live in the workspace.
// ops/kernels/woodbury_kernels.py (_rows_layout) mirrors this layout.
struct RLayout {
  int bar, u, X, a, mu, M, tl, tp, tg, s, sl, qp, ql, total;
  __host__ __device__ RLayout(int esz, int asz, int tile, int m, int N, int nc, int nt, int whole,
                              int mres, int cs, int ws) {
    const int al = 16 / esz, mr = rank_pad(m), ncp = col_pad(nc, nt), ks = s_rows(m, cs);
    const int parts = row_parts(m, nc, nt), keep = 1 - ws, split = ks < m;
    int o = 0;
    bar = o; o += r16(16);                                                   // the mbarrier
    u = o;   o += r16(esz * (whole * (tile * N + al) + (1 - whole) * tile * nc));
    X = o;   o += r16(esz * (tile * m + al));
    a = o;   o += r16(esz * (tile + al));
    mu = o;  o += r16(esz * (tile + al));
    M = o;   o += r16(esz * mres * (ks * m + al));                           // this CTA's rows of M
    tl = o;  o += r16(asz * keep * mr * ncp);                                // this CTA's X^T v
    tp = o;  o += r16(asz * keep * (parts > 1) * parts * mr * ncp);          // its row parts'
    tg = o;  o += r16(asz * keep * (cs > 1) * mr * ncp);                     // the cluster's
    s = o;   o += r16(asz * keep * mr * ncp);                                // M X^T v, whole
    sl = o;  o += r16(asz * keep * split * ks * ncp);                        // this CTA's rows of it
    qp = o;  o += r16(asz * kWarps * ncp);                                   // pass-3 sums a warp
    ql = o;  o += r16(asz * ncp);                                            // the CTA's column sums
    total = o;
  }
};

// Values of Acc a CTA's slice of the workspace holds (tl, tp, tg, s, sl in
// that order, each a multiple of 4 values so that s stays 16-byte aligned).
__host__ __device__ inline int ws_values(int m, int nc, int nt, int cs) {
  const int mr = rank_pad(m), ncp = col_pad(nc, nt), ks = s_rows(m, cs);
  const int parts = row_parts(m, nc, nt), split = ks < m;
  return mr * ncp * (2 + (parts > 1) * parts + (cs > 1)) + split * ((ks * ncp + 3) & ~3);
}

// Phase stamps for tools/woodbury_general_bench.py --phases, compiled only
// with -DPFG_PHASES: thread 0 of the first cluster's rank-0 CTA, and of the
// middle cluster's, records clock64() at the end of each phase.
#ifdef PFG_PHASES
__device__ long long pfg_stamps[2][10];
#define PFG_STAMP(k)                                                                  \
  do {                                                                                \
    if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x % CS == 0) {                \
      if (blockIdx.x == 0) pfg_stamps[0][k] = clock64();                              \
      else if (blockIdx.x == gridDim.x / CS / 2 * CS) pfg_stamps[1][k] = clock64();   \
    }                                                                                 \
  } while (0)
#else
#define PFG_STAMP(k)
#endif

// One factor b per cluster; CTA `rank` of the cluster owns rows [r0, r1),
// staged in ceil((r1 − r0)/tile) tiles (one where they fit). Cluster
// (b, blockIdx.y) takes the column blocks blockIdx.y, blockIdx.y + gridDim.y,
// ... of colblk columns each, in rounds of NC. in: u (B1) or x (B2); M: C
// (B1) or Ci (B2); logdet and x_out for B1 only; col_out: logq (B1) or maha
// (B2), (B, N). B1's partial writes t_io (B, m, N) and usq_io (B, N), in Acc;
// its resume reads them, and dfull is the full dimension.
template <typename T, int MODE, int NT, typename S>
__global__ void __launch_bounds__(kThreads, 2)
factor_kernel(const T* __restrict__ in, const T* __restrict__ a_half, const T* __restrict__ X,
              const T* __restrict__ M, const T* __restrict__ mu, const T* __restrict__ logdet,
              T* __restrict__ x_out, T* __restrict__ col_out, int d, int m, int N, int tile,
              int NC, int colblk, int whole, int mres, typename Num<T>::Acc* __restrict__ ws,
              typename Num<T>::Acc* __restrict__ t_io, typename Num<T>::Acc* __restrict__ usq_io,
              int dfull) {
  using Acc = typename Num<T>::Acc;
  constexpr bool SAMPLE = MODE == kSample || MODE == kResume;  // writes x and logq
  constexpr bool PARTIAL = MODE == kPartial, RESUME = MODE == kResume;
  constexpr int AL = 16 / sizeof(T);  // values of T in 16 bytes
  constexpr int HT = AL - 1;          // the most values in a run's head, or in its tail
  // B2 whitens the staged x in place where T is the accumulation type, and
  // as it reads it otherwise
  constexpr bool kInPlace = sizeof(T) == sizeof(Acc);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int KT = (m + kRK - 1) / kRK, MR = KT * kRK, NCP = col_pad(NC, NT);
  const int L = pair_slots(m, NC, NT), parts = row_parts(m, NC, NT);
  const int ks = s_rows(m, CS);
  const bool split = ks < m;  // the cluster's CTAs form s in shares, then gather it
  const bool use_ws = ws != nullptr;
  const RLayout Lay(sizeof(T), sizeof(Acc), tile, m, N, NC, NT, whole, mres, CS, use_ws ? 1 : 0);
  PFG_STAMP(0);
  auto acc_at = [&](int off) { return reinterpret_cast<Acc*>(smem_raw + off); };
  auto t_at = [&](int off) { return reinterpret_cast<T*>(smem_raw + off); };
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + Lay.bar);

  // The sums, in shared memory or in this CTA's slice of the workspace. With
  // one row part the threads sum straight into tl; with a cluster of one, tl
  // is the cluster's t.
  const int wsv = ws_values(m, NC, NT, CS);
  Acc *tl, *tp, *tg, *s, *sl;
  if (use_ws) {
    tl = ws + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * wsv;
    tp = tl + MR * NCP;
    tg = tp + (parts > 1) * parts * MR * NCP;
    s = tg + (CS > 1) * MR * NCP;
    sl = s + MR * NCP;
  } else {
    tl = acc_at(Lay.tl); tp = acc_at(Lay.tp); tg = acc_at(Lay.tg); s = acc_at(Lay.s);
    sl = acc_at(Lay.sl);
  }
  if (parts == 1) tp = tl;
  if (CS == 1) tg = tl;
  Acc *qp = acc_at(Lay.qp), *ql = acc_at(Lay.ql);
  // element e of CTA r's copy of this CTA's array p (tl or sl), over
  // distributed shared memory (a plan with the workspace has a cluster of one)
  auto peer = [&](Acc* p, int r, int e) -> Acc {
    return r == rank ? p[e] : cluster.map_shared_rank(p, r)[e];
  };

  const size_t b = blockIdx.x / CS;
  const int R = (d + CS - 1) / CS;
  const int r0 = min(d, rank * R), r1 = min(d, r0 + R);
  const int ntiles = max(1, (r1 - r0 + tile - 1) / tile);
  const bool xres = ntiles == 1;  // X stays in shared memory for both passes
  // B1's logdet, read early so that its latency hides behind the staging
  const Acc ldb = SAMPLE && rank == 0 ? widen(logdet[b]) : Acc(0);
  // pass 2: this CTA forms rows [k0, k1) of s from the same rows of M,
  // staged with the first tile where the plan has room (mres), else read
  // from global memory, which L2 is asked for now
  const int k0 = split ? min(m, rank * ks) : 0, k1 = min(m, k0 + ks);
  const T* const Mrows = M + b * m * m + static_cast<size_t>(k0) * m;
  const T* sM = Mrows;
  if (!PARTIAL && !mres && threadIdx.x == 0 && k1 > k0) {
    const Span sp(pad_of(Mrows), (k1 - k0) * m, AL);
    if (sp.nb) prefetch_l2(Mrows + sp.h, sp.nb * sizeof(T));
  }
  // s is zero in its padding rows m..MR-1, which pass 3 reads with zero X
  for (int e = threadIdx.x; e < NCP * (MR - m); e += kThreads)
    s[e / (MR - m) * MR + m + e % (MR - m)] = Acc(0);
  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();

  uint32_t phase = 1;
  bool m_staged = PARTIAL || !mres;  // the partial reads nothing of M
  int row0 = r0, n = 0, upad = 0;
  // the tile in shared memory
  T *su = t_at(Lay.u), *sX = t_at(Lay.X), *sa = t_at(Lay.a), *smu = t_at(Lay.mu);
  bool vecX = false;

  // v = (x − μ)/a½ in place over rows [0, n) and ncols columns of p
  auto whiten = [&](T* p, int ld, int ncols) {
    for (int e = threadIdx.x; e < n * ncols; e += kThreads) {
      const int i = e / ncols, j = e - i * ncols;
      T& v = p[i * ld + j];
      v = Num<T>::narrow((widen(v) - widen(smu[i])) / widen(sa[i]));
    }
    __syncthreads();
  };

  // Stage tile t (rows row0..row0+n): X, a½, μ, with whole all N columns of u
  // or x, and the first time (mres) this CTA's rows of M. Thread 0 sends the
  // aligned middle of each run by bulk copy; the heads and tails, a value a
  // thread, are loaded first so as not to queue behind the bulk copies.
  auto stage_tile = [&](int t) {
    row0 = r0 + t * tile;
    n = max(0, min(tile, r1 - row0));
    const size_t g = b * d + row0;
    const T* const src[5] = {in + g * N, X + g * m, a_half + g, mu + g, Mrows};
    const int len[5] = {whole ? n * N : 0, n * m, PARTIAL ? 0 : n, PARTIAL ? 0 : n,
                        m_staged ? 0 : (k1 - k0) * m};
    const int off[5] = {Lay.u, Lay.X, Lay.a, Lay.mu, Lay.M};
    int pad[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) pad[k] = len[k] ? pad_of(src[k]) : 0;
    upad = pad[0];
    su = t_at(Lay.u) + pad[0]; sX = t_at(Lay.X) + pad[1]; sa = t_at(Lay.a) + pad[2];
    smu = t_at(Lay.mu) + pad[3];
    if (!m_staged) sM = t_at(Lay.M) + pad[4];
    vecX = m % kRK == 0 && pad[1] % kRK == 0;
    phase ^= 1;
    fence_async_smem();  // earlier reads and writes of the buffers come first
    __syncthreads();
    int hk = -1, hi = 0;
    T hv = T();
    if (threadIdx.x >= 1 && threadIdx.x <= 5 * 2 * HT) {
      const int k = (threadIdx.x - 1) / (2 * HT), o = (threadIdx.x - 1) % (2 * HT);
      const Span sp(pad[k], len[k], AL);
      hi = o < HT ? o : sp.h + sp.nb + o - HT;
      if (o < HT ? hi < sp.h : hi < len[k]) {
        hk = k;
        hv = src[k][hi];
      }
    }
    if (threadIdx.x == 0) {
      bulk_wait_read();
      uint32_t bytes = 0;
#pragma unroll
      for (int k = 0; k < 5; ++k) bytes += sizeof(T) * Span(pad[k], len[k], AL).nb;
      mbar_arrive_expect(bar, bytes);
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const Span sp(pad[k], len[k], AL);
        if (sp.nb) bulk_load(t_at(off[k]) + pad[k] + sp.h, src[k] + sp.h, sp.nb * sizeof(T), bar);
      }
    }
    if (hk >= 0) t_at(off[hk])[pad[hk] + hi] = hv;
    m_staged = true;
    mbar_wait(bar, phase);
    __syncthreads();
    if constexpr (MODE == kWhiten && kInPlace)
      if (whole) whiten(su, N, N);
  };

  // Columns [c0, c0 + nc) of the tile's rows by plain loads, into a block of
  // row stride NC.
  auto stage_block = [&](int c0, int nc) {
    __syncthreads();  // earlier readers of the block are done
    T* dst = t_at(Lay.u);
    const T* src = in + (b * d + row0) * N + c0;
    for (int e = threadIdx.x; e < n * nc; e += kThreads) {
      const int i = e / nc, j = e - i * nc;
      dst[i * NC + j] = src[static_cast<size_t>(i) * N + j];
    }
    __syncthreads();
    if constexpr (MODE == kWhiten && kInPlace) whiten(dst, NC, nc);
  };

  // X[i, kt·kRK .. kt·kRK + kRK) of the tile, zero past m
  auto x_tile = [&](int i, int kt, Acc (&xk)[kRK]) {
    const T* row = sX + i * m + kt * kRK;
    if (vecX) {
      load4(row, xk);
    } else {
#pragma unroll
      for (int kk = 0; kk < kRK; ++kk) xk[kk] = kt * kRK + kk < m ? widen(row[kk]) : Acc(0);
    }
  };

  if (xres) stage_tile(0);
  PFG_STAMP(1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = threadIdx.x % L, part = threadIdx.x / L, P = kThreads / L;
  const int nblk = (N + colblk - 1) / colblk;
  for (int blk = blockIdx.y; blk < nblk; blk += gridDim.y) {
    const int cend = min(N, (blk + 1) * colblk);
    for (int c0 = blk * colblk; c0 < cend; c0 += NC) {
      const int nc = min(NC, cend - c0), CT = (nc + NT - 1) / NT;
      // the round's v (u for B1) at row i, column j of the round
      const T* const ub = whole ? su + c0 : t_at(Lay.u);
      const int ldu = whole ? N : NC;
      auto v_at = [&](int i, int j) -> Acc {
        const Acc raw = widen(ub[i * ldu + j]);
        if constexpr (MODE == kWhiten && !kInPlace) return (raw - widen(smu[i])) / widen(sa[i]);
        else return raw;
      };
      auto stage = [&](int t) {
        stage_tile(t);
        if (!whole) stage_block(c0, nc);
      };
      if (xres && !whole) stage_block(c0, nc);
      for (int e = threadIdx.x; e < kWarps * NCP; e += kThreads) qp[e] = Acc(0);
      if (m > 0)
        for (int e = threadIdx.x; e < parts * MR * NCP; e += kThreads) tp[e] = Acc(0);
      __syncthreads();

      if (m > 0 && RESUME) {  // the t summed over the row blocks, in tg's layout
        for (int e = threadIdx.x; e < CT * NT * MR; e += kThreads) {
          const int c = e / MR, k = e - c * MR;
          tg[e] = k < m && c < nc ? t_io[(b * m + k) * N + c0 + c] : Acc(0);
        }
        __syncthreads();
      } else if (m > 0) {
        // pass 1: t = X^T v. Thread (part, slot) sums, for each pair q ≡ slot
        // (mod L) of rank tile kt and column tile ct, X[i, kt] v[i, ct] over
        // its rows i ≡ part (mod P); where a warp holds several row parts of
        // a slot (L < 32) their lanes are summed by a butterfly first.
        for (int t = 0; t < ntiles; ++t) {
          if (!xres) stage(t);
          for (int q0 = 0; q0 < KT * CT; q0 += L) {  // the same trips for the whole CTA
            const int q = q0 + slot, kt = q % KT, ct = q / KT;
            const bool mine = q < KT * CT;
            // the thread's sums; where it owns them alone (L >= 32) they go on
            // from the earlier tiles', one chain over all its rows
            Acc* const dst = tp + (L <= 32 ? warp : part) * MR * NCP + ct * NT * MR + kt * kRK;
            S acc[kRK * NT];
#pragma unroll
            for (int kk = 0; kk < kRK; ++kk)
#pragma unroll
              for (int j = 0; j < NT; ++j)
                acc[kk * NT + j] = L >= 32 && mine ? S(dst[j * MR + kk]) : S(0);
            if (mine)
#pragma unroll 2
              for (int i = part; i < n; i += P) {
                Acc xk[kRK], v[NT];
                x_tile(i, kt, xk);
#pragma unroll
                for (int j = 0; j < NT; ++j)
                  v[j] = ct * NT + j < nc ? v_at(i, ct * NT + j) : Acc(0);
#pragma unroll
                for (int kk = 0; kk < kRK; ++kk)
#pragma unroll
                  for (int j = 0; j < NT; ++j)
                    acc[kk * NT + j] = mad(S(xk[kk]), S(v[j]), acc[kk * NT + j]);
              }
            if (L < 32) warp_sum(acc, L);
            if (mine && (L >= 32 || lane < L))
#pragma unroll
              for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int kk = 0; kk < kRK; ++kk)
                  dst[j * MR + kk] = L >= 32 ? Acc(acc[kk * NT + j])
                                             : dst[j * MR + kk] + Acc(acc[kk * NT + j]);
          }
        }
        __syncthreads();
        PFG_STAMP(2);
        if (parts > 1)
          for (int e = threadIdx.x; e < MR * NCP; e += kThreads) {
            Acc a = tp[e];
            for (int p = 1; p < parts; ++p) a += tp[p * MR * NCP + e];
            tl[e] = a;
          }
        if (CS > 1) {  // the cluster's t: the CTAs' partials in rank order
          cluster.sync();
          for (int e = threadIdx.x; e < MR * CT * NT; e += kThreads) {
            Acc v[kMaxCluster];  // the loads first, then the sums in order
#pragma unroll
            for (int r = 0; r < kMaxCluster; ++r) v[r] = r < CS ? peer(tl, r, e) : Acc(0);
            Acc a = v[0];
#pragma unroll
            for (int r = 1; r < kMaxCluster; ++r)
              if (r < CS) a += v[r];
            tg[e] = a;
          }
        }
        __syncthreads();
        PFG_STAMP(3);
        if (PARTIAL && rank == 0)  // the block's t, for the sum over the blocks
          for (int e = threadIdx.x; e < m * nc; e += kThreads) {
            const int k = e / nc, c = e - k * nc;
            t_io[(b * m + k) * N + c0 + c] = tg[c * MR + k];
          }
      }
      if (m > 0 && !PARTIAL) {
        // pass 2: rows [k0, k1) of s = M t. Where the CTA forms all of s (m <=
        // kSplitM), a thread per entry (k, c) sums over M's columns l in
        // order; else a warp per (row k, column tile ct), its lanes over l.
        Acc* sd = split ? sl : s;
        const int lds = split ? ks : MR;
        if (!split)  // neighbouring threads take neighbouring columns c: M read as a broadcast
          for (int e = threadIdx.x; e < m * CT * NT; e += kThreads) {
            const int k = e / (CT * NT), c = e - k * (CT * NT);
            const T* Mk = sM + k * m;
            const Acc* tc = tg + c * MR;
            S acc = S(0);
#pragma unroll 4
            for (int l = 0; l < m; ++l) acc = mad(S(widen(Mk[l])), S(tc[l]), acc);
            s[c * MR + k] = Acc(acc);
          }
        for (int e = warp; split && e < (k1 - k0) * CT; e += kWarps) {
          const int kr = e / CT, ct = e - kr * CT;
          const T* Mk = sM + kr * m;
          S acc[NT];
#pragma unroll
          for (int j = 0; j < NT; ++j) acc[j] = S(0);
          for (int l = lane; l < m; l += 32) {
            const S mkl = S(widen(Mk[l]));
#pragma unroll
            for (int j = 0; j < NT; ++j) acc[j] = mad(mkl, S(tg[(ct * NT + j) * MR + l]), acc[j]);
          }
          warp_sum(acc);
          if (lane < NT) sd[(ct * NT + lane) * lds + kr] = Acc(lane_value(acc, lane));
        }
        PFG_STAMP(4);
        if (split) {  // every CTA gathers the whole of s
          cluster.sync();
          for (int e = threadIdx.x; e < CT * NT * MR; e += kThreads) {
            const int c = e / MR, k = e - c * MR;
            s[e] = k < m ? peer(sl, k / ks, c * ks + k % ks) : Acc(0);
          }
        }
        __syncthreads();
        PFG_STAMP(5);
      }

      // pass 3: r = v + X s; thread item (column tile ct, row i), rows padded
      // to whole warps so that a warp's items share ct.
      for (int t = 0; t < ntiles; ++t) {
        if (!xres) stage(t);
        const int npad = (n + 31) & ~31;
        T* const xg = x_out + (b * d + row0) * N + c0;  // B1's x, rows of this tile
        T* const ubw = su + c0;                          // or in place in the slab (whole)
        Acc q[NT];
        int cur = -1;
        for (int e = threadIdx.x; e < CT * npad; e += kThreads) {
          const int ct = e / npad, i = e - ct * npad;
          if (ct != cur) {
            if (cur >= 0) {
              warp_sum(q);
              if (lane < NT) qp[warp * NCP + cur * NT + lane] += lane_value(q, lane);
            }
            cur = ct;
#pragma unroll
            for (int j = 0; j < NT; ++j) q[j] = Acc(0);
          }
          if (i >= n) continue;
          Acc r[NT];
          S xs[NT];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            r[j] = ct * NT + j < nc ? v_at(i, ct * NT + j) : Acc(0);
            xs[j] = S(0);
          }
          for (int kt = 0; kt < (PARTIAL ? 0 : KT); ++kt) {
            Acc xk[kRK];
            x_tile(i, kt, xk);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              Acc s4[kRK];
              load4(s + (ct * NT + j) * MR + kt * kRK, s4);
#pragma unroll
              for (int kk = 0; kk < kRK; ++kk) xs[j] = mad(S(xk[kk]), S(s4[kk]), xs[j]);
            }
          }
          if constexpr (SAMPLE) {
            const S ai = S(widen(sa[i])), mi = S(widen(smu[i]));
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              q[j] = mad(r[j], r[j], q[j]);
              if (ct * NT + j < nc) {
                const T xv = Num<T>::narrow(Acc(ai * (S(r[j]) + xs[j]) + mi));
                if (whole) ubw[i * ldu + ct * NT + j] = xv;
                else xg[static_cast<size_t>(i) * N + ct * NT + j] = xv;
              }
            }
          } else if constexpr (PARTIAL) {
#pragma unroll
            for (int j = 0; j < NT; ++j) q[j] = mad(r[j], r[j], q[j]);
          } else {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const Acc w = Acc(S(r[j]) + xs[j]);
              q[j] = mad(w, w, q[j]);
            }
          }
        }
        if (cur >= 0) {
          warp_sum(q);
          if (lane < NT) qp[warp * NCP + cur * NT + lane] += lane_value(q, lane);
        }
      }
      __syncthreads();
      PFG_STAMP(6);
      for (int c = threadIdx.x; c < nc; c += kThreads) {
        Acc a = qp[c];
        for (int w = 1; w < kWarps; ++w) a += qp[w * NCP + c];
        ql[c] = a;
      }
      if (SAMPLE && whole && c0 + nc == N) {  // x goes out while the sums are exchanged
        fence_async_smem();
        __syncthreads();
        store_run(x_out + (b * d + r0) * N, su, upad, n * N);
      }
      if (CS > 1) cluster.sync();
      else __syncthreads();
      if (rank == 0)
        for (int c = threadIdx.x; c < nc; c += kThreads) {
          Acc q = ql[c];
          for (int r = 1; r < CS; ++r) q += cluster.map_shared_rank(ql, r)[c];
          if constexpr (PARTIAL) {
            usq_io[b * N + c0 + c] = q;
          } else {
            // the resume's logq from the summed ||u||^2 and the full dimension
            const Acc out = RESUME ? Acc(-0.5) * (Acc(dfull) * Acc(kLog2Pi) + ldb +
                                                  usq_io[b * N + c0 + c])
                            : SAMPLE ? Acc(-0.5) * (Acc(d) * Acc(kLog2Pi) + ldb + q) : q;
            col_out[b * N + c0 + c] = Num<T>::narrow(out);
          }
        }
      // with no X^T v to exchange a round has one cluster barrier only: a
      // second keeps a CTA from writing its next sums while rank 0 reads these
      if (CS > 1 && (m == 0 || RESUME)) cluster.sync();
      PFG_STAMP(7);
    }
  }
  if (CS > 1) cluster.sync();  // no CTA leaves while another reads its shared memory
  if (threadIdx.x == 0) bulk_wait_read();
  PFG_STAMP(8);
}

// factor_kernel's plan: cluster size, threads, rows a tile, columns a round,
// columns a block, whether the slab holds all N columns, whether the CTA's
// rows of M are staged, shared memory bytes
struct FPlan {
  int cluster, threads, tile, nc, colblk, whole, mres, smem;
};

// The plan the wrapper computed, checked against factor_kernel's layout.
template <typename T>
bool fplan_ok(const FPlan& p, int B, int d, int m, int N, bool ws) {
  using Acc = typename Num<T>::Acc;
  if (B < 1 || d < 1 || m < 0 || N < 1) return false;
  if (p.threads != kThreads || p.cluster < 1 || p.cluster > kMaxCluster) return false;
  if (p.cluster & (p.cluster - 1)) return false;
  const int rows = (d + p.cluster - 1) / p.cluster;
  if (p.tile < 1 || p.tile > rows || p.nc < 1 || p.nc > kRound) return false;
  if (p.colblk < p.nc || p.colblk > N || (p.whole != 0 && p.whole != 1)) return false;
  if (p.mres != 0 && p.mres != 1) return false;
  if (p.whole && (p.colblk != N || p.tile != rows)) return false;
  if (p.smem < 0 || p.smem > kMaxSmem || (ws && p.cluster != 1)) return false;
  const RLayout L(sizeof(T), sizeof(Acc), p.tile, m, N, p.nc, col_tile(N), p.whole, p.mres,
                  p.cluster, ws ? 1 : 0);
  return p.smem == L.total;
}

// The pointers and ints every mode passes on to factor_kernel.
struct FArgs {
  const void *in, *a_half, *X, *M, *mu, *logdet;
  void *x_out, *col_out, *ws, *t_io, *usq_io;
  int d, m, N, dfull;
};

template <typename T, int MODE, int NT, typename S>
int launch_factor(const FPlan& p, int B, const FArgs& a, cudaStream_t stream) {
  using Acc = typename Num<T>::Acc;
  auto kernel = factor_kernel<T, MODE, NT, S>;
  static std::atomic<unsigned long long> ready{0};
  if (const cudaError_t e = allow_max_smem(kernel, ready); e != cudaSuccess) {
    return static_cast<int>(e);
  }
  const int nblk = (a.N + p.colblk - 1) / p.colblk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.cluster, nblk < 65535 ? nblk : 65535);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.in), static_cast<const T*>(a.a_half),
      static_cast<const T*>(a.X), static_cast<const T*>(a.M), static_cast<const T*>(a.mu),
      static_cast<const T*>(a.logdet), static_cast<T*>(a.x_out), static_cast<T*>(a.col_out), a.d,
      a.m, a.N, p.tile, p.nc, p.colblk, p.whole, p.mres, static_cast<Acc*>(a.ws),
      static_cast<Acc*>(a.t_io), static_cast<Acc*>(a.usq_io), a.dfull);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int MODE, typename S>
int launch_tile(const FPlan& p, int B, const FArgs& a, cudaStream_t stream) {
  if (col_tile(a.N) == 5) return launch_factor<T, MODE, 5, S>(p, B, a, stream);
  return launch_factor<T, MODE, 4, S>(p, B, a, stream);
}

template <typename T, int MODE>
int launch_checked(const FPlan& p, int B, const FArgs& a, cudaStream_t stream) {
  if (!fplan_ok<T>(p, B, a.d, a.m, a.N, a.ws != nullptr)) return -1;
  if constexpr (std::is_same_v<T, float>) {
    // the register chains in double (see the head of this file); a block of
    // rows takes the instantiation of its full dimension
    if (a.m >= a.dfull) return launch_tile<T, MODE, double>(p, B, a, stream);
  }
  return launch_tile<T, MODE, typename Num<T>::Acc>(p, B, a, stream);
}

template <int MODE>
int dispatch_factor(int dtype, const FPlan& p, int B, const FArgs& a, cudaStream_t stream) {
#define PF_CASE(CODE, T) \
  case CODE:             \
    return launch_checked<T, MODE>(p, B, a, stream);
  switch (dtype) {
    PF_CASE(kF32, float) PF_CASE(kF64, double) PF_CASE(kF16, __half) PF_CASE(kBF16, __nv_bfloat16)
  }
#undef PF_CASE
  return -1;
}

}  // namespace

extern "C" {

int pfg_round() { return kRound; }

int pfg_sample_logq(int dtype, const void* u, const void* a_half, const void* X, const void* C,
                    const void* mu, const void* logdet, void* x, void* logq, int B, int d, int m,
                    int N, int cluster, int threads, int tile, int nc, int colblk, int whole,
                    int mres, int smem, void* ws, cudaStream_t stream) {
  const FArgs a{u, a_half, X, C, mu, logdet, x, logq, ws, nullptr, nullptr, d, m, N, d};
  return dispatch_factor<kSample>(dtype, {cluster, threads, tile, nc, colblk, whole, mres, smem},
                                  B, a, stream);
}

int pfg_whiten_sumsq(int dtype, const void* x, const void* a_half, const void* X, const void* Ci,
                     const void* mu, void* maha, int B, int d, int m, int N, int cluster,
                     int threads, int tile, int nc, int colblk, int whole, int mres, int smem,
                     void* ws, cudaStream_t stream) {
  const FArgs a{x, a_half, X, Ci, mu, nullptr, nullptr, maha, ws, nullptr, nullptr, d, m, N, d};
  return dispatch_factor<kWhiten>(dtype, {cluster, threads, tile, nc, colblk, whole, mres, smem},
                                  B, a, stream);
}

// B1's partial on a block of d rows: t (B, m, N) and usq (B, N) in the
// accumulation type. Nothing of a½, μ or C is read; X stands in for their
// pointers. dfull is the full dimension: it picks the instantiation, the
// resume's.
int pfg_sample_partial(int dtype, const void* u, const void* X, void* t, void* usq, int B, int d,
                       int m, int N, int dfull, int cluster, int threads, int tile, int nc,
                       int colblk, int whole, int mres, int smem, void* ws,
                       cudaStream_t stream) {
  const FArgs a{u, X, X, X, X, nullptr, nullptr, nullptr, ws, t, usq, d, m, N, dfull};
  return dispatch_factor<kPartial>(dtype, {cluster, threads, tile, nc, colblk, whole, mres, smem},
                                   B, a, stream);
}

// B1's resume on a block of d rows from the t and usq summed over the blocks;
// dfull is the full dimension, for logq.
int pfg_sample_resume(int dtype, const void* u, const void* a_half, const void* X, const void* C,
                      const void* mu, const void* logdet, const void* t, const void* usq, void* x,
                      void* logq, int B, int d, int m, int N, int dfull, int cluster,
                      int threads, int tile, int nc, int colblk, int whole, int mres, int smem,
                      void* ws, cudaStream_t stream) {
  const FArgs a{u, a_half, X, C, mu, logdet, x, logq, ws, const_cast<void*>(t),
                const_cast<void*>(usq), d, m, N, dfull};
  return dispatch_factor<kResume>(dtype, {cluster, threads, tile, nc, colblk, whole, mres, smem},
                                  B, a, stream);
}

#ifdef PFG_PHASES
// The phase stamps of the last launch: 2 × 10 values into out.
int pfg_read_stamps(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, pfg_stamps, sizeof(pfg_stamps)));
}
#endif

}  // extern "C"
