// Woodbury sample+logq (B1) and whiten+sumsq (B2) for Hopper (sm_90a).
//
// They replace the two Pallas TPU kernels of the JAX package,
// pathfinder_tpu/ops/pallas/woodbury_kernels.py at commit c548d16^:
//   B1  _sample_kernel  (:70, pl.pallas_call at :96)
//       x = a½ ∘ (u + X (C (Xᵀ u))) + μ  and  logq = −(d·log2π + logdet + ‖u‖²)/2
//   B2  _whiten_kernel  (:146, pl.pallas_call at :167)
//       v = (x − μ)/a½,  w = v + X (Ci (Xᵀ v)),  maha = ‖w‖²
// per column of a (d, N) block, for a batch of B independent factors.
//
// What bounds them: bytes. Each factor's slab, u or x (d·N), X (d·m), a½ and
// μ (d each), is read once, and B1 writes x (d·N) once: at m = 12, N = 5
// that is 19 floats read and 5 written per row against 4m·N = 240 flops,
// 2.5 flops per byte, far below the card's balance point, so the floor is
// the HBM rate. The design moves each byte once and keeps the card busy:
//
//   staging   the CTA's rows of the slab, and M, go into shared memory once
//             by TMA 1-D bulk copies completing on an mbarrier. A run whose
//             start or length is not 16-byte aligned has its head and tail
//             (at most 3 + 3 floats) loaded by plain loads, issued before
//             the bulk copies so as not to queue behind them. Both passes
//             then read shared memory only; B1 writes x in place and sends
//             it out with one bulk store.
//   cluster   a factor is split over a cluster of CS = 1, 2, 4 or 8 CTAs,
//             each owning a contiguous range of rows, so that B = 100
//             factors still give every SM a CTA. Each CTA reduces its rows'
//             partial Xᵀv into shared memory; after cluster.sync() every CTA
//             sums the CS partials over distributed shared memory in rank
//             order 0..CS−1, forms s = M t itself and runs pass 2 on its own
//             rows. The ‖·‖² column sums are exchanged the same way. No
//             atomics, so results repeat bitwise.
//   tiles     where a CTA's rows do not fit in shared memory even at CS = 8,
//             the launch plan gives a smaller tile: the kernel stages the
//             rows tile by tile in pass 1 and again in pass 2, and writes x
//             straight to memory.
//   registers pass 1 gives each warp 4 rank rows and a share of the rows
//             (4·NT accumulators a thread); pass 2 gives each thread whole
//             rows, with the NT products X s side by side. The kernel is
//             templated on m rounded up to a multiple of 4 (MR) and on the
//             column tile NT = 5 (N a multiple of 5: the main path's N = 5
//             and N = 10 have exact tiles) or 4, and on the epilogue.
//   no tensor cores  at 2.5 flops per byte wgmma would only wait on memory,
//             and the 1e-5 f32 tolerances rule out TF32.
//
// B1 and B2 are one kernel template with two epilogues: B1 writes x and
// logq (‖u‖² summed in pass 2), B2 sums ‖w‖² and writes it.
//
// Plain C interface, loaded with ctypes. The Python wrapper computes the
// launch plan (cluster size, threads, shared memory bytes, tile rows); the
// entry points check it against the kernel's own layout, return -1 if they
// disagree, and otherwise the CUDA error of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRank = 32;
constexpr int kChunk = 40;  // columns handled per round of the kernel
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;
constexpr float kLog2Pi = 1.8378770664093453f;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
// the rank the kernel is instantiated for: m rounded up to a multiple of 4
__host__ __device__ inline int rank_tile(int m) { return m < 4 ? 4 : round4(m); }

// Offsets, in floats, into the dynamic shared memory. Each array starts on
// 16 bytes; a staged run gets 4 floats of slack for its alignment shift.
// ops/kernels/woodbury_kernels.py (_smem_bytes) mirrors this layout.
struct Layout {
  int u, X, a, mu, M, tp, tl, tg, s, qp, ql, total;
  __host__ __device__ Layout(int tile, int m, int N, int mr, int parts, int warps) {
    const int nc = N < kChunk ? N : kChunk;
    int o = 4;  // the mbarrier
    u = o;  o += round4(tile * N + 4);
    X = o;  o += round4(tile * m + 4);
    a = o;  o += round4(tile + 4);
    mu = o; o += round4(tile + 4);
    M = o;  o += round4(m * m + 4);
    tp = o; o += round4(parts * mr * nc);  // pass-1 partials, one set per row part
    tl = o; o += round4(mr * nc);          // this CTA's Xᵀv, read by the cluster
    tg = o; o += round4(mr * nc);          // the cluster's Xᵀv
    s = o;  o += round4(mr * (nc + 4));    // M Xᵀv, column-major, 4 zero columns on
    qp = o; o += round4(warps * nc);       // pass-2 partials, one set per warp
    ql = o; o += round4(nc);               // this CTA's column sums
    total = o;
  }
};

__host__ __device__ inline int col_tile(int N) { return N % 5 == 0 ? 5 : 4; }
// row parts P per rank group in pass 1: the CTA has (MR/4)·P ≤ 8 warps
__host__ __device__ constexpr int row_parts(int mr) { return 32 / mr > 1 ? 32 / mr : 1; }
__host__ __device__ constexpr int cta_threads(int mr) { return 8 * mr * row_parts(mr); }

// -- TMA bulk copies and the mbarrier ----------------------------------------

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

__device__ inline void bulk_load(float* dst, const float* src, int n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(n * 4), "r"(smem_addr(bar)) : "memory");
}

__device__ inline void bulk_store(float* dst, const float* src, int n) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(n * 4) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Element k of a staged run lives in shared memory at buf[pad + k], with pad
// the run's offset within 16 bytes, so that every 16-byte aligned stretch of
// the run is aligned in shared memory too and can move by bulk copy.
__device__ inline int pad_of(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The aligned middle [h, h + nb) of the elements [k0, k1) of a run with
// offset pad; the head [k0, h) and the tail [h + nb, k1) hold at most 3 each.
struct Span {
  int h, nb;
  __device__ Span(int pad, int k0, int k1) {
    h = min(k0 + ((4 - ((pad + k0) & 3)) & 3), k1);
    nb = (k1 - h) & ~3;
  }
};

// Write the n floats of the run staged at sbuf (its pad spad) to dst: the
// aligned middle by bulk store where dst has the same offset, the rest by
// plain stores. Call with the staged values visible to all threads and to
// the async proxy.
__device__ inline void store_run(float* dst, const float* sbuf, int spad, int n) {
  const Span sp(spad, 0, n);
  const int nb = pad_of(dst) == spad ? sp.nb : 0;
  if (threadIdx.x == 0 && nb) bulk_store(dst + sp.h, sbuf + sp.h, nb);
  if (!nb)
    for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = sbuf[e];
  else if (threadIdx.x < 6) {
    const int o = threadIdx.x, e = o < 3 ? o : sp.h + nb + o - 3;
    if (o < 3 ? e < sp.h : e < n) dst[e] = sbuf[e];
  }
}

template <int NV>
__device__ inline void warp_sum(float (&v)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
}

// Pass 1 over the n rows: acc[kk][j] += X[i, 4g + kk] v[i, col + j].
// Warp w owns rank rows 4g..4g+3 (g = w mod MR/4) and every P-th group of
// 32 rows (p = w div MR/4).
template <int MR, int NT>
__device__ inline void pass1_rows(float (&acc)[4 * NT], const float* __restrict__ su,
                                  const float* __restrict__ sX, bool vecX, int n, int N, int m,
                                  int col, int nt) {
  constexpr int G = MR / 4;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = w % G, p = w / G, P = (blockDim.x >> 5) / G;
#pragma unroll 2
  for (int i = p * 32 + lane; i < n; i += P * 32) {
    float uv[NT], xk[4];
    const float* ur = su + i * N + col;
#pragma unroll
    for (int j = 0; j < NT; ++j) uv[j] = j < nt ? ur[j] : 0.f;
    if (vecX) {
      const float4 v = *reinterpret_cast<const float4*>(sX + i * m + 4 * g);
      xk[0] = v.x; xk[1] = v.y; xk[2] = v.z; xk[3] = v.w;
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) xk[kk] = 4 * g + kk < m ? sX[i * m + 4 * g + kk] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[kk * NT + j] = fmaf(xk[kk], uv[j], acc[kk * NT + j]);
  }
}

// v[lane] for lane < NV, without indexing the register array at run time.
template <int NV>
__device__ inline float lane_value(const float (&v)[NV], int lane) {
  float out = v[0];
#pragma unroll
  for (int k = 1; k < NV; ++k) out = lane == k ? v[k] : out;
  return out;
}

// tp[p][k][c] += the warp's sums: lane kk·NT + j adds one of them.
template <int MR, int NT>
__device__ inline void pass1_flush(float (&acc)[4 * NT], float* tp, int NC, int cc, int nt) {
  constexpr int G = MR / 4;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = w % G, p = w / G;
  warp_sum(acc);
  const int kk = lane / NT, j = lane % NT;
  const float v = lane_value(acc, lane);
  if (lane < 4 * NT && j < nt) tp[(p * MR + 4 * g + kk) * NC + cc + j] += v;
}

// Pass 2 over the n rows: r = v + X s for columns col..col+nt. B1 sums
// ‖u‖² into q and writes x = a½ r + μ in place (gx == nullptr) or to gx; B2
// sums ‖r‖² into q. One thread per row; the NT products X s run side by
// side, k outermost, so that their FMA chains overlap. Where s is small
// (MR·NT ≤ 64: the main path's 12 × 5) every thread holds it in registers.
template <int MR, int NT, bool SAMPLE>
__device__ inline void pass2_rows(float (&q)[NT], float* __restrict__ su,
                                  const float* __restrict__ sX, const float* __restrict__ sa,
                                  const float* __restrict__ smu, bool vecX, int n, int N,
                                  int m, int col, const float* __restrict__ s, int nt,
                                  float* __restrict__ gx) {
  constexpr bool kHold = MR * NT <= 64;
  float sr[kHold ? MR * NT : 1];
  if constexpr (kHold) {
#pragma unroll
    for (int e = 0; e < MR * NT; ++e) sr[e] = s[e];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float* ur = su + i * N + col;
    float r[NT], xs[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      r[j] = j < nt ? ur[j] : 0.f;
      xs[j] = 0.f;
    }
#pragma unroll(MR <= 16 ? MR / 4 : 2)
    for (int k4 = 0; k4 < MR / 4; ++k4) {
      float xk[4];
      if (vecX) {
        const float4 v = *reinterpret_cast<const float4*>(sX + i * m + 4 * k4);
        xk[0] = v.x; xk[1] = v.y; xk[2] = v.z; xk[3] = v.w;
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) xk[kk] = 4 * k4 + kk < m ? sX[i * m + 4 * k4 + kk] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // s holds NT columns of MR (zero where k >= m), so j >= nt reads zeros
        float4 sv;
        if constexpr (kHold)
          sv = make_float4(sr[j * MR + 4 * k4], sr[j * MR + 4 * k4 + 1], sr[j * MR + 4 * k4 + 2],
                           sr[j * MR + 4 * k4 + 3]);
        else
          sv = *reinterpret_cast<const float4*>(s + j * MR + 4 * k4);
        xs[j] = fmaf(xk[0], sv.x, xs[j]);
        xs[j] = fmaf(xk[1], sv.y, xs[j]);
        xs[j] = fmaf(xk[2], sv.z, xs[j]);
        xs[j] = fmaf(xk[3], sv.w, xs[j]);
      }
    }
    if (SAMPLE) {
      const float a = sa[i], mv = smu[i];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        q[j] = fmaf(r[j], r[j], q[j]);
        if (j < nt) {
          const float xv = a * (r[j] + xs[j]) + mv;
          if (gx) gx[i * N + col + j] = xv;
          else ur[j] = xv;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) q[j] = fmaf(r[j] + xs[j], r[j] + xs[j], q[j]);
    }
  }
}

// qp[warp][c] += the warp's sums: lane j adds column j.
template <int NT>
__device__ inline void pass2_flush(float (&q)[NT], float* qp, int NC, int cc, int nt) {
  const int lane = threadIdx.x & 31;
  warp_sum(q);
  const float v = lane_value(q, lane);
  if (lane < nt) qp[(threadIdx.x >> 5) * NC + cc + lane] += v;
}

// One factor b per cluster; CTA `rank` of the cluster owns rows [r0, r1),
// staged in ceil((r1 − r0)/tile) tiles (one where they fit).
// in: u (B1) or x (B2); M: C (B1) or Ci (B2); logdet and x_out for B1 only;
// col_out: logq (B1) or maha (B2).
template <int MR, int NT, bool SAMPLE>
__global__ void __launch_bounds__(cta_threads(MR), 2)
woodbury_kernel(const float* __restrict__ in, const float* __restrict__ a_half,
                const float* __restrict__ X, const float* __restrict__ M,
                const float* __restrict__ mu, const float* __restrict__ logdet,
                float* __restrict__ x_out, float* __restrict__ col_out,
                int d, int m, int N, int tile) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warps = blockDim.x >> 5, parts = warps / (MR / 4);
  const int NC = min(N, kChunk);
  const Layout L(tile, m, N, MR, parts, warps);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  float *tp = sm + L.tp, *tl = sm + L.tl, *tg = sm + L.tg, *s = sm + L.s;
  float *qp = sm + L.qp, *ql = sm + L.ql;

  const size_t b = blockIdx.x / CS;
  const int R = (d + CS - 1) / CS;
  const int r0 = min(d, rank * R), r1 = min(d, r0 + R);
  const int ntiles = max(1, (r1 - r0 + tile - 1) / tile);
  const bool resident = ntiles == 1;
  // B1's logdet, read early so that its latency hides behind the staging
  const float ldb = SAMPLE && rank == 0 ? logdet[b] : 0.f;

  // a cluster of one needs no cluster barrier and no distributed shared memory
  auto cluster_sync = [&] {
    if (CS > 1) cluster.sync();
    else __syncthreads();
  };
  auto peer = [&](float* p, int r) { return CS > 1 ? cluster.map_shared_rank(p, r) : p; };

  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  float* const buf[5] = {sm + L.u, sm + L.X, sm + L.a, sm + L.mu, sm + L.M};
  int pad[5];
  uint32_t phase = 1;
  int row0 = r0, n = 0;
  // the tile in shared memory: buf + pad
  float *su = buf[0], *sX = buf[1], *sa = buf[2], *smu = buf[3], *sM = buf[4];
  bool vecX = false;

  // Stage tile t (rows row0..row0+n) and M: thread 0 sends the aligned
  // middle of each run by bulk copy; the heads and tails (at most 3 + 3
  // elements a run), one element a thread, are loaded first so as not to
  // queue behind the bulk copies. B2 then whitens the rows in place.
  auto stage_tile = [&](int t) {
    row0 = r0 + t * tile;
    n = min(tile, r1 - row0);
    const size_t g = b * d + row0;
    const float* const src[5] = {in + g * N, X + g * m, a_half + g, mu + g, M + b * m * m};
    const int len[5] = {n * N, n * m, n, n, m * m};
#pragma unroll
    for (int k = 0; k < 5; ++k) pad[k] = pad_of(src[k]);
    su = buf[0] + pad[0]; sX = buf[1] + pad[1]; sa = buf[2] + pad[2]; smu = buf[3] + pad[3];
    sM = buf[4] + pad[4];
    vecX = m == MR && pad[1] == 0;
    phase ^= 1;
    fence_async_smem();  // earlier reads and writes of the buffers come first
    __syncthreads();
    int hk = -1, hi = 0;
    float hv = 0.f;
    if (threadIdx.x >= 1 && threadIdx.x <= 5 * 6) {
      const int k = (threadIdx.x - 1) / 6, o = (threadIdx.x - 1) % 6;
      const Span sp(pad[k], 0, len[k]);
      hi = o < 3 ? o : sp.h + sp.nb + o - 3;
      if (o < 3 ? hi < sp.h : hi < len[k]) {
        hk = k;
        hv = src[k][hi];
      }
    }
    if (threadIdx.x == 0) {
      bulk_wait_read();
      uint32_t bytes = 0;
#pragma unroll
      for (int k = 0; k < 5; ++k) bytes += 4u * Span(pad[k], 0, len[k]).nb;
      mbar_arrive_expect(bar, bytes);
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const Span sp(pad[k], 0, len[k]);
        if (sp.nb) bulk_load(buf[k] + pad[k] + sp.h, src[k] + sp.h, sp.nb, bar);
      }
    }
    if (hk >= 0) buf[hk][pad[hk] + hi] = hv;
    mbar_wait(bar, phase);
    __syncthreads();
    if (!SAMPLE) {  // v = (x − μ)/a½ in place
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float ai = sa[i], mi = smu[i];
        float* vr = su + i * N;
        for (int j = 0; j < N; ++j) vr[j] = (vr[j] - mi) / ai;
      }
      __syncthreads();
    }
  };

  if (resident) stage_tile(0);
  for (int c0 = 0; c0 < N; c0 += NC) {
    const int nc = min(NC, N - c0);
    for (int e = threadIdx.x; e < parts * MR * NC; e += blockDim.x) tp[e] = 0.f;
    for (int e = threadIdx.x; e < warps * NC; e += blockDim.x) qp[e] = 0.f;
    __syncthreads();
    for (int t = 0; t < ntiles; ++t) {
      if (!resident) stage_tile(t);
      for (int cc = 0; cc < nc; cc += NT) {
        const int nt = min(NT, nc - cc);
        float acc[4 * NT];
#pragma unroll
        for (int e = 0; e < 4 * NT; ++e) acc[e] = 0.f;
        pass1_rows<MR, NT>(acc, su, sX, vecX, n, N, m, c0 + cc, nt);
        pass1_flush<MR, NT>(acc, tp, NC, cc, nt);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < MR * NC; e += blockDim.x) {
      float acc = 0.f;
      for (int p = 0; p < parts; ++p) acc += tp[p * MR * NC + e];
      tl[e] = acc;
    }
    cluster_sync();
    for (int e = threadIdx.x; e < MR * NC; e += blockDim.x) {
      float acc = 0.f;
      for (int r = 0; r < CS; ++r) acc += peer(tl, r)[e];
      tg[e] = acc;
    }
    __syncthreads();
    // s = M t, column-major, zero in rows k >= m and in columns j >= nc
    for (int e = threadIdx.x; e < (NC + 4) * MR; e += blockDim.x) {
      const int j = e / MR, k = e % MR;
      float acc = 0.f;
      if (k < m && j < nc)
        for (int l = 0; l < m; ++l) acc = fmaf(sM[k * m + l], tg[l * NC + j], acc);
      s[e] = acc;
    }
    __syncthreads();
    for (int t = 0; t < ntiles; ++t) {
      if (!resident) stage_tile(t);
      float* gx = SAMPLE && !resident ? x_out + (b * d + row0) * N : nullptr;
      for (int cc = 0; cc < nc; cc += NT) {
        const int nt = min(NT, nc - cc);
        float q[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) q[j] = 0.f;
        pass2_rows<MR, NT, SAMPLE>(q, su, sX, sa, smu, vecX, n, N, m, c0 + cc, s + cc * MR, nt,
                                   gx);
        pass2_flush<NT>(q, qp, NC, cc, nt);
      }
    }
    fence_async_smem();  // B1's in-place x before the bulk store reads it
    __syncthreads();
    if (SAMPLE && resident && c0 + NC >= N)  // x goes out while the sums are exchanged
      store_run(x_out + (b * d + r0) * N, su, pad[0], n * N);
    for (int c = threadIdx.x; c < nc; c += blockDim.x) {
      float acc = 0.f;
      for (int w = 0; w < warps; ++w) acc += qp[w * NC + c];
      ql[c] = acc;
    }
    cluster_sync();
    if (rank == 0)
      for (int c = threadIdx.x; c < nc; c += blockDim.x) {
        float q = 0.f;
        for (int r = 0; r < CS; ++r) q += peer(ql, r)[c];
        col_out[b * N + c0 + c] =
            SAMPLE ? -0.5f * (static_cast<float>(d) * kLog2Pi + ldb + q) : q;
      }
  }
  if (CS > 1) cluster.sync();  // no CTA leaves while another reads its shared memory
  if (threadIdx.x == 0) bulk_wait_read();
}

struct Plan {
  int cluster, threads, smem, tile;
};

// The plan the wrapper computed, checked against this file's layout.
bool plan_ok(const Plan& p, int B, int d, int m, int N) {
  if (B < 1 || d < 1 || m < 0 || m > kMaxRank || N < 1) return false;
  const int mr = rank_tile(m), g = mr / 4, parts = row_parts(mr);
  if (p.threads != cta_threads(mr)) return false;
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.tile < 1) return false;
  if (p.tile > (d + p.cluster - 1) / p.cluster) return false;
  if (p.smem > kMaxSmem) return false;
  return p.smem == 4 * Layout(p.tile, m, N, mr, parts, g * parts).total;
}

template <int MR, int NT, bool SAMPLE>
int launch(const Plan& p, int B, const float* in, const float* a_half, const float* X,
           const float* M, const float* mu, const float* logdet, float* x_out, float* col_out,
           int d, int m, int N, cudaStream_t stream) {
  auto kernel = woodbury_kernel<MR, NT, SAMPLE>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.cluster);
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, in, a_half, X, M, mu, logdet, x_out,
                                           col_out, d, m, N, p.tile);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool SAMPLE, int NT>
int dispatch_rank(const Plan& p, int B, const float* in, const float* a_half, const float* X,
                  const float* M, const float* mu, const float* logdet, float* x_out,
                  float* col_out, int d, int m, int N, cudaStream_t stream) {
#define PF_CASE(MR)                                                                           \
  case MR:                                                                                    \
    return launch<MR, NT, SAMPLE>(p, B, in, a_half, X, M, mu, logdet, x_out, col_out, d, m, \
                                  N, stream);
  switch (rank_tile(m)) {
    PF_CASE(4) PF_CASE(8) PF_CASE(12) PF_CASE(16) PF_CASE(20) PF_CASE(24) PF_CASE(28) PF_CASE(32)
  }
#undef PF_CASE
  return -1;
}

template <bool SAMPLE>
int dispatch(const Plan& p, int B, const float* in, const float* a_half, const float* X,
             const float* M, const float* mu, const float* logdet, float* x_out, float* col_out,
             int d, int m, int N, cudaStream_t stream) {
  if (!plan_ok(p, B, d, m, N)) return -1;
  switch (col_tile(N)) {
    case 5:
      return dispatch_rank<SAMPLE, 5>(p, B, in, a_half, X, M, mu, logdet, x_out, col_out, d, m, N, stream);
    default:
      return dispatch_rank<SAMPLE, 4>(p, B, in, a_half, X, M, mu, logdet, x_out, col_out, d, m, N, stream);
  }
}

}  // namespace

extern "C" {

int pf_max_rank() { return kMaxRank; }

int pf_sample_logq(const float* u, const float* a_half, const float* X, const float* C,
                   const float* mu, const float* logdet, float* x, float* logq, int B, int d,
                   int m, int N, int cluster, int threads, int smem, int tile,
                   cudaStream_t stream) {
  return dispatch<true>({cluster, threads, smem, tile}, B, u, a_half, X, C, mu, logdet, x, logq,
                        d, m, N, stream);
}

int pf_whiten_sumsq(const float* x, const float* a_half, const float* X, const float* Ci,
                    const float* mu, float* maha, int B, int d, int m, int N, int cluster,
                    int threads, int smem, int tile, cudaStream_t stream) {
  return dispatch<false>({cluster, threads, smem, tile}, B, x, a_half, X, Ci, mu, nullptr,
                         nullptr, maha, d, m, N, stream);
}

}  // extern "C"
