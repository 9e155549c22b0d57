// Row core of the banded DP kernels for Hopper (sm_90a): band_dp.cu's
// band_dp_wide_kernel (direction words, the wide-band and tile-entry
// counterpart of longreadmapper_tpu/ops/band_pallas.py::banded_nw_dirs_vt),
// band_scores.cu (score rows, replacing longreadmapper_tpu/ops/
// wavefront_pallas.py::banded_nw_scores_pallas), and, through the
// per-thread steps of its second half, band_dp.cu's warp-per-read
// band_dp_kernel.
//
// The recurrence (JAX ops/wavefront.py, ops/gact.py::_dp_row_step), for
// global row i >= 1 and band column d = j - i + W in [0, band):
//   sub[d]  = q[i-1] != tpad[i + d]      tpad[x] = t[x - W - 1], 5 outside
//   a[d]    = H(i-1, d) + sub[d]          diagonal
//   up1[d]  = H(i-1, d+1) + 1             insertion; INF + 1 at d = band-1
//   H(i, d) = d + min_{e <= d} (min(a[e], up1[e]) - e)   (deletion chain)
//   H(i, d) = INF where j = i + d - W is outside [0, L], else min(., INF)
// All state is int32 and every comparison integer, so the kernels equal the
// plain PyTorch versions bit for bit.
//
// What bounds it on this card.  Each row depends on the whole previous row
// (the up-neighbour) and needs a band-wide min-plus prefix scan, so a read
// is a chain of L dependent rows; the bytes are few (q and t once, the
// outputs once).  Two limits remain: the int32 issue rate over all cells
// (about a dozen integer instructions a cell, the bound that chip_smoke.py
// reports), and the latency of one row's chain (a serial scan of K
// columns, a few shuffles and a barrier).  A CTA's chain is hidden only
// when the SM has other work: the direction kernel takes many gact tiles
// in one launch (band_dp.cu, grid (B, tiles)).  The forward pass cannot:
// its rows are one chain a read and its checkpoints are the outputs, and a
// 50 kb pass has B = 40 reads for 132 SMs.  So band_scores may split a
// read over a thread-block cluster of C CTAs on C SMs (cluster_row below).
//
// One CTA a read (row_step, kept as it was before the cluster, so that
// band_dp_wide and band_scores at C = 1 compile as before): the band split
// across the CTA's warps.  Thread t owns K contiguous columns d0 = t*K ..
// d0+K-1 and keeps their row in registers.  A row is computed in these
// steps:
//   1. the substitution bits of the K columns from 32-bit words: K/4 + 1
//      word loads of the staged target, a funnel shift to the row's byte
//      offset, an XOR with the query byte replicated four times, and a
//      carry-free test of each byte for 0, one bit per byte (5 integer
//      instructions for 4 columns, instead of a byte load, a compare and a
//      select for each column);
//   2. a serial slope-form scan A[k] = min over e <= k of (cand[e] - e)
//      over the thread's K columns, relative to d0 so that each column's
//      offset is an immediate: min(a, up + 1) and the running min are one
//      fused add-min instruction each (Hopper's DPX __viaddmin_s32).  The
//      up-neighbour of a thread's last column comes from the next lane by
//      one __shfl_down_sync; lane 31 leaves its last column's up-neighbour
//      out (it lives in the next warp);
//   3. the warp's total by one __reduce_min_sync; lane 0 publishes it and
//      the warp's first column of the previous row, in shared arrays
//      double-buffered by row parity, and the CTA meets at its one
//      barrier of the row;
//   4. each warp takes the exclusive prefix over the warps before it in
//      one more reduction, lane l bringing warp l's total with the term
//      left out in step 2 (warp l+1's first column + 1, at warp l's last
//      column), while
//   5. a 5-step __shfl_up_sync scan gives each lane the exclusive prefix
//      of the lanes before it; lane 31 folds the left-out term into its
//      last column;
//   6. each column's value, min(A[k], prefix) + k clamped to INF, is one
//      min and one add-min.  Rows whose columns all lie inside the DP
//      domain (all but the first W and the last band - W rows) skip the
//      domain masks; the centre column W is read once after the row.
// The double buffers make a second barrier unneeded: a warp can write a
// parity's slots again only after the next row's barrier, which every
// warp reaches after its reads of this row.
//
// A cluster a read (cluster_row): the CTA of cluster rank r owns the
// columns [r*cols, (r+1)*cols), cols = threads*K, so only the last rank
// has padding columns, and a warp's index in the read is gwarp =
// r*nwarps + warp.  Steps 1, 2, 5 and 6 are the same (sub_words,
// slope_scan, warp_excl_short, finish_row); the meeting differs.  Each
// warp's slot (total, first column) goes into every CTA of the cluster:
// lane l < C stores it into CTA l by one st.async that completes 8 bytes
// of that CTA's row mbarrier (double-buffered by parity, armed once a row
// by thread 0 with gwarps * 8 bytes), and every thread waits on its own
// CTA's mbarrier (try_wait.parity).  While the slots travel the thread
// runs step 5 and loads the next row's substitution words.  There is no
// barrier: a cluster barrier (barrier.cluster.arrive.release / wait) cost
// 433-1344 ns a row against 117-316 ns for this meeting and 35-41 ns for
// __syncthreads, and its release waited for the row's global stores (a
// loop that does nothing else, scripts/torch_cluster_sweep.py; NVIDIA
// H100 80GB HBM3, 700.00 W; PERF.md).  Why the slots need no second
// barrier: a warp sends row i+2's slot only after its wait for row i+1,
// which completes only when every warp of every CTA has sent row i+1, and
// a warp sends a row only after all its lanes read the previous row's
// slots (they meet in the row's shuffles and reductions).  The same keeps
// every thread within one phase of each mbarrier, so the parity wait
// cannot wait on a phase that already passed.
// Traps, handled here:
//   * Bands are multiples of 128, not powers of two (1152 = 9*128, 10112 =
//     79*128).  Columns past `band` up to the read's C*cols are padding:
//     they hold INF on every row, so column band-1 sees INF as its
//     up-neighbour (as in JAX), and the scan runs left to right, so they
//     never feed a real column.
//   * q and the padded target are staged in shared memory by windows of
//     kWindowRows rows (kWindowRows + cols bytes, from the CTA's first
//     column), not whole reads: at 50 kb a whole read would not fit.
//     Every read of a window happens before a row's meeting, so restaging
//     needs one barrier, after the copy.
//   * A CTA must not touch another's shared memory before it runs or after
//     it exits: the cluster meets once (barrier.cluster) after the
//     mbarriers are initialised and once after the last row.
//   * With one CTA an SM (a shared-memory floor) the card holds 66
//     clusters of 2, 39 of 3 and 30 of 4: past that a launch runs in
//     waves, and the chooser (ops/band_scores.py::cluster_ctas) stays
//     within it.
//   * Row masks use the global row i and the global L even inside a tile
//     entered from a checkpoint row.

#pragma once

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace lrm {

constexpr int kInf = 0x3FFF;
constexpr int kBig = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWindowRows = 64;   // rows of q / target staged per window
constexpr int kMaxBand = 32768;

// Launch shape of a band: K columns per thread and the CTA's thread cap
// (the kernels' __launch_bounds__).  K = 4 / 8 / 16 at up to 512 threads,
// then K = 16 at up to 640 threads for bands up to 10240 (a 640-thread
// bound leaves 102 registers a thread, enough for K = 16 without a spill;
// the 1024-thread bound's 64 spill) and at up to 1024 to 16384; past it
// (the full-band retry of reads past ~80 kb) K = 32, at up to 640 threads
// to 20480 (the 100 kb bucket's 20096) and 1024 above, whose registers
// spill; K = 0 for a band the kernels do not take.
struct RowShape {
  int K;
  int max_threads;
};

inline RowShape row_shape(int band) {
  if (band <= 0 || band % 128 != 0 || band > kMaxBand) return {0, 0};
  for (int K = 4; K <= 16; K *= 2)
    if (band <= K * 512) return {K, 512};
  if (band <= 16384) return {16, band <= 10240 ? 640 : 1024};
  return {32, band <= 20480 ? 640 : 1024};
}

__host__ __device__ inline int row_threads(int band, int K) {
  return (band / K + 31) / 32 * 32;
}

// Shared memory in front of each kernel's own arrays.
struct RowSmem {
  int tot[2][32];  // warp totals of the row, by row parity (step 3)
  int bnd[2][33];  // each warp's first column of the previous row, by row
                   // parity; [.][nwarps] = INF, the up-neighbour past the band
};

// Bytes of the staged target window for a CTA of `cols` columns:
// kWindowRows + cols, plus the word that step 1's loads may touch past it.
// The query window (kWindowRows bytes) follows it.
__host__ __device__ inline int target_bytes(int cols) {
  return (kWindowRows + cols + 4 + 15) / 16 * 16;
}

__host__ __device__ inline int window_bytes(int cols) {
  return target_bytes(cols) + kWindowRows;
}

struct Geom {
  const int8_t* q;  // this read's query, L bytes (pad 4)
  const int8_t* t;  // this read's target window, L bytes (pad/'$' 5)
  int L, W, band;
  int lane, warp, nwarps, d0, cols;
};

__device__ inline Geom make_geom(const int8_t* q, const int8_t* t, int L,
                                 int W, int band, int K) {
  Geom g;
  const size_t b = blockIdx.x;
  g.q = q + b * L;
  g.t = t + b * L;
  g.L = L;
  g.W = W;
  g.band = band;
  g.lane = threadIdx.x & 31;
  g.warp = threadIdx.x >> 5;
  g.nwarps = blockDim.x >> 5;
  g.d0 = threadIdx.x * K;
  g.cols = blockDim.x * K;
  return g;
}

// The INF up-neighbour past the last warp, in both parities; the first
// stage_window's barrier orders it before any read.
__device__ inline void init_row_smem(const Geom& g, RowSmem& s) {
  if (threadIdx.x == 0) s.bnd[0][g.nwarps] = s.bnd[1][g.nwarps] = kInf;
}

// Stages rows i in [r0+1, r0+rows]: s_q[x] = q[r0 + x] and
// s_tp[x] = tpad[r0 + 1 + x] for x < rows + cols.  No barrier before the
// copy: every read of the previous window happened before the barrier of
// its last row.
__device__ inline void stage_window(const Geom& g, int r0, int rows,
                                    int8_t* s_tp, int8_t* s_q) {
  for (int x = threadIdx.x; x < rows; x += blockDim.x) s_q[x] = g.q[r0 + x];
  const int span = rows + g.cols;
  for (int x = threadIdx.x; x < span; x += blockDim.x) {
    const int src = r0 + x - g.W;  // tpad index r0 + 1 + x, minus W + 1
    s_tp[x] = (src >= 0 && src < g.L) ? g.t[src] : int8_t(5);
  }
  __syncthreads();
}

// Byte k of the substitution words: 1 where q[i-1] != tpad[i + d0 + k].
template <int K>
__device__ __forceinline__ int sub_at(const uint32_t (&sub)[K / 4], int k) {
  return static_cast<int>(__byte_perm(sub[k >> 2], 0u, 0x4440u | (k & 3)));
}

// Advances the thread's K columns h from row i-1 to row i (rows staged by
// the window starting at r0).  emit(k, d, h_prev, a, up1, row) sees every
// column in ascending k before h[k] takes the new row.
template <int K, class Emit>
__device__ __forceinline__ void row_step(int (&h)[K], int i, const Geom& g,
                                         RowSmem& s, const int8_t* s_tp,
                                         const int8_t* s_q, int r0,
                                         Emit&& emit) {
  const int p = i & 1;
  const int x = i - 1 - r0;  // the row's offset in the window

  // 1. substitution bits of the K columns, one byte each
  const uint32_t qrep = static_cast<uint32_t>(s_q[x]) * 0x01010101u;
  const uint32_t* tw =
      reinterpret_cast<const uint32_t*>(s_tp) + (x >> 2) + (g.d0 >> 2);
  const int sh = (x & 3) * 8;
  uint32_t sub[K / 4];
  uint32_t lo = tw[0];
#pragma unroll
  for (int m = 0; m < K / 4; ++m) {
    const uint32_t hi = tw[m + 1];
    const uint32_t z = __funnelshift_r(lo, hi, sh) ^ qrep;
    // bit 7 of a byte set iff the byte is not 0 (no carry between bytes)
    sub[m] = (((z & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | z) >> 7 & 0x01010101u;
    lo = hi;
  }

  // 2. serial slope-form scan relative to the thread's first column d0
  // (A[k] = min over e <= k of cand[e] - e; the absolute slope is A - d0),
  // two fused add-min (DPX) instructions a column; lane 31's last column
  // without its up-neighbour (INF + 1 never wins against a <= INF + 1)
  int nxt = __shfl_down_sync(kFull, h[0], 1);
  if (g.lane == 31) nxt = kInf;
  int A[K];
  int run = kBig;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int up = (k + 1 < K) ? h[k + 1] : nxt;
    const int a = h[k] + sub_at<K>(sub, k);
    run = __viaddmin_s32(__viaddmin_s32(up, 1, a), -k, run);
    A[k] = run;
  }
  run -= g.d0;
  // 3. the warp total (lane 31's last column still without its term) by
  // one reduction; lane 0 publishes it with the warp's first column of
  // row i-1, and the CTA meets at the row's one barrier
  const int wtot = __reduce_min_sync(kFull, run);
  if (g.lane == 0) {
    s.tot[p][g.warp] = wtot;
    s.bnd[p][g.warp] = h[0];
  }
  __syncthreads();
  // 4. the exclusive prefix over the warps before this one: lane l < warp
  // brings warp l's total with its last column's up-neighbour term (warp
  // l+1's first column + 1), and one reduction takes their min
  int wt = kBig;
  if (g.lane < g.warp)
    wt = min(s.tot[p][g.lane],
             s.bnd[p][g.lane + 1] + 1 - ((g.lane + 1) * 32 * K - 1));
  // 5. the exclusive prefix of the thread totals within the warp (5
  // shuffle steps, independent of step 4), then both combined
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (g.lane >= o) incl = min(incl, v);
  }
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (g.lane == 0) excl = kBig;
  // relative to d0 like A: row(d0 + k) = min(A[k], excl + d0) + k
  excl = min(excl, __reduce_min_sync(kFull, wt)) + g.d0;
  if (g.lane == 31) {
    nxt = s.bnd[p][g.warp + 1];
    A[K - 1] = min(A[K - 1], nxt + 1 - (K - 1));
  }

  // the row, its masks and the caller's outputs.  Inside the DP domain
  // (every column has 0 <= j <= L, true for all but the first W and last
  // band - W rows) a real thread needs no mask: the test is uniform over
  // the CTA but for the padding threads.
  const bool inner =
      i >= g.W && i + g.band - 1 - g.W <= g.L && g.d0 < g.band;
  if (inner) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int up = (k + 1 < K) ? h[k + 1] : nxt;
      const int a = h[k] + sub_at<K>(sub, k);
      const int row = __viaddmin_s32(min(A[k], excl), k, kInf);
      emit(k, g.d0 + k, h[k], a, up + 1, row);
      h[k] = row;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = g.d0 + k;
      const int up = (k + 1 < K) ? h[k + 1] : nxt;
      const int a = h[k] + sub_at<K>(sub, k);
      const int j = i + d - g.W;
      const int row = (j >= 0 && j <= g.L && d < g.band)
                          ? __viaddmin_s32(min(A[k], excl), k, kInf)
                          : kInf;
      emit(k, d, h[k], a, up + 1, row);
      h[k] = row;
    }
  }
}

// The thread's column W of the row in h (has_w: W in [d0, d0 + K)); a
// branch taken by one thread, so the other warps skip it.
template <int K>
__device__ __forceinline__ int column_w(const int (&h)[K], const Geom& g) {
  int wc = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (g.d0 + k == g.W) wc = h[k];
  return wc;
}


// ---------------------------------------------------------------------------
// A read split over a cluster of C CTAs, and the per-thread steps that the
// cluster row and band_dp.cu's warp kernel share.

constexpr int kMaxCtas = 4;            // CTAs of one read's cluster
constexpr int kClusterThreads = 1024;  // the cluster kernels' thread cap
// Dynamic shared memory of a cluster kernel's CTA at least: more than half
// of an SM's 228 KB, so that no two CTAs share an SM.
constexpr int kOneCtaPerSm = 116 * 1024;

// Threads of each CTA when a band is split over C CTAs at K columns a
// thread (C = 1: row_threads).
__host__ __device__ inline int cluster_threads(int band, int K, int C) {
  return (band / K + 32 * C - 1) / (32 * C) * 32;
}

// Whether a band splits over 2 <= C <= kMaxCtas CTAs at K (4, 8 or 16):
// each CTA within kClusterThreads, and every rank but the last free of
// padding columns.
inline bool cluster_fits(int band, int K, int C) {
  if (band <= 0 || band % 128 != 0 || band > kMaxBand || C < 2 ||
      C > kMaxCtas || (K != 4 && K != 8 && K != 16))
    return false;
  const int threads = cluster_threads(band, K, C);
  return threads <= kClusterThreads && (C - 1) * threads * K < band;
}

// K of a band split over C > 1 CTAs: 8, the fastest at C = 2 and 3 at
// bands 5120 and 10112 (PERF.md), else 16, else 4 (0: none fits).
inline int cluster_k(int band, int C) {
  for (int K : {8, 16, 4})
    if (cluster_fits(band, K, C)) return K;
  return 0;
}

// slot[p][w] = (total, first column of the previous row) of the read's
// warp w, written by that warp into every CTA of the cluster;
// slot[.][gwarps].y = INF, the up-neighbour past the band.  bar[p] is the
// mbarrier whose phase completes when a row of parity p has all its
// slots: one local arrival and gwarps * 8 bytes.
struct ClusterSmem {
  unsigned long long bar[2];
  int2 slot[2][32 * kMaxCtas + 1];
};

// The cluster primitives (PTX of sm_90).
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// (x, y) into CTA `rank`'s copy of *p where `on`: one predicated store to
// distributed shared memory, so the warp stays converged.
__device__ __forceinline__ void store_peer_if(int2* p, int rank, int x, int y,
                                              bool on) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "{\n\t.reg .u32 ra;\n\t.reg .pred on;\n\t"
      "setp.ne.u32 on, %4, 0;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "@on st.shared::cluster.v2.s32 [ra], {%2, %3};\n\t}"
      :
      : "r"(a), "r"(rank), "r"(x), "r"(y), "r"(static_cast<unsigned>(on))
      : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :
               : "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Orders the mbarrier inits before their use by the cluster's other CTAs.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The phase's local arrival, expecting `bytes` more of transfers.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// (x, y) into CTA `rank`'s copy of *p where `on`, completing 8 bytes of
// the transfers of its copy of *bar: one asynchronous DSMEM store
// (st.async), predicated so the warp stays converged.  The writer waits
// for nothing: no fence, no barrier.
__device__ __forceinline__ void send_peer_if(int2* p, unsigned long long* bar,
                                             int rank, int x, int y,
                                             bool on) {
  asm volatile(
      "{\n\t.reg .u32 ra, rb;\n\t.reg .pred on;\n\t"
      "setp.ne.u32 on, %5, 0;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %2;\n\t"
      "mapa.shared::cluster.u32 rb, %1, %2;\n\t"
      "@on st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 "
      "[ra], {%3, %4}, [rb];\n\t}"
      :
      : "r"(smem_addr(p)), "r"(smem_addr(bar)), "r"(rank), "r"(x), "r"(y),
        "r"(static_cast<unsigned>(on))
      : "memory");
}

// Waits until the phase of *bar with this parity has completed.  The
// peers' st.async data lies in this CTA's shared memory, so the wait
// acquires at CTA scope: a cluster-scope acquire compiles to an L1
// invalidation (CCTL.IVALL) after every wait.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}"
      :
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A thread's place in a read split over a cluster: Geom's fields (d0 the
// thread's first column in the band, cols the CTA's columns) and these.
struct ClusterGeom : Geom {
  int b;       // the read: blockIdx.x / C
  int c0;      // the CTA's first column: rank * cols
  int gwarp;   // the warp's index in the read: rank * nwarps + warp
  int gwarps;  // the read's warps: C * nwarps
  int peer;    // the CTA this lane's slot store goes to
  int ctas;    // C
};

// The grid is C*B CTAs in clusters of C.
__device__ inline ClusterGeom make_cluster_geom(const int8_t* q,
                                                const int8_t* t, int L, int W,
                                                int band, int K) {
  ClusterGeom g;
  const int rank = cluster_rank();
  g.ctas = cluster_size();
  g.b = static_cast<int>(blockIdx.x) / g.ctas;
  g.q = q + static_cast<size_t>(g.b) * L;
  g.t = t + static_cast<size_t>(g.b) * L;
  g.L = L;
  g.W = W;
  g.band = band;
  g.lane = threadIdx.x & 31;
  g.warp = threadIdx.x >> 5;
  g.nwarps = blockDim.x >> 5;
  g.cols = blockDim.x * K;
  g.c0 = rank * g.cols;
  g.d0 = g.c0 + threadIdx.x * K;
  g.gwarp = rank * g.nwarps + g.warp;
  g.gwarps = g.ctas * g.nwarps;
  g.peer = g.lane % g.ctas;
  return g;
}

// The INF slot past the read's last warp and the rows' mbarriers; then the
// cluster meets once, so that every CTA runs, with its mbarriers, before
// any other writes to its shared memory.
__device__ inline void init_cluster_smem(const ClusterGeom& g,
                                         ClusterSmem& s) {
  if (threadIdx.x == 0) {
    s.slot[0][g.gwarps] = s.slot[1][g.gwarps] = make_int2(kInf, kInf);
    mbar_init(&s.bar[0], 1);
    mbar_init(&s.bar[1], 1);
    mbar_init_fence();
  }
  cluster_arrive();
  cluster_wait();
}

// After the last row: one more meeting, so that no CTA exits while a
// peer's transfers are in flight.
__device__ inline void end_cluster_rows() {
  cluster_arrive();
  cluster_wait();
}

// stage_window for the CTA's columns: s_q[x] = q[r0 + x] and s_tp[x] =
// tpad[r0 + 1 + c0 + x] for x < rows + cols.
__device__ inline void stage_cluster_window(const ClusterGeom& g, int r0,
                                            int rows, int8_t* s_tp,
                                            int8_t* s_q) {
  for (int x = threadIdx.x; x < rows; x += blockDim.x) s_q[x] = g.q[r0 + x];
  const int span = rows + g.cols;
  for (int x = threadIdx.x; x < span; x += blockDim.x) {
    const int src = r0 + g.c0 + x - g.W;  // tpad index r0+1+c0+x, minus W+1
    s_tp[x] = (src >= 0 && src < g.L) ? g.t[src] : int8_t(5);
  }
  __syncthreads();
}

// Step 1: sub[m] byte k&3 of word m = k>>2 is 1 where qc != s_tp[x + ld0
// + k], for the K columns from byte x + ld0 (ld0 % 4 == 0, s_tp 4-byte
// aligned, readable for 4 bytes past the last column).
template <int K>
__device__ __forceinline__ void sub_words(uint32_t (&sub)[K / 4],
                                          const int8_t* s_tp, int x, int ld0,
                                          int8_t qc) {
  const uint32_t qrep = static_cast<uint32_t>(qc) * 0x01010101u;
  const uint32_t* tw =
      reinterpret_cast<const uint32_t*>(s_tp) + (x >> 2) + (ld0 >> 2);
  const int sh = (x & 3) * 8;
  uint32_t lo = tw[0];
#pragma unroll
  for (int m = 0; m < K / 4; ++m) {
    const uint32_t hi = tw[m + 1];
    const uint32_t z = __funnelshift_r(lo, hi, sh) ^ qrep;
    // bit 7 of a byte set iff the byte is not 0 (no carry between bytes)
    sub[m] = (((z & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | z) >> 7 & 0x01010101u;
    lo = hi;
  }
}

// Step 2: the serial slope-form scan relative to the thread's first column
// (A[k] = min over e <= k of cand[e] - e), two fused add-min (DPX)
// instructions a column; nxt is the up-neighbour of the last column.
// Returns the thread's total.
template <int K>
__device__ __forceinline__ int slope_scan(int (&A)[K], const int (&h)[K],
                                          const uint32_t (&sub)[K / 4],
                                          int nxt) {
  int run = kBig;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int up = (k + 1 < K) ? h[k + 1] : nxt;
    const int a = h[k] + sub_at<K>(sub, k);
    run = __viaddmin_s32(__viaddmin_s32(up, 1, a), -k, run);
    A[k] = run;
  }
  return run;
}

// Step 5 with one shuffle less on its chain: the inclusive prefix over 16
// lanes in four steps, then the lanes l-16 .. l-1 and l-32 .. l-17 by two
// independent shuffles (kBig at lane 0).
__device__ __forceinline__ int warp_excl_short(int run, int lane) {
  int v = run;
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = min(v, u);
  }
  const int near = __shfl_up_sync(kFull, v, 1);
  const int far = __shfl_up_sync(kFull, v, 17);
  int excl = lane >= 1 ? near : kBig;
  if (lane >= 17) excl = min(excl, far);
  return excl;
}

// Step 6: the row from the scan and the prefix (relative to d0 like A:
// row(d0 + k) = min(A[k], excl) + k, excl already + d0).  emit(k, d,
// h_prev, a, up1, row) sees every column in ascending k before h[k] takes
// the new row.  Inside the DP domain (`inner`: every column of the thread
// has 0 <= j <= L and d < band) no mask is needed.
template <int K, class Emit>
__device__ __forceinline__ void finish_row(int (&h)[K], const int (&A)[K],
                                           const uint32_t (&sub)[K / 4],
                                           int excl, int nxt, int i, int d0,
                                           int W, int L, int band, bool inner,
                                           Emit&& emit) {
  if (inner) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int up = (k + 1 < K) ? h[k + 1] : nxt;
      const int a = h[k] + sub_at<K>(sub, k);
      const int row = __viaddmin_s32(min(A[k], excl), k, kInf);
      emit(k, d0 + k, h[k], a, up + 1, row);
      h[k] = row;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = d0 + k;
      const int up = (k + 1 < K) ? h[k + 1] : nxt;
      const int a = h[k] + sub_at<K>(sub, k);
      const int j = i + d - W;
      const int row = (j >= 0 && j <= L && d < band)
                          ? __viaddmin_s32(min(A[k], excl), k, kInf)
                          : kInf;
      emit(k, d, h[k], a, up + 1, row);
      h[k] = row;
    }
  }
}

// The same step for a read split over a cluster (s its ClusterSmem):
// `sub` holds this row's substitution words and takes the next row's,
// loaded from the window at offset xn while the slots travel (xn < 0: the
// next row is in the next window, and the caller loads it after staging).
template <int K, class Emit>
__device__ __forceinline__ void cluster_row(int (&h)[K],
                                            uint32_t (&sub)[K / 4], int i,
                                            const ClusterGeom& g,
                                            ClusterSmem& s,
                                            const int8_t* s_tp,
                                            const int8_t* s_q, int xn,
                                            Emit&& emit) {
  const int p = i & 1;
  // 2. the scan; lane 31's last column without its up-neighbour
  int nxt = __shfl_down_sync(kFull, h[0], 1);
  if (g.lane == 31) nxt = kInf;
  int A[K];
  const int run = slope_scan<K>(A, h, sub, nxt) - g.d0;
  // 3. thread 0 arms the row's mbarrier; lane l < C sends the warp's slot
  // to CTA l
  const int wtot = __reduce_min_sync(kFull, run);
  if (threadIdx.x == 0) mbar_expect(&s.bar[p], g.gwarps * 8);
  const int first = __shfl_sync(kFull, h[0], 0);
  send_peer_if(&s.slot[p][g.gwarp], &s.bar[p], g.peer, wtot, first,
               g.lane < g.ctas);
  // while the slots travel: step 5 and the next row's substitution words
  int excl = warp_excl_short(run, g.lane);
  uint32_t sub_next[K / 4];
  if (xn >= 0) sub_words<K>(sub_next, s_tp, xn, g.d0 - g.c0, s_q[xn]);
  mbar_wait(&s.bar[p], ((i - 1) >> 1) & 1);
  // 4. the exclusive prefix over the read's warps below gwarp (lane l
  // brings warps l, l + 32, ...), as row_step's step 4
  int wt = kBig;
#pragma unroll
  for (int m = 0; m < kMaxCtas; ++m) {
    if (32 * m >= g.gwarp) break;
    const int l = g.lane + 32 * m;
    if (l < g.gwarp)
      wt = min(wt, min(s.slot[p][l].x,
                       s.slot[p][l + 1].y + 1 - ((l + 1) * 32 * K - 1)));
  }
  excl = min(excl, __reduce_min_sync(kFull, wt)) + g.d0;
  if (g.lane == 31) {
    nxt = s.slot[p][g.gwarp + 1].y;
    A[K - 1] = min(A[K - 1], nxt + 1 - (K - 1));
  }
  // 6. the row, masked only at the domain's edges
  const bool inner =
      i >= g.W && i + g.band - 1 - g.W <= g.L && g.d0 < g.band;
  finish_row<K>(h, A, sub, excl, nxt, i, g.d0, g.W, g.L, g.band, inner,
                static_cast<Emit&&>(emit));
  if (xn >= 0) {
#pragma unroll
    for (int m = 0; m < K / 4; ++m) sub[m] = sub_next[m];
  }
}

// column_w for the warp kernel, which has no Geom: the thread's first
// column is d0.
template <int K>
__device__ __forceinline__ int column_at(const int (&h)[K], int d0, int W) {
  int wc = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (d0 + k == W) wc = h[k];
  return wc;
}

}  // namespace lrm
