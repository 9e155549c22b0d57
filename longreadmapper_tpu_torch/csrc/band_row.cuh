// Shared row core of the CTA-per-read banded DP kernels for Hopper
// (sm_90a): band_dp.cu's band_dp_wide_kernel (direction words, the wide-band
// and tile-entry counterpart of longreadmapper_tpu/ops/band_pallas.py
// ::banded_nw_dirs_vt) and band_scores.cu (score rows, replacing
// longreadmapper_tpu/ops/wavefront_pallas.py::banded_nw_scores_pallas).
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
// What bounds it on this card: each row depends on the whole previous row
// (the up-neighbour) and needs a band-wide min-plus prefix scan, so the
// work is a sequential chain of L rows per read, a dozen integer ops per
// cell.  Bytes are few: q, t and the outputs are written once.  It is
// latency bound on the per-row chain.
//
// Design: one CTA per read, the band split across its warps.  Thread t owns
// K contiguous columns d0 = t*K .. d0+K-1 and keeps their row in registers.
// A row is computed in these steps:
//   1. a serial slope-form scan A[k] = min over e <= k of (cand[e] - d_e)
//      over the thread's K columns;
//   2. a 5-step __shfl_up_sync inclusive prefix min of the thread totals
//      within each warp;
//   3. the warp totals go through shared memory (barrier 1), and each warp
//      scans them with shuffles to get the exclusive prefix of the warps
//      before it;
//   4. the up-neighbour H(i-1, d+1) of a thread's last column is the next
//      thread's first column: one __shfl_down_sync inside a warp, and for
//      lane 31 the next warp's first column, which each warp's lane 0
//      publishes in shared memory after its row (barrier 2).
// Traps, handled here:
//   * Bands are multiples of 128, not powers of two (1152 = 9*128, 10112 =
//     79*128).  Columns past `band` up to the CTA's cols = threads*K are
//     padding: they hold INF on every row, so column band-1 sees INF as its
//     up-neighbour (as in JAX), and the scan runs left to right, so they
//     never feed a real column.
//   * q and the padded target are staged in shared memory by windows of
//     kWindowRows rows (kWindowRows + cols bytes), not whole reads: at 50 kb
//     a whole read would not fit.
//   * Row masks use the global row i and the global L even inside a tile
//     entered from a checkpoint row.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lrm {

constexpr int kInf = 0x3FFF;
constexpr int kBig = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWindowRows = 64;   // rows of q / target staged per window
constexpr int kMaxThreads = 512;  // per CTA, for every K below
constexpr int kMaxBand = 16384;

// Columns per thread: the smallest of 4, 8, 16, 32 that keeps the CTA at
// most kMaxThreads threads; 0 for a band the kernels do not take.
inline int cols_per_thread(int band) {
  if (band <= 0 || band % 128 != 0 || band > kMaxBand) return 0;
  for (int K = 4; K <= 32; K *= 2)
    if (band <= K * kMaxThreads) return K;
  return 0;
}

__host__ __device__ inline int row_threads(int band, int K) {
  return (band / K + 31) / 32 * 32;
}

// Shared memory in front of each kernel's own arrays.
struct RowSmem {
  int tot[32];    // inclusive warp totals of the current row
  int first[33];  // first column of each warp's previous row; [nwarps] INF
};

// Bytes of the row core's staging windows for a CTA of `cols` columns.
__host__ __device__ inline int window_bytes(int cols) {
  return 2 * kWindowRows + cols;
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

// Publishes the entry row's first column of each warp (and INF past the
// last warp) for the first row's up-neighbours; the next stage_window's
// barrier orders it before any read.
template <int K>
__device__ inline void publish_entry(const int (&h)[K], const Geom& g,
                                     RowSmem& s) {
  if (g.lane == 0) s.first[g.warp] = h[0];
  if (threadIdx.x == 0) s.first[g.nwarps] = kInf;
}

// Stages rows i in [r0+1, r0+rows]: s_q[x] = q[r0 + x] and
// s_tp[x] = tpad[r0 + 1 + x] for x < rows + cols.
__device__ inline void stage_window(const Geom& g, int r0, int rows,
                                    int8_t* s_tp, int8_t* s_q) {
  __syncthreads();  // the previous window is fully read
  for (int x = threadIdx.x; x < rows; x += blockDim.x) s_q[x] = g.q[r0 + x];
  const int span = rows + g.cols;
  for (int x = threadIdx.x; x < span; x += blockDim.x) {
    const int src = r0 + x - g.W;  // tpad index r0 + 1 + x, minus W + 1
    s_tp[x] = (src >= 0 && src < g.L) ? g.t[src] : int8_t(5);
  }
  __syncthreads();
}

// Advances the thread's K columns h from row i-1 to row i (rows staged by
// the window starting at r0).  emit(k, d, h_prev, a, up1, row) sees every
// column in ascending k before h[k] takes the new row.
template <int K, class Emit>
__device__ __forceinline__ void row_step(int (&h)[K], int i, const Geom& g,
                                         RowSmem& s, const int8_t* s_tp,
                                         const int8_t* s_q, int r0,
                                         Emit&& emit) {
  const int qc = s_q[i - 1 - r0];
  const int8_t* tw = s_tp + (i - 1 - r0) + g.d0;
  int nxt = __shfl_down_sync(kFull, h[0], 1);
  if (g.lane == 31) nxt = s.first[g.warp + 1];

  // 1. serial slope-form scan over the thread's columns
  int A[K];
  int run = kBig;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int up = (k + 1 < K) ? h[k + 1] : nxt;
    const int a = h[k] + (qc != tw[k] ? 1 : 0);
    run = min(run, min(a, up + 1) - (g.d0 + k));
    A[k] = run;
  }
  // 2. inclusive prefix min of the thread totals within the warp
  int tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, tot, o);
    if (g.lane >= o) tot = min(tot, v);
  }
  int excl = __shfl_up_sync(kFull, tot, 1);
  if (g.lane == 0) excl = kBig;
  if (g.lane == 31) s.tot[g.warp] = tot;
  __syncthreads();  // barrier 1: warp totals published
  // 3. exclusive prefix min over the warps before this one
  int wt = g.lane < g.nwarps ? s.tot[g.lane] : kBig;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, wt, o);
    if (g.lane >= o) wt = min(wt, v);
  }
  const int wex = __shfl_sync(kFull, wt, g.warp > 0 ? g.warp - 1 : 0);
  if (g.warp > 0) excl = min(excl, wex);

  // the row, its masks and the caller's outputs
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = g.d0 + k;
    const int up = (k + 1 < K) ? h[k + 1] : nxt;
    const int a = h[k] + (qc != tw[k] ? 1 : 0);
    const int j = i + d - g.W;
    int row = min(A[k], excl) + d;
    row = (j >= 0 && j <= g.L && d < g.band) ? min(row, kInf) : kInf;
    emit(k, d, h[k], a, up + 1, row);
    h[k] = row;
  }
  // 4. this row's first column of each warp, for the next row's lane 31
  if (g.lane == 0) s.first[g.warp] = h[0];
  __syncthreads();  // barrier 2
}

}  // namespace lrm
