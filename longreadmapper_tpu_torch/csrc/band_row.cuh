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
// What bounds it on this card.  Each row depends on the whole previous row
// (the up-neighbour) and needs a band-wide min-plus prefix scan, so a read
// is a chain of L dependent rows; the bytes are few (q and t once, the
// outputs once).  Two limits remain: the int32 issue rate over all cells
// (about a dozen integer instructions a cell, the bound that chip_smoke.py
// reports), and the latency of one row's chain (a serial scan of K
// columns, a few shuffles and a CTA barrier).  The chain is hidden only
// when enough CTAs share an SM, so the direction kernel takes many gact
// tiles in one launch (band_dp.cu, grid (B, tiles)); once the card is full
// the instructions issued a cell are the limit, and the row below spends
// as few as it can on each column.
//
// Design: one CTA per read (per tile), the band split across its warps.
// Thread t owns K contiguous columns d0 = t*K .. d0+K-1 and keeps their row
// in registers.  A row is computed in these steps:
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
// So the row's chain is the substitution words, K dependent add-mins, one
// reduction, the barrier and then the longer of one reduction and six
// shuffles.  The double buffers make a second barrier unneeded: a warp can
// write a parity's slots again only after the next row's barrier, which
// every warp reaches after its reads of this row.
// Traps, handled here:
//   * Bands are multiples of 128, not powers of two (1152 = 9*128, 10112 =
//     79*128).  Columns past `band` up to the CTA's cols = threads*K are
//     padding: they hold INF on every row, so column band-1 sees INF as its
//     up-neighbour (as in JAX), and the scan runs left to right, so they
//     never feed a real column.
//   * q and the padded target are staged in shared memory by windows of
//     kWindowRows rows (kWindowRows + cols bytes), not whole reads: at 50 kb
//     a whole read would not fit.  Every read of a window happens before a
//     row's barrier, so restaging needs one barrier, after the copy.
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
constexpr int kMaxBand = 16384;

// Launch shape of a band: K columns per thread and the CTA's thread cap
// (the kernels' __launch_bounds__).  K = 4 / 8 / 16 at up to 512 threads,
// then K = 16 at up to 640 threads for bands up to 10240 (a 640-thread
// bound leaves 102 registers a thread, enough for K = 16 without a spill;
// the 1024-thread bound's 64 spill) and at up to 1024 above; K = 0 for a
// band the kernels do not take.
struct RowShape {
  int K;
  int max_threads;
};

inline RowShape row_shape(int band) {
  if (band <= 0 || band % 128 != 0 || band > kMaxBand) return {0, 0};
  for (int K = 4; K <= 16; K *= 2)
    if (band <= K * 512) return {K, 512};
  return {16, band <= 10240 ? 640 : 1024};
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

}  // namespace lrm
