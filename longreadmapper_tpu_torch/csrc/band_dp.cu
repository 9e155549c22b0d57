// Banded unit-cost Needleman-Wunsch direction sweeps for Hopper (sm_90a):
// the warp-per-read kernel band_dp_kernel (bands 128-512, whole pass) and
// the CTA-per-read kernel band_dp_wide_kernel (bands up to 16384, whole
// pass or one tile entered from a checkpoint row; below the first).
//
// Replaces the TPU kernel longreadmapper_tpu/ops/band_pallas.py
// ::banded_nw_dirs_vt (kernel _dirs_kernel).  Contract: the plain PyTorch
// version longreadmapper_tpu_torch/ops/wavefront.py::banded_nw_dirs_v,
// i.e. the JAX ops/wavefront.banded_nw_dirs_v(with_nm=True):
//
//   q (B, L) int8 query codes (pad 4), t (B, L) int8 target codes (pad,
//   '$' and out of range = 5), half-width W, band = 32*K columns.
//   vdirs (L/16, B, band) int32  2-bit directions 0=M 1=I 2=D, 16 rows per
//                                word (row i at bit pair (i-1) & 15),
//                                tie-break M > I > D, the diagonal only
//                                from a predecessor < INF
//   wcol  (L+1, B) int16         band-centre score column, row 0 = 0
//   nm    (ceil(G/32), B, band)  bit g&31 of word g>>5 set iff vdirs[g]
//                                at (b, d) holds a non-M pair
//
// What bounds it on this card: the recurrence is sequential in the row
// index, and each row needs an inclusive min-plus prefix scan across the
// band (the in-row insertion chain).  The work per cell is a dozen integer
// ops; the bytes are small (q and t are L bytes per read, the direction
// volume L/16 * band * 4 bytes per read is written once, 134 MB at
// B=2048, L=1024, band=256, ~40 us of HBM time).  So it is latency bound
// on the per-row dependency chain, not bandwidth or ALU bound.
//
// Design: one warp per read, so a row needs no block barrier.  Lane l owns
// the K = band/32 contiguous band columns d = l*K .. l*K+K-1 and keeps
// their scores, the 16-row direction words and the current 32-group nm
// words in registers.  Per row:
//   * the up-neighbour H(i-1, d+1) of a lane's last column comes from the
//     next lane by one __shfl_down_sync (INF past the band edge);
//   * the min-plus scan runs in slope form A[d] = cand[d] - d: a serial
//     prefix min over the lane's K columns, then a 5-step __shfl_up_sync
//     exclusive prefix min over the lane totals, then one min per column;
//   * the target row window is a per-warp shared-memory copy of t padded
//     with 5 by W+1 on the left and band on the right, so column d of row
//     i reads tpad[i + d] with no bounds test; the query byte of the row is
//     a shared-memory broadcast.
// Every 16 rows a lane stores its K words as int4 vectors (a warp writes
// band*4 contiguous bytes); every 32 groups it stores its K nm words.

#include <cstdint>
#include <cuda_runtime.h>

#include "band_row.cuh"

namespace {

using lrm::kFull;
using lrm::kInf;
constexpr int kWarpsPerBlock = 4;

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

template <int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
               int B, int L, int W, int32_t* __restrict__ vdirs,
               int16_t* __restrict__ wcol, int32_t* __restrict__ nm) {
  constexpr int band = 32 * K;
  extern __shared__ int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // uniform per warp: no lane of this warp goes on

  const int tp_len = round16(L + W + 1 + band);
  int8_t* tp = smem + warp * (tp_len + round16(L));
  int8_t* qs = tp + tp_len;
  const int8_t* qb = q + static_cast<size_t>(b) * L;
  const int8_t* tb = t + static_cast<size_t>(b) * L;
  for (int x = lane; x < tp_len; x += 32) {
    const int src = x - W - 1;
    tp[x] = (src >= 0 && src < L) ? tb[src] : int8_t(5);
  }
  for (int x = lane; x < L; x += 32) qs[x] = qb[x];
  __syncwarp();

  const int d0 = lane * K;
  int h[K];
  uint32_t word[K];
  uint32_t nmw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j0 = d0 + k - W;
    h[k] = (j0 >= 0 && j0 <= L) ? j0 : kInf;
    nmw[k] = 0u;
  }
  if (lane == 0) wcol[b] = 0;

  const int G = L / 16;
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int k = 0; k < K; ++k) word[k] = 0u;
    for (int r = 0; r < 16; ++r) {
      const int i = g * 16 + 1 + r;
      const int qc = qs[i - 1];
      int nxt = __shfl_down_sync(kFull, h[0], 1);
      if (lane == 31) nxt = kInf;
      int a[K], up1[K], A[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int up = (k + 1 < K) ? h[k + 1] : nxt;
        const int sub = (qc != tp[i + d0 + k]) ? 1 : 0;
        a[k] = h[k] + sub;
        up1[k] = up + 1;
        A[k] = min(a[k], up1[k]) - (d0 + k);
      }
#pragma unroll
      for (int k = 1; k < K; ++k) A[k] = min(A[k], A[k - 1]);
      int tot = A[K - 1];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int o = __shfl_up_sync(kFull, tot, s);
        if (lane >= s) tot = min(tot, o);
      }
      int excl = __shfl_up_sync(kFull, tot, 1);
      if (lane == 0) excl = 0x7FFFFFFF;
      int wc = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d0 + k;
        const int j = i + d - W;
        int row = min(A[k], excl) + d;
        row = (j >= 0 && j <= L) ? min(row, kInf) : kInf;
        const bool diag_ok = (h[k] < kInf) && (a[k] == row);
        const bool up_ok = (up1[k] == row);
        const uint32_t dir = diag_ok ? 0u : (up_ok ? 1u : 2u);
        word[k] |= dir << (2 * r);
        h[k] = row;
        if (d == W) wc = row;
      }
      if (W >= d0 && W < d0 + K)
        wcol[static_cast<size_t>(i) * B + b] = static_cast<int16_t>(wc);
    }
    int32_t* out = vdirs + (static_cast<size_t>(g) * B + b) * band + d0;
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<int4*>(out + k) =
          make_int4(static_cast<int>(word[k]), static_cast<int>(word[k + 1]),
                    static_cast<int>(word[k + 2]),
                    static_cast<int>(word[k + 3]));
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (word[k] != 0u) nmw[k] |= 1u << (g & 31);
    if ((g & 31) == 31 || g == G - 1) {
      uint32_t* nout = reinterpret_cast<uint32_t*>(nm) +
                       (static_cast<size_t>(g >> 5) * B + b) * band + d0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        nout[k] = nmw[k];
        nmw[k] = 0u;
      }
    }
  }
}

template <int K>
cudaError_t launch(const int8_t* q, const int8_t* t, int B, int L, int W,
                   int32_t* vdirs, int16_t* wcol, int32_t* nm,
                   cudaStream_t stream) {
  const int per_warp = round16(L + W + 1 + 32 * K) + round16(L);
  const size_t smem = static_cast<size_t>(per_warp) * kWarpsPerBlock;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        band_dp_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  band_dp_kernel<K><<<grid, 32 * kWarpsPerBlock, smem, stream>>>(
      q, t, B, L, W, vdirs, wcol, nm);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Returns 0 on success, a cudaError_t code when
// the launch is refused, or -1 for a shape the kernel does not take (band
// must be 128, 256, 384 or 512; L % 16 == 0; 0 <= W < band).
extern "C" int lrm_band_dp(const void* q, const void* t, int B, int L,
                           int W, int band, void* vdirs, void* wcol,
                           void* nm, void* stream) {
  if (B <= 0 || L <= 0 || L % 16 != 0 || W < 0 || W >= band) return -1;
  auto qp = static_cast<const int8_t*>(q);
  auto tp = static_cast<const int8_t*>(t);
  auto vp = static_cast<int32_t*>(vdirs);
  auto wp = static_cast<int16_t*>(wcol);
  auto np = static_cast<int32_t*>(nm);
  auto s = static_cast<cudaStream_t>(stream);
  switch (band) {
    case 128: return launch<4>(qp, tp, B, L, W, vp, wp, np, s);
    case 256: return launch<8>(qp, tp, B, L, W, vp, wp, np, s);
    case 384: return launch<12>(qp, tp, B, L, W, vp, wp, np, s);
    case 512: return launch<16>(qp, tp, B, L, W, vp, wp, np, s);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// band_dp_wide_kernel: the same contract for every band up to 16384 and for
// one tile of rows entered from a checkpoint row, on the CTA-per-read row
// core of band_row.cuh (see there for the design and its traps).  The warp
// kernel above keeps a read's whole padded target in shared memory and its
// band in one warp's registers, which at band 1152-10112 and L = 50176 does
// not fit; the row core stages windows and spreads the band over warps.
//
//   h0 (B, band) int32  H row i0 (the entry); rows i0+1 .. i0+n are computed
//   vdirs (n/16, B, band) int32  words of rows i0+g*16+1 .. +16 (row i at
//                                bit pair (i-i0-1) & 15; i0 % 16 == 0)
//   wcol  (n+1, B) int16         H[i0 + r, W]
//   nm    (ceil(n/16/32), B, band) int32  the tile's group bitmap
// Each thread ORs its columns' direction pairs into K register words, stores
// them every 16 rows as int4 vectors, and keeps the 32-group nm words of its
// columns in shared memory (cols * 4 bytes).

namespace {

template <int K>
__global__ void __launch_bounds__(lrm::kMaxThreads)
band_dp_wide_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                    const int32_t* __restrict__ h0, int B, int L, int W,
                    int band, int i0, int n, int32_t* __restrict__ vdirs,
                    int16_t* __restrict__ wcol, int32_t* __restrict__ nm) {
  extern __shared__ int4 smem_raw[];
  lrm::RowSmem& s = *reinterpret_cast<lrm::RowSmem*>(smem_raw);
  const lrm::Geom g = lrm::make_geom(q, t, L, W, band, K);
  uint32_t* s_nm = reinterpret_cast<uint32_t*>(&s + 1);
  int8_t* s_tp = reinterpret_cast<int8_t*>(s_nm + g.cols);
  int8_t* s_q = s_tp + lrm::kWindowRows + g.cols;
  const int b = blockIdx.x;
  const bool real = g.d0 < band;  // band % K == 0: all K columns or none
  const bool has_w = W >= g.d0 && W < g.d0 + K;

  int h[K];
  uint32_t word[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    h[k] = real ? h0[static_cast<size_t>(b) * band + g.d0 + k] : lrm::kInf;
    s_nm[g.d0 + k] = 0u;
    word[k] = 0u;
    if (g.d0 + k == W) wcol[b] = static_cast<int16_t>(h[k]);
  }
  lrm::publish_entry<K>(h, g, s);

  const int G = n / 16;
  for (int r0 = i0; r0 < i0 + n; r0 += lrm::kWindowRows) {
    const int rows = min(lrm::kWindowRows, i0 + n - r0);
    lrm::stage_window(g, r0, rows, s_tp, s_q);
    for (int x = 0; x < rows; ++x) {
      const int i = r0 + 1 + x;
      const int r = (i - i0 - 1) & 15;
      int wc = 0;
      lrm::row_step<K>(h, i, g, s, s_tp, s_q, r0,
                       [&](int k, int d, int hp, int a, int up1, int row) {
        const bool diag_ok = hp < lrm::kInf && a == row;
        const uint32_t dir = diag_ok ? 0u : (up1 == row ? 1u : 2u);
        word[k] |= dir << (2 * r);
        if (d == W) wc = row;
      });
      if (has_w)
        wcol[static_cast<size_t>(i - i0) * B + b] = static_cast<int16_t>(wc);
      if (r != 15) continue;
      const int gl = (i - i0 - 1) >> 4;
      if (real) {
        int32_t* out = vdirs + (static_cast<size_t>(gl) * B + b) * band + g.d0;
#pragma unroll
        for (int k = 0; k < K; k += 4)
          *reinterpret_cast<int4*>(out + k) = make_int4(
              static_cast<int>(word[k]), static_cast<int>(word[k + 1]),
              static_cast<int>(word[k + 2]), static_cast<int>(word[k + 3]));
        const bool flush = (gl & 31) == 31 || gl == G - 1;
        uint32_t* nout = reinterpret_cast<uint32_t*>(nm) +
                         (static_cast<size_t>(gl >> 5) * B + b) * band + g.d0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          uint32_t v = s_nm[g.d0 + k] | (word[k] != 0u ? 1u << (gl & 31) : 0u);
          if (flush) {
            nout[k] = v;
            v = 0u;
          }
          s_nm[g.d0 + k] = v;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) word[k] = 0u;
    }
  }
}

template <int K>
cudaError_t launch_wide(const int8_t* q, const int8_t* t, const int32_t* h0,
                        int B, int L, int W, int band, int i0, int n,
                        int32_t* vdirs, int16_t* wcol, int32_t* nm,
                        cudaStream_t stream) {
  const int threads = lrm::row_threads(band, K);
  const int cols = threads * K;
  const size_t smem = sizeof(lrm::RowSmem) + 4 * static_cast<size_t>(cols) +
                      lrm::window_bytes(cols);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        band_dp_wide_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  band_dp_wide_kernel<K><<<B, threads, smem, stream>>>(
      q, t, h0, B, L, W, band, i0, n, vdirs, wcol, nm);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Returns 0 on success, a cudaError_t code when the
// launch is refused, or -1 for a shape the kernel does not take (band % 128
// == 0 up to 16384; 0 <= W < band; i0, n multiples of 16, 0 < n,
// i0 + n <= L; h0 not null).
extern "C" int lrm_band_dp_wide(const void* q, const void* t, const void* h0,
                                int B, int L, int W, int band, int i0, int n,
                                void* vdirs, void* wcol, void* nm,
                                void* stream) {
  const int K = lrm::cols_per_thread(band);
  if (B <= 0 || L <= 0 || L % 16 != 0 || W < 0 || W >= band || K == 0 ||
      i0 < 0 || i0 % 16 != 0 || n <= 0 || n % 16 != 0 || i0 + n > L ||
      h0 == nullptr)
    return -1;
  auto qp = static_cast<const int8_t*>(q);
  auto tp = static_cast<const int8_t*>(t);
  auto hp = static_cast<const int32_t*>(h0);
  auto vp = static_cast<int32_t*>(vdirs);
  auto wp = static_cast<int16_t*>(wcol);
  auto np = static_cast<int32_t*>(nm);
  auto s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4:
      return launch_wide<4>(qp, tp, hp, B, L, W, band, i0, n, vp, wp, np, s);
    case 8:
      return launch_wide<8>(qp, tp, hp, B, L, W, band, i0, n, vp, wp, np, s);
    case 16:
      return launch_wide<16>(qp, tp, hp, B, L, W, band, i0, n, vp, wp, np, s);
    case 32:
      return launch_wide<32>(qp, tp, hp, B, L, W, band, i0, n, vp, wp, np, s);
    default: return -1;
  }
}
