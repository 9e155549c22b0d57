// Banded unit-cost Needleman-Wunsch direction sweeps for Hopper (sm_90a):
// the warp-per-read kernel band_dp_kernel (bands 128-512, whole pass) and
// the CTA-per-read kernel band_dp_wide_kernel (bands up to 32768, a group
// of tiles entered from checkpoint rows, a whole pass being one tile entered
// from row 0; below the first).
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
// What bounds the warp kernel on this card: the recurrence is sequential
// in the row index and each row needs a min-plus prefix scan across the
// band; the bytes are small (q and t are L bytes per read, the direction
// volume L/16 * band * 4 bytes per read is written once, 134 MB at
// B=2048, L=1024, band=256, ~40 us of HBM time).  With 2048 reads a
// launch the card is full (16 warps an SM), so the chains overlap and the
// integer instructions issued a cell are the limit: the bound chip_smoke.py
// reports counts 12 a cell, and the first version's row issued about 25
// (a byte load, a compare and a select for the substitution, a min and a
// subtract for the slope, the domain mask on every row, the d == W test,
// a three-way select and an or-shift for the direction): 0.885 ms at
// (2048, 1024, 102, 256), 43.5% of the 0.385 ms bound (PERF.md; NVIDIA
// H100 80GB HBM3, 700 W).
//
// Design: one warp per read, so a row needs no block barrier.  Lane l owns
// the K = band/32 contiguous band columns d = l*K .. l*K+K-1 and keeps
// their scores, the 16-row direction words and the current 32-group nm
// words in registers.  A per-warp shared-memory copy of t, padded with 5
// by W+1 on the left and by band + 4 on the right (word-aligned, so the
// last column's word load stays inside), holds the row window: column d
// of row i reads tpad[i + d] with no bounds test.  The row is band_row.cuh's
// per-thread steps, so it spends what the CTA kernels' row spends a cell:
//   * the substitution bits of the K columns from 32-bit words (a funnel
//     shift, an XOR with the replicated query byte and a carry-free
//     zero-byte test for 4 columns: sub_words);
//   * the slope-form scan as two DPX add-mins a column (__viaddmin_s32:
//     min(a, up + 1) - k and the running min; slope_scan), then a 5-step
//     __shfl_up_sync exclusive prefix min over the lane totals
//     (warp_excl); the up-neighbour of a lane's last column comes from the
//     next lane by one __shfl_down_sync (INF past the band edge);
//   * each column one min and one add-min, without the domain masks on
//     rows inside the DP domain (finish_row), and column W read once after
//     the row (column_at);
//   * the direction pair shifted into the word by one __funnelshift_r.
// The next row's substitution words load while the row's shuffles run,
// the exclusive scan is 5 shuffles deep (warp_excl_short), and the inner
// test is taken once a 16-row group.  Measured: 0.855 ms at (2048, 1024,
// 102, 256), 45% of the bound, 0.92x the first version's row in the same
// call; at band 512 band_dp_wide is faster, so the step takes this kernel
// at 128-384
// (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W).
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

// Bytes of a warp's padded target: tpad[0 .. L + W + band], and the word
// past the last column's.
__host__ __device__ inline int tp_bytes(int L, int W, int band) {
  return round16(L + W + 1 + band + 4);
}

template <int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
band_dp_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
               int B, int L, int W, int32_t* __restrict__ vdirs,
               int16_t* __restrict__ wcol, int32_t* __restrict__ nm) {
  constexpr int band = 32 * K;
  extern __shared__ int4 smem_w[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // uniform per warp: no lane of this warp goes on

  const int tp_len = tp_bytes(L, W, band);
  int8_t* tp =
      reinterpret_cast<int8_t*>(smem_w) + warp * (tp_len + round16(L));
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
  const bool has_w = W >= d0 && W < d0 + K;
  int h[K];
  uint32_t word[K];
  uint32_t nmw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j0 = d0 + k - W;
    h[k] = (j0 >= 0 && j0 <= L) ? j0 : kInf;
    word[k] = 0u;
    nmw[k] = 0u;
  }
  if (lane == 0) wcol[b] = 0;

  const int G = L / 16;
  uint32_t sub[K / 4];
  lrm::sub_words<K>(sub, tp, 1, d0, qs[0]);
  for (int g = 0; g < G; ++g) {
    // the group's 16 rows all inside the DP domain: no masks
    const bool inner = g * 16 + 1 >= W && g * 16 + 16 + band - 1 - W <= L;
#pragma unroll 2
    for (int r = 0; r < 16; ++r) {
      const int i = g * 16 + 1 + r;
      int nxt = __shfl_down_sync(kFull, h[0], 1);
      if (lane == 31) nxt = kInf;
      int A[K];
      const int run = lrm::slope_scan<K>(A, h, sub, nxt) - d0;
      // the next row's substitution words, off the row's chain
      uint32_t sub_next[K / 4];
      const int in = min(i + 1, L);
      lrm::sub_words<K>(sub_next, tp, in, d0, qs[in - 1]);
      const int excl = lrm::warp_excl_short(run, lane) + d0;  // lane 0: d0 0
      lrm::finish_row<K>(h, A, sub, excl, nxt, i, d0, W, L, band, inner,
                         [&](int k, int, int hp, int a, int up1, int row) {
        const bool diag_ok = hp < kInf && a == row;
        const uint32_t dir = diag_ok ? 0u : (up1 == row ? 1u : 2u);
        word[k] = __funnelshift_r(word[k], dir, 2);
      });
      if (has_w)
        wcol[static_cast<size_t>(i) * B + b] =
            static_cast<int16_t>(lrm::column_at<K>(h, d0, W));
#pragma unroll
      for (int m = 0; m < K / 4; ++m) sub[m] = sub_next[m];
    }
    // after 16 funnel shifts row r of the group sits at bits 2r
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
  const int per_warp = tp_bytes(L, W, 32 * K) + round16(L);
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
// band_dp_wide_kernel: the same contract for every band up to 32768, and for
// tiles of rows entered from checkpoint rows, on the CTA-per-read row core of
// band_row.cuh (bounds, design and traps there).  The warp kernel above keeps
// a read's whole padded target in shared memory and its band in one warp's
// registers, which at band 1152-10112 and L = 50176 does not fit; the row
// core stages windows and spreads the band over warps.
//
// The grid is (B, tiles): CTA (b, y) computes read b's tile y, entered from
// row h0[y] at global row i0 + y*n:
//   h0 (tiles, B, band) int32  H row i0 + y*n; read in place, so a gact
//                              pass hands in its checkpoint rows
//                              ckpt[k0 .. k0+tiles) as they are
//   vdirs (tiles, n/16, B, band) int32  words of rows i0+y*n+g*16+1 .. +16
//                                (row i at bit pair (i-i0-y*n-1) & 15)
//   wcol  (tiles, n+1, B) int16         H[i0 + y*n + r, W]
//   nm    (tiles, ceil(n/16/32), B, band) int32  the tile's group bitmap
// A whole pass is one tile entered from row 0.
//
// What the tile grid is for: one CTA's row is a chain of shuffles and a
// barrier that one CTA cannot hide (a 512-row tile at band 5120 took 0.92
// ms, 1.8 us a row, with grid = B = 40 CTAs on 132 SMs).  All tiles' entry
// rows are known once the forward pass is done, so a gact pass launches a
// group of tiles at once: B x tiles CTAs, several per SM, whose chains
// overlap.
// Each thread shifts its columns' direction pairs into K register words (a
// funnel shift puts the row at bits 30-31; after 16 rows row r sits at bits
// 2r), stores them every 16 rows as int4 vectors, and keeps the 32-group nm
// words of its columns in shared memory (cols * 4 bytes).

namespace {

template <int K, int MAXT>
__global__ void __launch_bounds__(MAXT)
band_dp_wide_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                    const int32_t* __restrict__ h0, int B, int L, int W,
                    int band, int i0, int n, int32_t* __restrict__ vdirs,
                    int16_t* __restrict__ wcol, int32_t* __restrict__ nm) {
  extern __shared__ int4 smem_raw[];
  lrm::RowSmem& s = *reinterpret_cast<lrm::RowSmem*>(smem_raw);
  const lrm::Geom g = lrm::make_geom(q, t, L, W, band, K);
  uint32_t* s_nm = reinterpret_cast<uint32_t*>(&s + 1);
  int8_t* s_tp = reinterpret_cast<int8_t*>(s_nm + g.cols);
  int8_t* s_q = s_tp + lrm::target_bytes(g.cols);
  const int b = blockIdx.x;
  const int G = n / 16;
  {  // this CTA's tile
    const size_t y = blockIdx.y;
    h0 += y * B * band;
    i0 += static_cast<int>(y) * n;
    vdirs += y * G * B * band;
    wcol += y * (n + 1) * B;
    nm += y * ((G + 31) / 32) * B * band;
  }
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
  lrm::init_row_smem(g, s);

  for (int r0 = i0; r0 < i0 + n; r0 += lrm::kWindowRows) {
    const int rows = min(lrm::kWindowRows, i0 + n - r0);
    lrm::stage_window(g, r0, rows, s_tp, s_q);
    for (int x = 0; x < rows; ++x) {
      const int i = r0 + 1 + x;
      lrm::row_step<K>(h, i, g, s, s_tp, s_q, r0,
                       [&](int k, int, int hp, int a, int up1, int row) {
        const bool diag_ok = hp < lrm::kInf && a == row;
        const uint32_t dir = diag_ok ? 0u : (up1 == row ? 1u : 2u);
        word[k] = __funnelshift_r(word[k], dir, 2);
      });
      if (has_w)
        wcol[static_cast<size_t>(i - i0) * B + b] =
            static_cast<int16_t>(lrm::column_w<K>(h, g));
      if (((i - i0) & 15) != 0 || !real) continue;
      const int gl = (i - i0 - 1) >> 4;
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
  }
}

template <int K, int MAXT>
cudaError_t launch_wide(const int8_t* q, const int8_t* t, const int32_t* h0,
                        int B, int L, int W, int band, int i0, int n,
                        int tiles, int32_t* vdirs, int16_t* wcol, int32_t* nm,
                        cudaStream_t stream) {
  const int threads = lrm::row_threads(band, K);
  const int cols = threads * K;
  const size_t smem = sizeof(lrm::RowSmem) + 4 * static_cast<size_t>(cols) +
                      lrm::window_bytes(cols);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        band_dp_wide_kernel<K, MAXT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  band_dp_wide_kernel<K, MAXT><<<dim3(B, tiles), threads, smem, stream>>>(
      q, t, h0, B, L, W, band, i0, n, vdirs, wcol, nm);
  return cudaGetLastError();
}

int dispatch_wide(const void* q, const void* t, const void* h0, int B, int L,
                  int W, int band, int i0, int n, int tiles, void* vdirs,
                  void* wcol, void* nm, void* stream) {
  const lrm::RowShape rs = lrm::row_shape(band);
  if (B <= 0 || L <= 0 || L % 16 != 0 || W < 0 || W >= band || rs.K == 0 ||
      i0 < 0 || i0 % 16 != 0 || n <= 0 || n % 16 != 0 || tiles <= 0 ||
      tiles > 65535 || i0 + static_cast<long long>(n) * tiles > L ||
      h0 == nullptr)
    return -1;
  auto qp = static_cast<const int8_t*>(q);
  auto tp = static_cast<const int8_t*>(t);
  auto hp = static_cast<const int32_t*>(h0);
  auto vp = static_cast<int32_t*>(vdirs);
  auto wp = static_cast<int16_t*>(wcol);
  auto np = static_cast<int32_t*>(nm);
  auto s = static_cast<cudaStream_t>(stream);
  switch (rs.K * 10000 + rs.max_threads) {
    case 40512:
      return launch_wide<4, 512>(qp, tp, hp, B, L, W, band, i0, n, tiles, vp,
                                 wp, np, s);
    case 80512:
      return launch_wide<8, 512>(qp, tp, hp, B, L, W, band, i0, n, tiles, vp,
                                 wp, np, s);
    case 160512:
      return launch_wide<16, 512>(qp, tp, hp, B, L, W, band, i0, n, tiles,
                                  vp, wp, np, s);
    case 160640:
      return launch_wide<16, 640>(qp, tp, hp, B, L, W, band, i0, n, tiles,
                                  vp, wp, np, s);
    case 161024:
      return launch_wide<16, 1024>(qp, tp, hp, B, L, W, band, i0, n, tiles,
                                   vp, wp, np, s);
    case 320640:
      return launch_wide<32, 640>(qp, tp, hp, B, L, W, band, i0, n, tiles,
                                  vp, wp, np, s);
    case 321024:
      return launch_wide<32, 1024>(qp, tp, hp, B, L, W, band, i0, n, tiles,
                                   vp, wp, np, s);
    default: return -1;
  }
}

}  // namespace

// C interface for ctypes.  Each returns 0 on success, a cudaError_t code when
// the launch is refused, or -1 for a shape the kernel does not take (band %
// 128 == 0 up to 32768; 0 <= W < band; i0, n multiples of 16, 0 < n,
// i0 + n * tiles <= L; h0 not null).
//
// `tiles` consecutive tiles of n rows, tile y entered from h0[y] (tiles, B,
// band) at global row i0 + y*n, in one launch of grid (B, tiles); a whole
// pass is one tile, i0 = 0, n = L, entered from row 0.
extern "C" int lrm_band_dp_tiles(const void* q, const void* t, const void* h0,
                                 int B, int L, int W, int band, int i0, int n,
                                 int tiles, void* vdirs, void* wcol, void* nm,
                                 void* stream) {
  return dispatch_wide(q, t, h0, B, L, W, band, i0, n, tiles, vdirs, wcol, nm,
                       stream);
}
