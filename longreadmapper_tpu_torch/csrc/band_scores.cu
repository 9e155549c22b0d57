// Banded unit-cost Needleman-Wunsch score rows for Hopper (sm_90a).
//
// Replaces the TPU kernel longreadmapper_tpu/ops/wavefront_pallas.py
// ::banded_nw_scores_pallas (kernel from _make_kernel).  The recurrence is
// the direction kernels' without direction bits, on the CTA-per-read row
// core of band_row.cuh (design, bounds and traps there).  Two entry points:
//
//   full matrix (T == 0): H (L+1, B, band) int16, INF = 0x3FFF outside the
//     band or the DP domain, row 0 = |j| — the contract of the plain
//     longreadmapper_tpu_torch/ops/wavefront.py::banded_nw_scores (JAX
//     ops/wavefront.banded_nw_scores);
//   checkpoints (T > 0, L % T == 0): ckpt (L/T+1, B, band) int32 with
//     ckpt[k] = H row k*T, and wcol (L+1, B) int16 = H[:, :, W] — the
//     contract of ops/gact.py::gact_forward, the forward pass of the tiled
//     long-read path.  It writes band*4 bytes per T rows per read instead of
//     a row per row.
//
// Each thread stores its K columns of a score row as int16 in the full
// mode, or of every T-th row as int32 in the checkpoint mode.

#include <cstdint>
#include <cuda_runtime.h>

#include "band_row.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(lrm::kMaxThreads)
band_scores_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                   int B, int L, int W, int band, int T,
                   int16_t* __restrict__ H, int32_t* __restrict__ ckpt,
                   int16_t* __restrict__ wcol) {
  extern __shared__ int4 smem_raw[];
  lrm::RowSmem& s = *reinterpret_cast<lrm::RowSmem*>(smem_raw);
  const lrm::Geom g = lrm::make_geom(q, t, L, W, band, K);
  int8_t* s_tp = reinterpret_cast<int8_t*>(&s + 1);
  int8_t* s_q = s_tp + lrm::kWindowRows + g.cols;
  const int b = blockIdx.x;
  const bool real = g.d0 < band;  // band % K == 0: all K columns or none
  const bool has_w = W >= g.d0 && W < g.d0 + K;

  // row 0: H(0, j) = j inside the domain
  int h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j0 = g.d0 + k - W;
    h[k] = (real && j0 >= 0 && j0 <= L) ? j0 : lrm::kInf;
    if (!real) continue;
    const size_t at = static_cast<size_t>(b) * band + g.d0 + k;
    if (T == 0) {
      H[at] = static_cast<int16_t>(h[k]);
    } else {
      ckpt[at] = h[k];
      if (g.d0 + k == W) wcol[b] = static_cast<int16_t>(h[k]);
    }
  }
  lrm::publish_entry<K>(h, g, s);

  for (int r0 = 0; r0 < L; r0 += lrm::kWindowRows) {
    const int rows = min(lrm::kWindowRows, L - r0);
    lrm::stage_window(g, r0, rows, s_tp, s_q);
    for (int x = 0; x < rows; ++x) {
      const int i = r0 + 1 + x;
      int16_t* hrow =
          T == 0 ? H + (static_cast<size_t>(i) * B + b) * band : nullptr;
      int wc = 0;
      lrm::row_step<K>(h, i, g, s, s_tp, s_q, r0,
                       [&](int k, int d, int, int, int, int row) {
        if (T == 0 && real) hrow[d] = static_cast<int16_t>(row);
        if (d == W) wc = row;
      });
      if (T == 0) continue;
      if (has_w)
        wcol[static_cast<size_t>(i) * B + b] = static_cast<int16_t>(wc);
      if (i % T == 0 && real) {
        int32_t* out =
            ckpt + (static_cast<size_t>(i / T) * B + b) * band + g.d0;
#pragma unroll
        for (int k = 0; k < K; k += 4)
          *reinterpret_cast<int4*>(out + k) =
              make_int4(h[k], h[k + 1], h[k + 2], h[k + 3]);
      }
    }
  }
}

template <int K>
cudaError_t launch(const int8_t* q, const int8_t* t, int B, int L, int W,
                   int band, int T, int16_t* H, int32_t* ckpt, int16_t* wcol,
                   cudaStream_t stream) {
  const int threads = lrm::row_threads(band, K);
  const size_t smem =
      sizeof(lrm::RowSmem) + lrm::window_bytes(threads * K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        band_scores_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  band_scores_kernel<K><<<B, threads, smem, stream>>>(q, t, B, L, W, band, T,
                                                      H, ckpt, wcol);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  T == 0: H must be given; T > 0: ckpt and wcol.
// Returns 0 on success, a cudaError_t code when the launch is refused, or -1
// for a shape the kernel does not take (band % 128 == 0 up to 16384,
// 0 <= W < band, T % 16 == 0 and L % T == 0 when T > 0).
extern "C" int lrm_band_scores(const void* q, const void* t, int B, int L,
                               int W, int band, int T, void* H, void* ckpt,
                               void* wcol, void* stream) {
  const int K = lrm::cols_per_thread(band);
  if (B <= 0 || L <= 0 || W < 0 || W >= band || K == 0 || T < 0) return -1;
  if (T == 0 ? H == nullptr
             : (T % 16 != 0 || L % T != 0 || ckpt == nullptr ||
                wcol == nullptr))
    return -1;
  auto qp = static_cast<const int8_t*>(q);
  auto tp = static_cast<const int8_t*>(t);
  auto hp = static_cast<int16_t*>(H);
  auto cp = static_cast<int32_t*>(ckpt);
  auto wp = static_cast<int16_t*>(wcol);
  auto s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4: return launch<4>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
    case 8: return launch<8>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
    case 16: return launch<16>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
    case 32: return launch<32>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
    default: return -1;
  }
}
