// Banded unit-cost Needleman-Wunsch score rows for Hopper (sm_90a).
//
// Replaces the TPU kernel longreadmapper_tpu/ops/wavefront_pallas.py
// ::banded_nw_scores_pallas (kernel from _make_kernel).  The recurrence is
// the direction kernels' without direction bits, on the row core of
// band_row.cuh (design, bounds and traps there).  Two entry points:
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
// What bounds it: a read's rows are one dependent chain, so a launch runs
// B chains, one CTA each.  A 50 kb gact pass has B = 40: one CTA a read
// puts 40 of the 132 SMs to work, and reached 17.6% of the operations
// bound (41.95 ms; PERF.md; NVIDIA H100 80GB HBM3, 700 W).  So the
// kernel can split a read over a thread-block cluster of C CTAs
// (band_scores_cluster_kernel: grid C*B, cluster (C, 1, 1), launched by
// cudaLaunchKernelEx, one CTA an SM): each CTA takes a contiguous range of
// the band's columns, and the read's warps meet once a row by DSMEM
// stores that signal the receiving CTA's mbarrier (band_row.cuh
// cluster_row).  That meeting costs 117-316 ns a row against 35-41 ns for
// a CTA's __syncthreads (and 433-1344 ns for a cluster barrier), so the
// split pays only where a row's work is large against it and every
// cluster is resident at once: at B = 40, C = 2 took a 50 kb pass from
// 42.09 to 28.05 ms at band 5120 and from 68.02 to 40.75 ms at 10112
// (PERF.md, scripts/torch_cluster_sweep.py; NVIDIA H100 80GB HBM3,
// 700.00 W).  C is the
// caller's (ops/band_scores.py::cluster_ctas, from the shape); C = 1 is
// band_scores_kernel, the CTA-per-read kernel, on the same row as
// band_dp_wide.
//
// Each thread stores its K columns of a score row as int16 in the full
// mode, or of every T-th row as int32 in the checkpoint mode.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "band_row.cuh"

namespace {

template <int K, int MAXT>
__global__ void __launch_bounds__(MAXT)
band_scores_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                   int B, int L, int W, int band, int T,
                   int16_t* __restrict__ H, int32_t* __restrict__ ckpt,
                   int16_t* __restrict__ wcol) {
  extern __shared__ int4 smem_raw[];
  lrm::RowSmem& s = *reinterpret_cast<lrm::RowSmem*>(smem_raw);
  const lrm::Geom g = lrm::make_geom(q, t, L, W, band, K);
  int8_t* s_tp = reinterpret_cast<int8_t*>(&s + 1);
  int8_t* s_q = s_tp + lrm::target_bytes(g.cols);
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
  lrm::init_row_smem(g, s);

  for (int r0 = 0; r0 < L; r0 += lrm::kWindowRows) {
    const int rows = min(lrm::kWindowRows, L - r0);
    lrm::stage_window(g, r0, rows, s_tp, s_q);
    for (int x = 0; x < rows; ++x) {
      const int i = r0 + 1 + x;
      int16_t* hrow =
          T == 0 ? H + (static_cast<size_t>(i) * B + b) * band : nullptr;
      lrm::row_step<K>(h, i, g, s, s_tp, s_q, r0,
                       [&](int, int d, int, int, int, int row) {
        if (T == 0 && real) hrow[d] = static_cast<int16_t>(row);
      });
      if (T == 0) continue;
      if (has_w)
        wcol[static_cast<size_t>(i) * B + b] =
            static_cast<int16_t>(lrm::column_w<K>(h, g));
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

template <int K, int MAXT>
cudaError_t launch(const int8_t* q, const int8_t* t, int B, int L, int W,
                   int band, int T, int16_t* H, int32_t* ckpt, int16_t* wcol,
                   cudaStream_t stream) {
  const int threads = lrm::row_threads(band, K);
  const size_t smem =
      sizeof(lrm::RowSmem) + lrm::window_bytes(threads * K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        band_scores_kernel<K, MAXT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  band_scores_kernel<K, MAXT><<<B, threads, smem, stream>>>(
      q, t, B, L, W, band, T, H, ckpt, wcol);
  return cudaGetLastError();
}

// band_scores_kernel over a cluster of C CTAs a read (C from the launch);
// FULL: the full matrix (T == 0), else the checkpoints, so that neither
// mode issues the other's stores.
template <int K, bool FULL>
__global__ void __launch_bounds__(lrm::kClusterThreads)
band_scores_cluster_kernel(const int8_t* __restrict__ q,
                           const int8_t* __restrict__ t, int B, int L, int W,
                           int band, int T, int16_t* __restrict__ H,
                           int32_t* __restrict__ ckpt,
                           int16_t* __restrict__ wcol) {
  extern __shared__ int4 smem_raw[];
  lrm::ClusterSmem& s = *reinterpret_cast<lrm::ClusterSmem*>(smem_raw);
  const lrm::ClusterGeom g = lrm::make_cluster_geom(q, t, L, W, band, K);
  int8_t* s_tp = reinterpret_cast<int8_t*>(&s + 1);
  int8_t* s_q = s_tp + lrm::target_bytes(g.cols);
  const int b = g.b;
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
    if constexpr (FULL) {
      H[at] = static_cast<int16_t>(h[k]);
    } else {
      ckpt[at] = h[k];
      if (g.d0 + k == W) wcol[b] = static_cast<int16_t>(h[k]);
    }
  }
  lrm::init_cluster_smem(g, s);

  int next_ckpt = T;  // the next checkpoint row (T > 0)
  for (int r0 = 0; r0 < L; r0 += lrm::kWindowRows) {
    const int rows = min(lrm::kWindowRows, L - r0);
    lrm::stage_cluster_window(g, r0, rows, s_tp, s_q);
    uint32_t sub[K / 4];  // the row's substitution words
    lrm::sub_words<K>(sub, s_tp, 0, g.d0 - g.c0, s_q[0]);
    for (int x = 0; x < rows; ++x) {
      const int i = r0 + 1 + x;
      int16_t* hrow = H + (static_cast<size_t>(i) * B + b) * band;
      lrm::cluster_row<K>(h, sub, i, g, s, s_tp, s_q,
                          x + 1 < rows ? x + 1 : -1,
                          [&](int, int d, int, int, int, int row) {
        if (FULL && real) hrow[d] = static_cast<int16_t>(row);
      });
      if constexpr (FULL) continue;
      if (has_w)
        wcol[static_cast<size_t>(i) * B + b] =
            static_cast<int16_t>(lrm::column_w<K>(h, g));
      if (i != next_ckpt) continue;
      next_ckpt += T;
      if (!real) continue;
      int32_t* out =
          ckpt + (static_cast<size_t>(i / T) * B + b) * band + g.d0;
#pragma unroll
      for (int k = 0; k < K; k += 4)
        *reinterpret_cast<int4*>(out + k) =
            make_int4(h[k], h[k + 1], h[k + 2], h[k + 3]);
    }
  }
  lrm::end_cluster_rows();
}

// The launch configuration of C*B CTAs of `threads` in clusters of C.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(int B, int C, int threads, size_t smem, cudaStream_t stream)
      : cfg(), attr() {
    cfg.gridDim = dim3(static_cast<unsigned>(B) * C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// A cluster CTA's dynamic shared memory: its arrays, and at least
// kOneCtaPerSm so that no two CTAs share an SM.
template <int K>
size_t cluster_smem(int threads) {
  return std::max<size_t>(
      sizeof(lrm::ClusterSmem) + lrm::window_bytes(threads * K),
      lrm::kOneCtaPerSm);
}

template <int K>
cudaError_t launch_cluster(const int8_t* q, const int8_t* t, int B, int L,
                           int W, int band, int T, int C, int16_t* H,
                           int32_t* ckpt, int16_t* wcol,
                           cudaStream_t stream) {
  const int threads = lrm::cluster_threads(band, K, C);
  const size_t smem = cluster_smem<K>(threads);
  auto kernel = T == 0 ? band_scores_cluster_kernel<K, true>
                       : band_scores_cluster_kernel<K, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ClusterLaunch cl(B, C, threads, smem, stream);
  e = cudaLaunchKernelEx(&cl.cfg, kernel, q, t, B, L, W, band, T, H, ckpt,
                         wcol);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Clusters of C CTAs of the (band, K) shape that the card holds at once.
template <int K>
int max_clusters(int B, int band, int C) {
  const int threads = lrm::cluster_threads(band, K, C);
  const size_t smem = cluster_smem<K>(threads);
  auto kernel = band_scores_cluster_kernel<K, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  ClusterLaunch cl(B, C, threads, smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cl.cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}

// The row's meeting alone, `rows` times, and a read of the next warp's
// slot after it.  mode 0: the slot store and __syncthreads (C = 1, the
// CTA-per-read row); 1: DSMEM slot stores (st.shared::cluster) and the
// cluster barrier (barrier.cluster.arrive.release / wait.acquire); 2: the
// cluster row's meeting, st.async into every CTA and the row's mbarrier.
// Times what a row pays to meet (PERF.md).
template <int MODE>
__global__ void meet_probe_kernel(int rows, int* __restrict__ sink) {
  extern __shared__ int4 smem_raw[];
  lrm::ClusterSmem& s = *reinterpret_cast<lrm::ClusterSmem*>(smem_raw);
  int rank = 0, ctas = 1;
  if constexpr (MODE > 0) {
    rank = lrm::cluster_rank();
    ctas = lrm::cluster_size();
  }
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int gwarp = rank * nwarps + (threadIdx.x >> 5);
  const int next = (gwarp + 1) % (ctas * nwarps);
  int acc = 0;
  if constexpr (MODE > 0) {
    if (threadIdx.x == 0) {
      lrm::mbar_init(&s.bar[0], 1);
      lrm::mbar_init(&s.bar[1], 1);
      lrm::mbar_init_fence();
    }
    lrm::cluster_arrive();
    lrm::cluster_wait();
  }
  for (int i = 1; i <= rows; ++i) {
    const int p = i & 1;
    if constexpr (MODE == 0) {
      if (lane == 0) s.slot[p][gwarp] = make_int2(i, acc);
      __syncthreads();
    } else if constexpr (MODE == 1) {
      lrm::store_peer_if(&s.slot[p][gwarp], lane % ctas, i, acc,
                         lane < ctas);
      lrm::cluster_arrive();
      lrm::cluster_wait();
    } else {
      if (threadIdx.x == 0) lrm::mbar_expect(&s.bar[p], ctas * nwarps * 8);
      lrm::send_peer_if(&s.slot[p][gwarp], &s.bar[p], lane % ctas, i, acc,
                        lane < ctas);
      lrm::mbar_wait(&s.bar[p], ((i - 1) >> 1) & 1);
    }
    acc += s.slot[p][next].x;
    // the row's shuffles keep a warp's lanes within a row of each other:
    // a lane two phases behind would wait on the wrong parity
    if constexpr (MODE == 2) __syncwarp();
  }
  if constexpr (MODE > 0) lrm::end_cluster_rows();
  if (acc == lrm::kBig) sink[0] = acc;  // keeps the loop
}

template <int MODE>
cudaError_t launch_probe(int clusters, int C, int threads, int rows,
                         int* sink, cudaStream_t stream) {
  auto kernel = meet_probe_kernel<MODE>;
  const size_t smem = MODE == 0 ? sizeof(lrm::ClusterSmem)
                                : static_cast<size_t>(lrm::kOneCtaPerSm);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  if constexpr (MODE == 0) {
    kernel<<<clusters, threads, smem, stream>>>(rows, sink);
    return cudaGetLastError();
  } else {
    ClusterLaunch cl(clusters, C, threads, smem, stream);
    cudaError_t e = cudaLaunchKernelEx(&cl.cfg, kernel, rows, sink);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
}

}  // namespace

// C interface for ctypes.  T == 0: H must be given; T > 0: ckpt and wcol.
// C (1 to 4) CTAs a read; K columns a thread, 0 for the default (C == 1:
// row_shape's, the only one it takes; C > 1: cluster_k's, or 4, 8 or 16
// where cluster_fits).  Returns 0 on success, a cudaError_t code when the
// launch is refused, or -1 for a shape the kernel does not take (band %
// 128 == 0 up to 32768, 0 <= W < band, T % 16 == 0 and L % T == 0 when
// T > 0).
extern "C" int lrm_band_scores(const void* q, const void* t, int B, int L,
                               int W, int band, int T, int C, int K, void* H,
                               void* ckpt, void* wcol, void* stream) {
  const lrm::RowShape rs = lrm::row_shape(band);
  if (B <= 0 || L <= 0 || W < 0 || W >= band || rs.K == 0 || T < 0)
    return -1;
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
  if (C == 1) {
    if (K != 0) return -1;
    switch (rs.K * 10000 + rs.max_threads) {
      case 40512:
        return launch<4, 512>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
      case 80512:
        return launch<8, 512>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
      case 160512:
        return launch<16, 512>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
      case 160640:
        return launch<16, 640>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
      case 161024:
        return launch<16, 1024>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
      case 320640:
        return launch<32, 640>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
      case 321024:
        return launch<32, 1024>(qp, tp, B, L, W, band, T, hp, cp, wp, s);
      default: return -1;
    }
  }
  if (K == 0) K = lrm::cluster_k(band, C);
  if (!lrm::cluster_fits(band, K, C)) return -1;
  switch (K) {
    case 4:
      return launch_cluster<4>(qp, tp, B, L, W, band, T, C, hp, cp, wp, s);
    case 8:
      return launch_cluster<8>(qp, tp, B, L, W, band, T, C, hp, cp, wp, s);
    case 16:
      return launch_cluster<16>(qp, tp, B, L, W, band, T, C, hp, cp, wp, s);
    default: return -1;
  }
}

// cudaOccupancyMaxActiveClusters for lrm_band_scores's cluster launch of
// (B, band, C, K): the clusters resident at once; -1 for a shape it does
// not take, minus a cudaError_t code on an error.
extern "C" int lrm_band_scores_clusters(int B, int band, int C, int K) {
  if (B <= 0) return -1;
  if (K == 0) K = lrm::cluster_k(band, C);
  if (!lrm::cluster_fits(band, K, C)) return -1;
  switch (K) {
    case 4: return max_clusters<4>(B, band, C);
    case 8: return max_clusters<8>(B, band, C);
    case 16: return max_clusters<16>(B, band, C);
    default: return -1;
  }
}

// meet_probe_kernel<mode> over `clusters` clusters of C CTAs (mode 0: C =
// 1, CTAs without a cluster; modes 1 and 2: C >= 2) of `threads` threads
// for `rows` rows; sink is one int32 on the card.  Returns 0, a cudaError_t
// code, or -1 for a shape it does not take.
extern "C" int lrm_meet_probe(int clusters, int C, int threads, int rows,
                              int mode, void* sink, void* stream) {
  if (clusters <= 0 || C < 1 || C > lrm::kMaxCtas || (mode == 0) != (C == 1)
      || threads < 32 || threads > 1024 || threads % 32 != 0 || rows < 0 ||
      sink == nullptr)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto out = static_cast<int*>(sink);
  switch (mode) {
    case 0: return launch_probe<0>(clusters, C, threads, rows, out, s);
    case 1: return launch_probe<1>(clusters, C, threads, rows, out, s);
    case 2: return launch_probe<2>(clusters, C, threads, rows, out, s);
    default: return -1;
  }
}
