// The CIGAR walks over the banded DP's direction words for Hopper (sm_90a):
// walk_c_kernel, the column-consuming walk of a resident pass, and
// gact_walk_kernel, the same walk over a group of rematerialized gact tiles
// with one write pointer shared by every lane.
//
// Replaces the XLA loops of the JAX package (neither is a pallas_call):
//   walk_c_kernel    longreadmapper_tpu/ops/traceback.py::device_traceback_c
//                    (a lax.while_loop)
//   gact_walk_kernel longreadmapper_tpu/ops/gact.py::gact_traceback_c
//                    (a lax.while_loop a tile inside a lax.scan over tiles)
// Contract: the plain PyTorch walks device_traceback_c_plain
// (ops/traceback.py) and gact_traceback_c_plain (ops/gact.py), bit for bit,
// degenerate lanes included: every clamp of the plain walk is here.
//
//   vdirs (G, B, band) int32    2-bit directions 0=M 1=I 2=D, 16 rows a word
//                               (row i of the pass or tile at bit pair
//                               (i-1) & 15)
//   nm    (ceil(G/32), B, band) bit g&31 of word g>>5 set iff vdirs[g] at
//                               (b, d) holds a non-M pair
//   runs                        (count << 2) | op entries in reverse path
//                               order, ops 0=M 1=I 2=D, pad 3
//
// One iteration of a lane, from cell (i, j) at band column d = j - i + W:
// the current group's word with the pairs above row i masked off; if it
// holds no non-M pair, the group bitmap gives the highest lower group that
// does, and that group's word gives the row of the next indel.  The lane
// consumes the M-run down to that row and the indel (or, at row 0, the
// synthetic all-D run), and writes two entries.
//
// What bounds these walks on this card: not bytes and not operations but
// latency.  An iteration is a chain of two dependent global loads: first the
// current word and the first bitmap word, both at (g_cur, d) and loaded
// together, then the target group's word (skipped when the indel is in the
// current word).  The words of a pass or group are up to mid_dirs_budget =
// 1 GiB (134 MB at the 1 kb main shape), not in the 50 MB L2, and a lane's
// next address depends on the word it just read, so each load is a DRAM
// round trip (~0.6-1 us).  A walk's time is about its longest lane's
// iterations times two round trips; the bytes it must move (three words a
// lane-iteration and the entries) take a few microseconds at 3.35 TB/s.
// Design, a simple kernel that is right first: one thread a lane keeps its
// (i, j, done) in registers (walk_c_kernel) or shared memory
// (gact_walk_kernel, up to kGactSmemLanes lanes), so nothing of the walk's
// state goes through device memory, and the host is not asked anything
// until the walk ends.  Staging the next words or splitting a lane's
// search over a warp is later work.
// Measured (chip_smoke.py phase 3; PERF.md; NVIDIA H100 80GB HBM3, 700 W):
// 1.01 us an iteration of the longest lane at the 10 kb resident shape
// (0.149 ms for 147 iterations), 1.30 us a block iteration over a 50 kb
// gact pass (1.76 ms), against 1.45 s and 2.85 s for the plain walks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 3;
constexpr int kWalkThreads = 128;     // walk_c_kernel's block
constexpr int kGactMaxThreads = 1024;  // gact_walk_kernel's one block
// lanes whose state (12 bytes each) fits the card's 227 KB of shared memory
// a block; more lanes keep it in global memory
constexpr int kGactSmemLanes = 227 * 1024 / 12;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// vdirs[g, b, d] with the flat index clamped to [0, G*B*band - 1], as the
// plain walk's word_at.
__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ v,
                                            int g, int b, int d, int B,
                                            int band, long long nwords) {
  long long flat = (static_cast<long long>(g) * B + b) * band + d;
  flat = flat < 0 ? 0 : (flat > nwords - 1 ? nwords - 1 : flat);
  return __ldg(v + flat);
}

// Bits of bitmap word w that stand for groups strictly below g_cur: the
// plain walk's (1 << clamp(g_cur - 32w, 0, 32)) - 1, all ones at 32 (a C
// shift by 32 is undefined).
__device__ __forceinline__ uint32_t below_mask(int g_cur, int w) {
  const int lim = clampi(g_cur - (w << 5), 0, 32);
  return lim >= 32 ? 0xFFFFFFFFu : ((1u << lim) - 1u);
}

// The highest group strictly below g_cur whose bitmap bit is set at bmidx,
// -1 if none.  The plain walk scans all nbm words from the top and keeps
// the first hit; words above g_cur's own have no bit below g_cur, so the
// scan starts at min(nbm-1, g_cur>>5) and stops at the first non-zero
// masked word, which gives the same group.  bw0 is word `w0`, loaded by the
// caller beside the current direction word.
__device__ __forceinline__ int group_below(const uint32_t* __restrict__ nm,
                                           long long plane, int bmidx,
                                           int g_cur, int w0, uint32_t bw0) {
  uint32_t bwk = bw0 & below_mask(g_cur, w0);
  int w = w0;
  while (bwk == 0 && w > 0) {
    --w;
    bwk = __ldg(nm + w * plane + bmidx) & below_mask(g_cur, w);
  }
  return bwk ? (w << 5) + 31 - __clz(static_cast<int>(bwk)) : -1;
}

// (count << 2) | op in the entry type, the low bits kept as the plain
// walk's int64 -> int16/int32 cast keeps them.
template <typename E>
__device__ __forceinline__ E entry(int count, int op) {
  return static_cast<E>(
      static_cast<uint32_t>((static_cast<uint32_t>(count) << 2) | op));
}

// ---------------------------------------------------------------------------
// walk_c_kernel: one thread a lane, grid ceil(B/128) x 128.  A lane's runs
// depend on its own words alone, and a done lane writes only pads into a
// buffer the wrapper fills with pads, so each thread walks its lane to done
// or to n_iter = traceback_c_iters(L, W) iterations; iteration `it` writes
// entries 2*it and 2*it+1 of the lane's row of runs (B, 2*n_iter), the
// final layout.
template <typename E>
__global__ void __launch_bounds__(kWalkThreads)
walk_c_kernel(const uint32_t* __restrict__ vdirs,
              const uint32_t* __restrict__ nm,
              const int32_t* __restrict__ lens, int G, int B, int band, int W,
              int n_iter, E* __restrict__ runs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int nbm = (G + 31) >> 5;
  const long long plane = static_cast<long long>(B) * band;
  const long long nwords = plane * G;
  E* out = runs + static_cast<long long>(b) * 2 * n_iter;
  int i = lens[b];
  int j = i;
  bool done = i <= 0;
  for (int it = 0; it < n_iter && !done; ++it) {
    const int d = clampi(j - i + W, 0, band - 1);
    const int ii = i - 1 > 0 ? i - 1 : 0;
    const int g_cur = ii >> 4;
    const int r = ii & 15;
    const int bmidx = clampi(b * band + d, 0, B * band - 1);
    const int w0 = min(nbm - 1, g_cur >> 5);
    // the chain's first round trip: both loads at (g_cur, d)
    const uint32_t w_cur = word_at(vdirs, g_cur, b, d, B, band, nwords);
    const uint32_t bw0 = __ldg(nm + w0 * plane + bmidx);
    const int sh = 2 * (15 - r);
    const uint32_t wm_cur = (w_cur << sh) >> sh;   // pairs above row i off
    const bool in_cur = wm_cur != 0;
    const int g2 = in_cur ? -1 : group_below(nm, plane, bmidx, g_cur, w0,
                                             bw0);
    const bool any_nm = i > 0 && (in_cur || g2 >= 0);
    const int gstar = in_cur ? g_cur : (g2 > 0 ? g2 : 0);
    // the second: the target group's word, needed only for an indel below
    const uint32_t wsel =
        in_cur ? wm_cur
               : (any_nm ? word_at(vdirs, gstar, b, d, B, band, nwords) : 0u);
    // 15 - (clz >> 1): the word's lowest row with a non-M pair; -1 for 0
    const int pstar = 15 - (__clz(static_cast<int>(wsel)) >> 1);
    const int re = any_nm ? gstar * 16 + pstar + 1 : 0;
    const int mrun = i - re;
    const int i2 = i - mrun;
    const int j2 = j - mrun;
    const int op = static_cast<int>((wsel >> (2 * (pstar > 0 ? pstar : 0)))
                                    & 3u);
    const int i3 = (any_nm && op == 1) ? i2 - 1 : i2;
    const int j3 = (any_nm && op == 2) ? j2 - 1 : j2;
    // row 0 reached with target left: the synthetic all-D row
    const int drun = (!any_nm && i2 == 0) ? (j2 > 0 ? j2 : 0) : 0;
    const int j4 = drun > 0 ? 0 : j3;
    done = i3 == 0 && j4 == 0;
    out[2 * it] = mrun > 0 ? entry<E>(mrun, 0) : static_cast<E>(kPad);
    out[2 * it + 1] = any_nm     ? entry<E>(1, op)
                      : drun > 0 ? entry<E>(drun, 2)
                                 : static_cast<E>(kPad);
    i = i3;
    j = j4;
  }
}

// ---------------------------------------------------------------------------
// gact_walk_kernel: one CTA walks the tiles k_hi down to k_lo of one
// rematerialized group (vg (tiles, G, B, band), nmg (tiles, ceil(G/32), B,
// band), tile k at k - k_lo) for all B lanes.  The lanes are coupled: every
// iteration writes every lane's pair into buffer row `ptr` (pads for a lane
// that is not alive), and ptr is shared, so the block iterates a tile until
// no lane is alive (__syncthreads_or) or tile_bound = W + 4 iterations.  ptr
// clamps at n_rows - 1, and each write at that row counts in nsat (two or
// more: the buffer saturated).  Thread x walks lanes x, x + blockDim, ...;
// their (i, j, done) live in shared memory for the launch and in st
// (3B + 2 int32: i, j, done, then ptr and nsat) between the group's
// launches; past kGactSmemLanes lanes (12 bytes a lane) the launch works
// on st in global memory itself (use_global), the same code over another
// pointer: each lane's state is touched only by its own thread.
// Time: about the tiles' longest-lane iterations, each a chain of two DRAM
// round trips and one block barrier, on one SM: the step makes one launch
// a group after the group's direction kernel, and no host sync.
__global__ void __launch_bounds__(kGactMaxThreads)
gact_walk_kernel(const uint32_t* __restrict__ vg,
                 const uint32_t* __restrict__ nmg, int32_t* __restrict__ st,
                 int16_t* __restrict__ buf, int B, int T, int W, int band,
                 int k_lo, int k_hi, int n_rows, int use_global) {
  extern __shared__ int32_t s_state[];
  int32_t* si = use_global ? st : s_state;
  int32_t* sj = si + B;
  int32_t* sd = si + 2 * B;
  for (int b = threadIdx.x; b < B && !use_global; b += blockDim.x) {
    si[b] = st[b];
    sj[b] = st[B + b];
    sd[b] = st[2 * B + b];
  }
  int ptr = st[3 * B];
  int nsat = st[3 * B + 1];
  const int G = T >> 4;
  const int nbm = (G + 31) >> 5;
  const int tile_bound = W + 4;
  const long long plane = static_cast<long long>(B) * band;
  const long long nwords = plane * G;
  for (int k = k_hi; k >= k_lo; --k) {
    const uint32_t* v = vg + (k - k_lo) * nwords;
    const uint32_t* nm = nmg + (k - k_lo) * nbm * plane;
    const int lo = k * T;
    for (int it = 0; it < tile_bound; ++it) {
      int any = 0;
      for (int b = threadIdx.x; b < B; b += blockDim.x) {
        any |= !sd[b] && (si[b] > lo || (k == 0 && sj[b] > 0));
      }
      if (!__syncthreads_or(any)) break;
      for (int b = threadIdx.x; b < B; b += blockDim.x) {
        int i = si[b];
        int j = sj[b];
        const bool in_tile = i > lo;
        const bool active = !sd[b] && (in_tile || (k == 0 && j > 0));
        int16_t e1 = kPad;
        int16_t e2 = kPad;
        if (active) {
          bool any_nm = false;
          int gstar = 0;
          uint32_t wsel = 0;
          if (in_tile) {
            const int d = clampi(j - i + W, 0, band - 1);
            const int ii = clampi(i - 1 - lo, 0, T - 1);  // row in the tile
            const int g_cur = ii >> 4;
            const int r = ii & 15;
            const int bmidx = clampi(b * band + d, 0, B * band - 1);
            const int w0 = min(nbm - 1, g_cur >> 5);
            const uint32_t w_cur = word_at(v, g_cur, b, d, B, band, nwords);
            const uint32_t bw0 = __ldg(nm + w0 * plane + bmidx);
            const int sh = 2 * (15 - r);
            const uint32_t wm_cur = (w_cur << sh) >> sh;
            const bool in_cur = wm_cur != 0;
            const int g2 = in_cur ? -1 : group_below(nm, plane, bmidx, g_cur,
                                                     w0, bw0);
            any_nm = in_cur || g2 >= 0;
            gstar = in_cur ? g_cur : (g2 > 0 ? g2 : 0);
            wsel = in_cur ? wm_cur
                          : (any_nm ? word_at(v, gstar, b, d, B, band, nwords)
                                    : 0u);
          }
          int pstar = 15 - (__clz(static_cast<int>(wsel)) >> 1);
          pstar = pstar > 0 ? pstar : 0;
          // M-run floor: the indel row, else the tile entry (row 0 in tile
          // 0: the walk then owes only the synthetic all-D row)
          const int floor_row =
              any_nm ? lo + gstar * 16 + pstar + 1 : (k == 0 ? 0 : lo);
          const int mrun = in_tile ? i - floor_row : 0;
          const int i2 = i - mrun;
          const int j2 = j - mrun;
          const int op = static_cast<int>((wsel >> (2 * pstar)) & 3u);
          const bool take_e = any_nm && !(i2 == 0 && j2 == 0);
          const int i3 = (take_e && op == 1) ? i2 - 1 : i2;
          const int j3 = (take_e && op == 2) ? j2 - 1 : j2;
          const int drun = (!any_nm && i2 == 0) ? (j2 > 0 ? j2 : 0) : 0;
          const int j4 = drun > 0 ? 0 : j3;
          if (mrun > 0) e1 = entry<int16_t>(mrun, 0);
          if (take_e) {
            e2 = entry<int16_t>(1, op);
          } else if (drun > 0) {
            e2 = entry<int16_t>(drun, 2);
          }
          i = i3;
          j = j4;
          si[b] = i;
          sj[b] = j;
        }
        if (i == 0 && j == 0) sd[b] = 1;
        int16_t* row = buf + (static_cast<long long>(b) * n_rows + ptr) * 2;
        row[0] = e1;
        row[1] = e2;
      }
      // writes that land on the clamped last row: the first is legitimate,
      // every later one overwrites it for all lanes
      nsat += ptr == n_rows - 1;
      ptr = min(ptr + 1, n_rows - 1);
    }
  }
  for (int b = threadIdx.x; b < B && !use_global; b += blockDim.x) {
    st[b] = si[b];
    st[B + b] = sj[b];
    st[2 * B + b] = sd[b];
  }
  if (threadIdx.x == 0) {
    st[3 * B] = ptr;
    st[3 * B + 1] = nsat;
  }
}

int gact_threads(int B) {
  const int t = (B + 31) / 32 * 32;
  return t < kGactMaxThreads ? t : kGactMaxThreads;
}

}  // namespace

// C interface for ctypes.  Each returns 0 on success, a cudaError_t code
// when the launch is refused, or -1 for arguments the kernel does not take.

// The column walk of a resident pass: vdirs (G, B, band) and nm
// (ceil(G/32), B, band) int32, lens (B,) int32, runs (B, 2*n_iter) of
// entry_bytes = 2 (int16) or 4 (int32), filled with pads by the caller.
extern "C" int lrm_walk_c(const void* vdirs, const void* nm, const void* lens,
                          int G, int B, int band, int W, int n_iter,
                          void* runs, int entry_bytes, void* stream) {
  if (G <= 0 || B <= 0 || band <= 0 || W < 0 || n_iter < 0) return -1;
  if (static_cast<long long>(B) * band > 0x7FFFFFFFLL) return -1;
  auto v = static_cast<const uint32_t*>(vdirs);
  auto m = static_cast<const uint32_t*>(nm);
  auto l = static_cast<const int32_t*>(lens);
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = (B + kWalkThreads - 1) / kWalkThreads;
  if (entry_bytes == 2) {
    walk_c_kernel<int16_t><<<grid, kWalkThreads, 0, s>>>(
        v, m, l, G, B, band, W, n_iter, static_cast<int16_t*>(runs));
  } else if (entry_bytes == 4) {
    walk_c_kernel<int32_t><<<grid, kWalkThreads, 0, s>>>(
        v, m, l, G, B, band, W, n_iter, static_cast<int32_t*>(runs));
  } else {
    return -1;
  }
  return cudaGetLastError();
}

// The gact walk over one group: tiles k_lo .. k_hi of T rows, vg (k_hi -
// k_lo + 1, T/16, B, band) and nmg (k_hi - k_lo + 1, ceil(T/16/32), B, band)
// int32, st (3B + 2) int32 carried between the groups' launches, buf (B,
// n_rows, 2) int16 filled with pads by the caller before the first group.
extern "C" int lrm_gact_walk(const void* vg, const void* nmg, void* st,
                             void* buf, int B, int T, int W, int band,
                             int k_lo, int k_hi, int n_rows, void* stream) {
  if (B <= 0 || T <= 0 || T % 16 != 0 || W < 0 || band <= 0 || k_lo < 0
      || k_hi < k_lo || n_rows <= 0) {
    return -1;
  }
  if (static_cast<long long>(B) * band > 0x7FFFFFFFLL) return -1;
  const int use_global = B > kGactSmemLanes;
  const size_t smem =
      use_global ? 0 : static_cast<size_t>(3) * B * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gact_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  gact_walk_kernel<<<1, gact_threads(B), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vg), static_cast<const uint32_t*>(nmg),
      static_cast<int32_t*>(st), static_cast<int16_t*>(buf), B, T, W, band,
      k_lo, k_hi, n_rows, use_global);
  return cudaGetLastError();
}
