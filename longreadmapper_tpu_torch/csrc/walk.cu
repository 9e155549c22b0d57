// The CIGAR walks over the banded DP's direction words for Hopper (sm_90a):
// walk_c_kernel, the column-consuming walk of a resident pass, and
// gact_walk_kernel, the same walk over a group of rematerialized gact tiles,
// whose lanes share one write pointer into the run buffer.
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
// latency.  The words of a pass or group are up to mid_dirs_budget = 1 GiB
// (134 MB at the 1 kb main shape), not in the 50 MB L2, and a lane's next
// address depends on the word it just read, so a load is a DRAM round trip
// (one thread a lane, walk_c_kernel took 0.82 us an iteration for two in a
// chain); the bytes a walk must move (three words a lane-iteration and the
// entries) take a few microseconds at 3.35 TB/s.  Both kernels are a warp
// a lane.  An iteration moves the lane's column d by at most one (an indel
// moves it, an M-run does not), so the warp keeps the lane's columns d - 1
// .. d + 1 in a ring in shared memory, loaded by cp.async (each of the 32
// threads a word), and each iteration loads the one column that enters the
// window an iteration before the walk can reach it; the iteration itself
// (column_step on a tile, resident_step on a resident pass, which has its
// own clamps) reads the column in shared memory.
// gact_walk_kernel holds a tile's whole column (T = 512: 32 groups and a
// bitmap word).  walk_c_kernel holds a window of a resident column: the
// bitmap words over the lane's row and K groups down from it (K = 12 at the
// 10 kb pass, 30 at 1 kb: one copy a thread); a group below the window is
// one more round trip.  What bounds walk_c_kernel now is neither that
// round trip, hidden behind the iteration before it (the warp waits 13
// cycles an iteration for it at 10 kb), nor the fallbacks: a clock64 split
// of its loop (scripts/torch_walk_c_split.py) reads ~1330 cycles an
// iteration at 10 kb, 670 in resident_step and 560 in issuing the next
// column's copies (with a window of K 76, 96 copies a column and almost no
// fallbacks, the copies cost more than the fallbacks saved).  A column's
// words lie B * band words apart, a TLB page each; why a column's copies
// cost that much at issue and slow the shared-memory reads behind them is
// not measured.  Copies through registers (ld.global, st.shared), wider
// windows, more lanes an SM, a deeper window (d +- 2, 3) and a warp-wide
// bitmap scan measured slower.
// Measured (scripts/torch_walk_ab.py --walks, the tree before this design
// in the same call, kernels alone from a trace; NVIDIA H100 80GB HBM3,
// 700 W): walk_c_kernel 0.0753-0.0765 ms at the 10 kb resident pass (139
// iterations of the longest lane, 0.55 us each) against 0.1131-0.1147 for
// one thread a lane, and 0.0073 ms at 1 kb (9 iterations) against 0.0072;
// gact_walk_kernel 0.420-0.421 ms for the 50 kb pass's 628 iterations of
// the longest lane and 98 tiles, against 1.72 ms for the lock-step walk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 3;
constexpr int kGactWarps = 8;         // warps a CTA (the last CTA's copy)
constexpr int kGactLanes = 4;         // of them walking a lane each, at most
// a lane's column ring: kRing columns of a tile, the window d +- kAhead in
// it.  A slot is reused by the column kRing away, which enters the window
// kRing - 2 * kAhead iterations after the slot's last load at the earliest;
// that load is done by then when kRing >= 3 * kAhead + 1.  The constants
// are scripts/torch_walk_tables_sweep.py's fastest (PERF.md): a
// wider window costs more at each tile's entry than it hides, and more
// lanes an SM slow each lane.
constexpr int kRing = 4;
constexpr int kAhead = 1;
static_assert(kRing >= 3 * kAhead + 1, "a slot's load must land before "
              "the slot is loaded again");
static_assert(kGactLanes <= kGactWarps, "a lane is a warp of the CTA");
// walk_c_kernel: kWalkLanes lanes (warps) a CTA at most, each lane's
// columns d +- kWalkAhead in a ring of kWalkRing columns (the same rule as
// kRing's), a column's window at least kWalkGroups groups.  The constants
// are scripts/torch_walk_tables_sweep.py's fastest (PERF.md).
constexpr int kWalkLanes = 2;
constexpr int kWalkRing = 4;
constexpr int kWalkAhead = 1;
constexpr int kWalkGroups = 8;
static_assert(kWalkRing >= 3 * kWalkAhead + 1
              && (kWalkRing & (kWalkRing - 1)) == 0,
              "a power-of-2 ring whose slot's load lands before the slot "
              "takes another column");
constexpr int kCopyItems = 4;         // runs a thread of the last CTA copies
constexpr int kSmemMax = 227 * 1024;  // shared memory a block, opted in
constexpr uint32_t kPadPair = (kPad << 16) | kPad;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Bits of bitmap word w that stand for groups strictly below g_cur: the
// plain walk's (1 << clamp(g_cur - 32w, 0, 32)) - 1, all ones at 32 (a C
// shift by 32 is undefined).
__device__ __forceinline__ uint32_t below_mask(int g_cur, int w) {
  const int lim = clampi(g_cur - (w << 5), 0, 32);
  return lim >= 32 ? 0xFFFFFFFFu : ((1u << lim) - 1u);
}

// (count << 2) | op in the entry type, the low bits kept as the plain
// walk's int64 -> int16/int32 cast keeps them.
template <typename E>
__device__ __forceinline__ E entry(int count, int op) {
  return static_cast<E>(
      static_cast<uint32_t>((static_cast<uint32_t>(count) << 2) | op));
}

// ---------------------------------------------------------------------------
// Copies into a lane's ring of columns in shared memory.

// Asynchronous 4-byte copies into shared memory, in groups a thread commits
// and waits for in order (cp_wait<N>: all but the newest N are done).
__device__ __forceinline__ void cp_async4(uint32_t* smem,
                                          const uint32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The tile walk's iteration (gact_walk_kernel) on a tile's whole column in
// a ring slot.  The resident walk's (resident_step, below) is the same
// iteration with the resident clamps over a window of a column; the two
// share no code because a step shared by both made gact_walk_kernel slower
// (PERF.md).

// The lane's next cell and its two entries (e1 | e2 << 16).
struct Step {
  int i;
  int j;
  uint32_t pair;
};

// One iteration of the column walk at (i, j) in the tile of rows (lo, lo +
// T], `last` when it is the pass's row-0 tile.  col[0, G) are column d's direction words of the tile, group g at
// col[g], and col[G, G + nbm) its bitmap words; the caller has made them
// visible to every thread that calls.  A lane that is not in the tile (i <=
// lo, j > 0 in the last tile) reads nothing: it owes the all-D row.
__device__ __forceinline__ Step column_step(const uint32_t* col, int G,
                                            int nbm, int T, int lo,
                                            bool last, int i, int j) {
  const bool in_tile = i > lo;
  bool any_nm = false;
  int gstar = 0;
  uint32_t wsel = 0;
  if (in_tile) {
    const int ii = clampi(i - 1 - lo, 0, T - 1);   // row in the tile
    const int g_cur = ii >> 4;
    const int sh = 2 * (15 - (ii & 15));
    const uint32_t wm_cur = (col[g_cur] << sh) >> sh;   // pairs above i off
    if (wm_cur != 0) {
      any_nm = true;
      gstar = g_cur;
      wsel = wm_cur;
    } else {
      // the highest group below g_cur with a non-M pair: group_below's scan
      // from g_cur's own bitmap word down
      int w = min(nbm - 1, g_cur >> 5);
      uint32_t bwk = col[G + w] & below_mask(g_cur, w);
      while (bwk == 0 && w > 0) {
        --w;
        bwk = col[G + w] & below_mask(g_cur, w);
      }
      if (bwk) {
        any_nm = true;
        gstar = (w << 5) + 31 - __clz(static_cast<int>(bwk));
        wsel = col[gstar];
      }
    }
  }
  int pstar = 15 - (__clz(static_cast<int>(wsel)) >> 1);
  pstar = pstar > 0 ? pstar : 0;
  // M-run floor: the indel row, else the tile entry (row 0 in the last
  // tile: the walk then owes only the synthetic all-D row)
  const int floor_row = any_nm ? lo + gstar * 16 + pstar + 1
                               : (last ? 0 : lo);
  const int mrun = in_tile ? i - floor_row : 0;
  const int i2 = i - mrun;
  const int j2 = j - mrun;
  const int op = static_cast<int>((wsel >> (2 * pstar)) & 3u);
  const bool take_e = any_nm && !(i2 == 0 && j2 == 0);
  const int drun = (!any_nm && i2 == 0) ? (j2 > 0 ? j2 : 0) : 0;
  const uint32_t e1 =
      mrun > 0 ? static_cast<uint16_t>(entry<int16_t>(mrun, 0)) : kPad;
  const uint32_t e2 =
      take_e     ? static_cast<uint16_t>(entry<int16_t>(1, op))
      : drun > 0 ? static_cast<uint16_t>(entry<int16_t>(drun, 2))
                 : kPad;
  return {(take_e && op == 1) ? i2 - 1 : i2,
          drun > 0 ? 0 : ((take_e && op == 2) ? j2 - 1 : j2),
          e1 | (e2 << 16)};
}

// Issue column x of a tile (words v[g][b][x], bitmap words nm[w][b][x];
// `at` = b * band) into its ring slot: thread `lane` copies words lane,
// lane + 32, ...
__device__ __forceinline__ void load_column(uint32_t* ring, int CW,
                                            const uint32_t* __restrict__ v,
                                            const uint32_t* __restrict__ nm,
                                            int G, long long plane,
                                            long long at, int x, int lane) {
  uint32_t* slot = ring + (x & (kRing - 1)) * CW;
  for (int g = lane; g < CW; g += 32) {
    cp_async4(slot + g, g < G ? v + g * plane + at + x
                              : nm + (g - G) * plane + at + x);
  }
}


// ---------------------------------------------------------------------------
// The resident walk's iteration (walk_c_kernel).

// The lane's next cell and its two entries, (count << 2) | op or kPad in
// 32 bits: the caller keeps the low bits of its entry type, as the plain
// walk's int64 -> int16/int32 cast keeps them.
struct WalkStep {
  int i;
  int j;
  uint32_t e1;
  uint32_t e2;
};

// A resident pass's column d: its ring slot holds a window of groups from
// lo up to the lane's group when it was loaded (the walk only descends, so
// it reads no group above the window), and the bitmap words up to that
// group's at bm.  A group below the window comes from device memory (v +
// g * plane + at), and a group >= G, which only a lane past row L reads,
// is the tensor's last word (the plain walk clamps the flat index), `tail`.
struct WindowColumn {
  const uint32_t* win;
  const uint32_t* bm;
  int lo;
  int G;
  uint32_t tail;
  const uint32_t* v;
  long long plane;
  long long at;
  __device__ __forceinline__ uint32_t word(int g) const {
    return g >= G ? tail : (g >= lo ? win[g - lo] : __ldg(v + g * plane + at));
  }
};

// The highest group strictly below g_cur whose bit is set in the column's
// bitmap words c.bm[0 .. nbm - 1], -1 if none.  The plain walk scans
// every word from the top and keeps the first hit; words above g_cur's
// own have no bit below g_cur, so the scan starts at min(nbm - 1, g_cur >>
// 5) and stops at the first non-zero masked word, which gives the same
// group.  (A warp reading 32 words at once and taking the highest by
// ballot measured slower: the hit is nearly always in the first word.)
__device__ __forceinline__ int group_below(const WindowColumn& c, int nbm,
                                           int g_cur) {
  int w = min(nbm - 1, g_cur >> 5);
  uint32_t bwk = c.bm[w] & below_mask(g_cur, w);
  while (bwk == 0 && w > 0) {
    --w;
    bwk = c.bm[w] & below_mask(g_cur, w);
  }
  return bwk ? (w << 5) + 31 - __clz(static_cast<int>(bwk)) : -1;
}

// Issue groups g0 .. g0 + gn - 1 of column x (words v[g][b][x]; `at` = b *
// band) to slot[0, gn) and its bitmap words 0 .. wn - 1 (nm[w][b][x]) to
// slot[boff, boff + wn): thread `lane` copies items lane, lane + 32, ...
__device__ __forceinline__ void load_window(uint32_t* slot, int boff, int g0,
                                            int gn, int wn,
                                            const uint32_t* __restrict__ v,
                                            const uint32_t* __restrict__ nm,
                                            long long plane, long long at,
                                            int x, int lane) {
  for (int t = lane; t < gn + wn; t += 32) {
    const bool word = t < gn;
    cp_async4(slot + (word ? t : boff + t - gn),
              word ? v + (g0 + t) * plane + at + x
                   : nm + (t - gn) * plane + at + x);
  }
}

// One iteration of the resident walk at (i, j) (rows (0, L], row 0 the
// last) on column d's words `c`, with nbm bitmap words; the caller has made
// the slot visible to every thread that calls, and all 32 threads of the
// warp call it with the same state.  column_step's iteration with the
// plain resident walk's clamps, which differ from the tiles' where the
// words disagree with any path: the row is not clamped into the pass, so
// past row L (lens > L) the current group is >= G and may be a group the
// bitmap names (c.word gives both the tensor's last word); the M-run ends
// at row 16 gstar + pstar + 1 with pstar = -1 when the named word holds no
// non-M pair; and the indel entry is taken even at (0, 0).  A lane at row
// 0 reads nothing: it owes the all-D row.
__device__ __forceinline__ WalkStep resident_step(const WindowColumn& c,
                                                  int nbm, int i, int j) {
  const bool in_pass = i > 0;
  bool any_nm = false;
  int gstar = 0;
  uint32_t wsel = 0;
  if (in_pass) {
    const int ii = i - 1;
    const int g_cur = ii >> 4;
    const int sh = 2 * (15 - (ii & 15));
    const uint32_t wm_cur = (c.word(g_cur) << sh) >> sh;   // pairs above i
    if (wm_cur != 0) {                                     // masked off
      any_nm = true;
      gstar = g_cur;
      wsel = wm_cur;
    } else {
      // the highest group below g_cur with a non-M pair
      const int g2 = group_below(c, nbm, g_cur);
      if (g2 >= 0) {
        any_nm = true;
        gstar = g2;
        wsel = c.word(gstar);
      }
    }
  }
  // 15 - (clz >> 1): the word's lowest row with a non-M pair; -1 for 0
  const int praw = 15 - (__clz(static_cast<int>(wsel)) >> 1);
  const int pstar = praw > 0 ? praw : 0;
  // M-run floor: the indel row, else row 0 (the walk then owes only the
  // synthetic all-D row)
  const int floor_row = any_nm ? gstar * 16 + praw + 1 : 0;
  const int mrun = in_pass ? i - floor_row : 0;
  const int i2 = i - mrun;
  const int j2 = j - mrun;
  const int op = static_cast<int>((wsel >> (2 * pstar)) & 3u);
  const int drun = (!any_nm && i2 == 0) ? (j2 > 0 ? j2 : 0) : 0;
  const uint32_t e1 = mrun > 0 ? static_cast<uint32_t>(mrun) << 2 : kPad;
  const uint32_t e2 = any_nm     ? 4u | op
                      : drun > 0 ? (static_cast<uint32_t>(drun) << 2) | 2u
                                 : kPad;
  return {(any_nm && op == 1) ? i2 - 1 : i2,
          drun > 0 ? 0 : ((any_nm && op == 2) ? j2 - 1 : j2), e1, e2};
}

// ---------------------------------------------------------------------------
// walk_c_kernel: the column walk of a resident pass, a warp a lane, `lanes`
// lanes a CTA.  A lane's runs depend on its own words alone, so each warp
// walks its lane to done or to n_iter = traceback_c_iters(L, W)
// iterations.  An iteration moves the lane's column d = clamp(j - i + W)
// by at most one (an indel moves it, an M-run does not; the row-0 D-run
// ends the walk), so the warp keeps columns d - kWalkAhead .. d +
// kWalkAhead in a ring in shared memory, each loaded by cp.async
// kWalkAhead iterations before the walk can reach it, and each iteration
// loads the one column that enters the window.  A column's words lie
// B * band words apart (a sector and often a TLB page each), so a slot
// holds a window of K groups, from the lane's group when it is loaded
// down, and the bitmap words over them: one copy a thread, one round
// trip.  A group below the window (an M-run longer than the window, or a
// walk that descended past it since the load) is read from device memory.
// A slot's window start and its load's commit group are kept in
// registers; a column that comes back into the window while its last
// load is in flight keeps that load.  The lane's entries are staged in
// shared memory and its whole row of runs (B, 2 * n_iter), pads to the
// end included, is written at the end by the warp, coalesced: the
// caller's buffer needs no fill.
template <typename E>
__global__ void __launch_bounds__(kWalkLanes * 32)
walk_c_kernel(const uint32_t* __restrict__ vdirs,
              const uint32_t* __restrict__ nm,
              const int32_t* __restrict__ lens, int G, int B, int band, int W,
              int n_iter, E* __restrict__ runs, int lanes, int K,
              int lane_words) {
  extern __shared__ __align__(16) uint32_t s_ring[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * lanes + warp;
  if (b >= B) return;
  const int nbm = (G + 31) >> 5;
  const int CW = K + nbm;                       // words a ring slot
  const long long plane = static_cast<long long>(B) * band;
  const long long at = static_cast<long long>(b) * band;
  uint32_t* ring = s_ring + warp * lane_words;
  E* stage = reinterpret_cast<E*>(ring + kWalkRing * CW);
  int i = __ldg(lens + b);
  int j = i;
  bool done = i <= 0;
  const uint32_t tail =
      !done && ((i - 1) >> 4) >= G ? __ldg(vdirs + plane * G - 1) : 0u;
  int slot_lo[kWalkRing];       // each slot's window start
  int slot_grp[kWalkRing];      // and the commit group of its last load
#pragma unroll
  for (int r = 0; r < kWalkRing; ++r) {
    slot_lo[r] = 0;
    slot_grp[r] = -1;
  }
  int committed = 0;            // commit groups issued
  int retired = 0;              // of them done at the last wait
  // column x's window: groups down from row i's (at most G - 1) and the
  // bitmap words at or below its word
  auto load = [&](int x) {
    const int r = x & (kWalkRing - 1);
    const int g_top = (i - 1) >> 4;
    const int g_hi = min(G - 1, g_top);
    const int lo = max(0, g_hi - K + 1);
    bool busy = false;
#pragma unroll
    for (int q = 0; q < kWalkRing; ++q) {
      if (q == r) {
        busy = slot_grp[q] >= retired;
        if (!busy) {
          slot_lo[q] = lo;
          slot_grp[q] = committed;
        }
      }
    }
    if (!busy) {
      load_window(ring + r * CW, K, lo, g_hi - lo + 1,
                  min(nbm, (g_top >> 5) + 1), vdirs, nm, plane, at, x, lane);
    }
  };
  int d = clampi(W, 0, band - 1);
  if (!done) {
    // the window, nearest columns first: group s holds d - s and d + s, so
    // iteration s, within s columns of d, waits for groups 0..s
    for (int s = 0; s <= kWalkAhead; ++s) {
      if (d - s >= 0) load(d - s);
      if (s > 0 && d + s < band) load(d + s);
      cp_commit();
      ++committed;
    }
  }
  int n = 0;
  while (n < n_iter && !done) {
    const bool in_tile = i > 0;
    if (in_tile) {
      cp_wait<kWalkAhead>();      // one group an iteration, kWalkAhead ahead
      __syncwarp();
      retired = committed - kWalkAhead;
    }
    const int r = d & (kWalkRing - 1);
    int lo = 0;
#pragma unroll
    for (int q = 0; q < kWalkRing; ++q) {
      if (q == r) lo = slot_lo[q];
    }
    const uint32_t* win = ring + r * CW;
    const WalkStep s = resident_step(
        WindowColumn{win, win + K, lo, G, tail, vdirs, plane, at + d}, nbm, i,
        j);
    if (lane == 0) {
      stage[2 * n] = static_cast<E>(s.e1);
      stage[2 * n + 1] = static_cast<E>(s.e2);
    }
    ++n;
    i = s.i;
    j = s.j;
    done = i == 0 && j == 0;
    if (in_tile) {
      // the column that enters the window (none while d stays)
      const int d2 = clampi(j - i + W, 0, band - 1);
      const int x = d2 > d ? d2 + kWalkAhead : d2 - kWalkAhead;
      if (d2 != d && !done && i > 0 && x >= 0 && x < band) load(x);
      cp_commit();
      ++committed;
      d = d2;
    }
  }
  cp_wait<0>();
  __syncwarp();
  E* out = runs + static_cast<long long>(b) * 2 * n_iter;
  for (int x = lane; x < 2 * n_iter; x += 32) {
    out[x] = x < 2 * n ? stage[x] : static_cast<E>(kPad);
  }
}

// ---------------------------------------------------------------------------
// gact_walk_kernel: the tiles k_hi down to k_lo of one rematerialized group
// (vg (tiles, G, B, band), nmg (tiles, ceil(G/32), B, band), tile k at k -
// k_lo), a warp a lane, the lanes over as many CTAs as they fill.
//
// The plain walk is lock-step: every block iteration writes every lane's
// pair into buffer row ptr (pads for a lane that is not alive), and a tile
// runs until no lane is alive or tile_bound = W + 4 iterations; ptr clamps
// at n_rows - 1 and nsat counts the block iterations that land there.  No
// lane's state depends on another's, so here each lane walks the group's
// tiles at its own pace: in tile k it iterates while alive, at most
// tile_bound times (its count n_k, into cnt[k][b]), and appends its pairs
// to its staging row (stage (B, n_rows) pairs; past n_rows - 1 only the
// last is kept), off[k][b] its first in tile k.  Tile k's block iterations
// are then m_k = max_b n_k, and its rows start at ptr_k = the block
// iterations before it.  The group's last CTA (an atomic ticket on st's
// last word after a __threadfence(); it sets the word back to 0) rebuilds
// the buffer: it takes each tile's maximum and the prefix from the block
// iterations carried in st (ptr + nsat), copies lane b's pair `it` of tile
// k to row ptr_k + it below the clamped row, and writes the clamped row as
// the lock-step loop left it: the pairs of the group's last block
// iteration, pads for the lanes that were not alive in it.  st (3B + 3
// int32: i, j, done a lane, then ptr, nsat and the ticket) carries the
// walk between the group's launches.
// Time: under a round trip for each of the longest lane's iterations (a
// column's load overlaps the iteration before it) and a round trip at each
// tile it enters, plus the last CTA's copy; no lane waits for another, and
// nothing bounds B.
__global__ void __launch_bounds__(kGactWarps * 32)
gact_walk_kernel(const uint32_t* __restrict__ vg,
                 const uint32_t* __restrict__ nmg, int32_t* __restrict__ st,
                 int32_t* __restrict__ cnt, int32_t* __restrict__ off,
                 uint32_t* __restrict__ stage, uint32_t* __restrict__ buf,
                 int B, int T, int W, int band, int k_lo, int k_hi,
                 int n_rows, int lanes) {
  extern __shared__ __align__(16) uint32_t s_ring[];
  __shared__ int s_last;
  __shared__ int s_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = warp < lanes ? blockIdx.x * lanes + warp : B;
  const int G = T >> 4;
  const int nbm = (G + 31) >> 5;
  const int CW = G + nbm;                       // words a ring slot
  const int tile_bound = W + 4;
  const long long plane = static_cast<long long>(B) * band;
  if (b < B) {
    uint32_t* ring = s_ring + warp * 2 * kRing * CW;
    uint32_t* srow = stage + static_cast<long long>(b) * n_rows;
    const long long at = static_cast<long long>(b) * band;
    int i = st[b];
    int j = st[B + b];
    bool done = st[2 * B + b] != 0;
    int a = 0;                                  // pairs staged this launch
    for (int k = k_hi; k >= k_lo; --k) {
      const uint32_t* v = vg + (k - k_lo) * G * plane;
      const uint32_t* nm = nmg + (k - k_lo) * nbm * plane;
      // tiles alternate rings: a tile's first wait retires every load of
      // the tile before it, so the ring loaded next is free
      uint32_t* rk = ring + (k & 1) * kRing * CW;
      const int lo = k * T;
      int d = clampi(j - i + W, 0, band - 1);
      if (!done && i > lo) {
        // the window, nearest columns first: group s holds d - s and d + s,
        // so iteration s, within s columns of d, waits for groups 0..s
        for (int s = 0; s <= kAhead; ++s) {
          if (d - s >= 0) {
            load_column(rk, CW, v, nm, G, plane, at, d - s, lane);
          }
          if (s > 0 && d + s < band) {
            load_column(rk, CW, v, nm, G, plane, at, d + s, lane);
          }
          cp_commit();
        }
      }
      const int off_k = a;
      int n = 0;
      while (n < tile_bound && !done && (i > lo || (k == 0 && j > 0))) {
        const bool in_tile = i > lo;
        if (in_tile) {
          cp_wait<kAhead>();      // one group an iteration, kAhead ahead
          __syncwarp();
        }
        const Step s = column_step(rk + (d & (kRing - 1)) * CW, G, nbm, T,
                                   lo, k == 0, i, j);
        if (lane == 0) srow[a < n_rows - 1 ? a : n_rows - 1] = s.pair;
        ++a;
        ++n;
        i = s.i;
        j = s.j;
        done = i == 0 && j == 0;
        if (in_tile) {
          // the column that enters the window (none while d stays)
          const int d2 = clampi(j - i + W, 0, band - 1);
          const int x = d2 > d ? d2 + kAhead : d2 - kAhead;
          if (d2 != d && !done && i > lo && x >= 0 && x < band) {
            load_column(rk, CW, v, nm, G, plane, at, x, lane);
          }
          cp_commit();
          d = d2;
        }
      }
      if (lane == 0) {
        cnt[k * B + b] = n;
        off[k * B + b] = off_k;
      }
    }
    cp_wait<0>();
    if (lane == 0) {
      st[b] = i;
      st[B + b] = j;
      st[2 * B + b] = done;
    }
  }
  // the group's last CTA rebuilds the rows of the shared write pointer
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(st + 3 * B + 2, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int nt = k_hi - k_lo + 1;
  int* s_m = reinterpret_cast<int*>(s_ring);   // tile k at k_hi - k
  int* s_base = s_m + nt;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) s_m[t] = 0;
  __syncthreads();
#pragma unroll 4
  for (int x = threadIdx.x; x < nt * B; x += blockDim.x) {
    const int n = __ldcg(cnt + k_lo * B + x);
    if (n > 0) atomicMax(s_m + (k_hi - k_lo - x / B), n);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // block iterations before the group: ptr + nsat (nsat counts those at
    // or past the clamped row)
    int g = __ldcg(st + 3 * B) + __ldcg(st + 3 * B + 1);
    for (int t = 0; t < nt; ++t) {
      s_base[t] = g;
      g += s_m[t];
    }
    s_total = g;
  }
  __syncthreads();
  // each thread copies kCopyItems (tile, lane) runs at once, so their
  // loads are in flight together
  const int clamp_row = n_rows - 1;
  for (int x0 = threadIdx.x; x0 < nt * B; x0 += kCopyItems * blockDim.x) {
    const uint32_t* src[kCopyItems];
    uint32_t* dst[kCopyItems];
    int m[kCopyItems];
    int mmax = 0;
#pragma unroll
    for (int u = 0; u < kCopyItems; ++u) {
      const int x = x0 + u * blockDim.x;
      m[u] = 0;
      if (x >= nt * B) continue;
      const int k = k_lo + x / B;
      const int bb = x - (k - k_lo) * B;
      const int r0 = s_base[k_hi - k];
      src[u] = stage + static_cast<long long>(bb) * n_rows
               + __ldcg(off + k * B + bb);
      dst[u] = buf + static_cast<long long>(bb) * n_rows + r0;
      m[u] = min(__ldcg(cnt + k * B + bb), clamp_row - r0);
      mmax = max(mmax, m[u]);
    }
    for (int it = 0; it < mmax; ++it) {
      uint32_t v[kCopyItems];
#pragma unroll
      for (int u = 0; u < kCopyItems; ++u) {
        if (it < m[u]) v[u] = __ldcg(src[u] + it);
      }
#pragma unroll
      for (int u = 0; u < kCopyItems; ++u) {
        if (it < m[u]) dst[u][it] = v[u];
      }
    }
  }
  const int g0 = s_base[0];
  const int g1 = s_total;
  if (g1 > clamp_row && g1 > g0) {
    // the clamped row holds the group's last block iteration: tile t's
    // iteration s_m[t] - 1, t the last tile with any
    int t = nt - 1;
    while (s_m[t] == 0) --t;
    const int k = k_hi - t;
    for (int bb = threadIdx.x; bb < B; bb += blockDim.x) {
      const int n = __ldcg(cnt + k * B + bb);
      const int o = __ldcg(off + k * B + bb) + n - 1;
      buf[static_cast<long long>(bb) * n_rows + clamp_row] =
          n == s_m[t] ? __ldcg(stage + static_cast<long long>(bb) * n_rows
                               + min(o, clamp_row))
                      : kPadPair;
    }
  }
  if (threadIdx.x == 0) {
    st[3 * B] = min(g1, clamp_row);
    st[3 * B + 1] = max(0, g1 - clamp_row);
    st[3 * B + 2] = 0;
  }
}

// Lanes a CTA for a tile of G groups: kGactLanes, fewer where their rings
// pass the card's shared memory; 0 where one lane's does.
// Lanes a CTA for a tile of G groups: kGactLanes, fewer where their rings
// pass the card's shared memory; 0 where one lane's does.
int gact_lanes(int G) {
  const long long lane_bytes =
      2LL * kRing * (G + (G + 31) / 32) * static_cast<long long>(sizeof(int));
  const long long w = kSmemMax / lane_bytes;
  return static_cast<int>(w < kGactLanes ? w : kGactLanes);
}

template <typename E>
int launch_walk_c(const uint32_t* v, const uint32_t* m, const int32_t* l,
                  int G, int B, int band, int W, int n_iter, void* runs,
                  cudaStream_t s) {
  // a slot's window: kWalkGroups groups, more to fill the warp's last
  // round of copies with the bitmap words, at most G
  const int nbm = (G + 31) / 32;
  const int K = min(G, max(kWalkGroups,
                           (nbm + kWalkGroups + 31) / 32 * 32 - nbm));
  // a lane's words: its ring, then its staged entries
  const long long lane_words =
      static_cast<long long>(kWalkRing) * (K + nbm)
      + (2LL * n_iter * static_cast<long long>(sizeof(E)) + 3) / 4;
  const long long fit = kSmemMax / (lane_words * 4);
  const int lanes = static_cast<int>(fit < kWalkLanes ? fit : kWalkLanes);
  if (lanes <= 0) return -1;
  const size_t smem = static_cast<size_t>(lanes * lane_words) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        walk_c_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  walk_c_kernel<E><<<(B + lanes - 1) / lanes, lanes * 32, smem, s>>>(
      v, m, l, G, B, band, W, n_iter, static_cast<E*>(runs), lanes, K,
      static_cast<int>(lane_words));
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Each returns 0 on success, a cudaError_t code
// when the launch is refused, or -1 for arguments the kernel does not take.

// The column walk of a resident pass: vdirs (G, B, band) and nm
// (ceil(G/32), B, band) int32, lens (B,) int32, runs (B, 2*n_iter) of
// entry_bytes = 2 (int16) or 4 (int32), every element written by the
// kernel (no fill needed).  -1 also where one lane's ring and entries pass
// the card's shared memory.
extern "C" int lrm_walk_c(const void* vdirs, const void* nm, const void* lens,
                          int G, int B, int band, int W, int n_iter,
                          void* runs, int entry_bytes, void* stream) {
  if (G <= 0 || B <= 0 || band <= 0 || W < 0 || n_iter < 0) return -1;
  if (static_cast<long long>(B) * band > 0x7FFFFFFFLL) return -1;
  auto v = static_cast<const uint32_t*>(vdirs);
  auto m = static_cast<const uint32_t*>(nm);
  auto l = static_cast<const int32_t*>(lens);
  auto s = static_cast<cudaStream_t>(stream);
  if (entry_bytes == 2) {
    return launch_walk_c<int16_t>(v, m, l, G, B, band, W, n_iter, runs, s);
  }
  if (entry_bytes == 4) {
    return launch_walk_c<int32_t>(v, m, l, G, B, band, W, n_iter, runs, s);
  }
  return -1;
}

// The gact walk over one group: tiles k_lo .. k_hi of T rows, vg (k_hi -
// k_lo + 1, T/16, B, band) and nmg (k_hi - k_lo + 1, ceil(T/16/32), B, band)
// int32, st (3B + 3) int32 carried between the groups' launches (its last
// word 0 before the first), cnt and off (k_hi + 1, B) int32 (cnt[k][b]:
// lane b's iterations in tile k), stage and buf (B, n_rows) pairs of int16
// entries, buf filled with pads by the caller before the first group.
extern "C" int lrm_gact_walk(const void* vg, const void* nmg, void* st,
                             void* cnt, void* off, void* stage, void* buf,
                             int B, int T, int W, int band, int k_lo,
                             int k_hi, int n_rows, void* stream) {
  if (B <= 0 || T <= 0 || T % 16 != 0 || W < 0 || band <= 0 || k_lo < 0
      || k_hi < k_lo || n_rows <= 0) {
    return -1;
  }
  if (static_cast<long long>(B) * band > 0x7FFFFFFFLL
      || static_cast<long long>(k_hi + 1) * B > 0x7FFFFFFFLL) {
    return -1;
  }
  const int G = T / 16;
  const int lanes = gact_lanes(G);
  if (lanes <= 0) return -1;
  const size_t ring = static_cast<size_t>(lanes) * 2 * kRing
                      * (G + (G + 31) / 32) * sizeof(uint32_t);
  const size_t tiles = static_cast<size_t>(2) * (k_hi - k_lo + 1)
                       * sizeof(int);
  const size_t smem = ring > tiles ? ring : tiles;
  if (smem > static_cast<size_t>(kSmemMax)) return -1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gact_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int grid = (B + lanes - 1) / lanes;
  gact_walk_kernel<<<grid, kGactWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vg), static_cast<const uint32_t*>(nmg),
      static_cast<int32_t*>(st), static_cast<int32_t*>(cnt),
      static_cast<int32_t*>(off), static_cast<uint32_t*>(stage),
      static_cast<uint32_t*>(buf), B, T, W, band, k_lo, k_hi, n_rows, lanes);
  return cudaGetLastError();
}
