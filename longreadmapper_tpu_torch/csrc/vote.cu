// The seed vote for Hopper (sm_90a): seed_tables_kernel, the per-seed
// tables and lchash gather; the vote-rows kernels, each (read, phase) row's
// whole vote (the wide-seed pick, slot owners, the sa_ctx gather and
// verify, the top-2 diagonal buckets) and, in the same launch, each read's
// accept over its P rows; the top-2 kernels, the vote's sort and count on
// keys given by the caller.
//
// Replaces XLA gathers and sorts of the JAX package (none is a pallas_call):
//   seed_tables_kernel  longreadmapper_tpu/mapping/pipeline.py:362
//                       _position_tables, the lchash gather of _seed_vote
//                       (:581) and the LF narrowing of _narrow_wide_seeds
//   vote_warp_kernel,   the scatter of _narrow_wide_seeds' lanes (the pick
//   vote_cta_kernel     of ops/seed_vote.pick_wide_seeds here),
//                       _slots_by_owner (the owns reduce of :651), the
//                       sa_ctx gather and verify (:690-761),
//                       longreadmapper_tpu/ops/vote.py:56 top2_votes and the
//                       accept (pipeline.py:768-796, with ops/vote.py:143
//                       top2_small_histo)
//   top2_warp_kernel,   longreadmapper_tpu/ops/vote.py:56 top2_votes
//   top2_cta_kernel
// Contract: the plain PyTorch versions seed_tables_plain and
// vote_accept_plain (pick_wide_seeds, vote_rows_plain, seed_accept_plain;
// ops/seed_vote.py) and top2_votes_plain (ops/vote.py), bit for bit: every
// quantity is an integer, and every int32 sum wraps as the plain version's
// does.
//
// seed_tables_kernel: per seed (read b, phase p, seed s; the flat index e
// = (b*P + p)*S + s, start j = p + step*s) the verify pattern qw (the first
// `left` codes, 2 bits each, the first lowest), the lchash key (the last
// hlen codes, the first highest) and ok (no code >= 4); the lch row (k,
// l) (and the high bytes under pos64); then present, cnt12 = min(l - k +
// 1, thres) and wide = cnt12 >= thres.  A wide seed is LF-narrowed here,
// `left` backward-search steps over the replicated FM tables, to its
// seed_len-mer interval (kw, cw = its informative count): JAX narrows only
// the first wide_lanes wide seeds of the chunk, and each seed's narrowing
// depends on that seed alone, so the vote keeps these values for the
// seeds that JAX picks and drops the rest as JAX does.  A CTA takes a
// contiguous run of a read's seeds, loads their codes once into shared
// memory, packed 2 bits a code, and reads each seed's qw and key from the
// packed words; the wide seeds are queued and narrowed after its main
// pass (at the kernel below).
//
// The vote of a row r = b*P + p of C slots, padded to Cpad (a power of 2):
//   1. Each seed's pick: a wide seed is kept when its flat rank among the
//      chunk's wide seeds (the caller's cumsum) is within the lanes; a kept
//      one counts cw at kw, a dropped one nothing (and flags the row), any
//      other cnt12 at k12.  Its count, k_seed - start, qw and wide flag are
//      staged in shared memory; cum = the inclusive scan of the counts
//      (uint32, so it wraps as the plain int32 cumsum).
//   2. Slot c's owner = the first seed with cum > c (searchsorted right):
//      zero-count seeds own nothing; a slot past the total is empty.  An
//      occupied slot gathers the sa_ctx row at p_rank = k_seed - start + c,
//      clamped to [0, n-1]: (SA, context word), the SA value alone in the
//      slim layout (then the verify window comes from one text_pair row, as
//      _ctx_window), and the high byte under pos64.  Each thread issues the
//      gathers of all its slots (8 at most at a time) before it uses any.
//      A wide seed's slot skips the verify and takes a key offset of 0.
//   3. The slot's vote is one pair: int32 keys pack (bucket (key >> 4) +
//      128, biased to unsigned order, << 32 | slot << 4 | key & 15) into one
//      64-bit word; int64 keys (pos64) sort (bucket, slot << 4 | key & 15)
//      by a two-word compare.  An empty or unverified slot takes the
//      sentinel bucket, which sorts last.  The slot makes every pair
//      distinct, so a bitonic sort gives the plain version's stable order.
//      Every slot past the row's total is empty, so the vote sorts only the
//      fewest slots (a power of 2) that hold min(total, C): at 1 kb most
//      rows sort 32 or 64 pairs of their 128.
//   4. A segmented scan over the sorted pairs gives each run's count, its
//      minimum key & 15 and its head's slot at the run's end; top-1 =
//      (count desc, first slot asc), top-2 = the largest count of another
//      run.  The row's v1, key1, v2, total and wide-drop flag are written.
//   5. The read's accept (one warp, once its P rows are written): phase p
//      accepts when num_seeds > 0 and (v1 + v2) * dacc > nacc * num_seeds
//      (int32, wrapping); the first accepted phase; the outer histogram of
//      the earlier phases' nonzero key1 (O(P^2) compares, top-1 by count
//      desc, first phase asc, its bucket's minimum key); the overwrite when
//      no phase or the last one accepted; overflow over the executed phases
//      (total > C or a dropped wide seed).  Writes best and overflow.
// Two shapes of launch:
//   - Cpad <= kWarpMaxPad (1 kb reads: C 80 and 256): vote_warp_kernel, a
//     CTA a read, a warp a row (the warps loop over the read's P rows).  A
//     lane holds at most Cpad / 32 pairs in registers; the count scan is a
//     warp scan by __shfl_up_sync, the sort a bitonic network of register
//     swaps and __shfl_xor_sync, the top-2 a segmented warp scan and two
//     __reduce_max_sync.  No block barrier until the accept's one
//     __syncthreads.
//   - Larger rows (10 kb, 50 kb, the exact tiers): vote_cta_kernel, a CTA a
//     row, Cpad / 4 threads (1024 at most) of kCtaPairs pairs each.  The
//     pairs live in shared memory (or, past the limit, in a global scratch
//     row: use_global); every sort stage of stride < 32 * kCtaPairs runs in
//     registers and shuffles, a warp's span at a time, and only the larger
//     strides go through memory with a barrier.  The read's accept runs in
//     the CTA that writes the read's last row: an atomic ticket on the
//     read's counter after a __threadfence(); that CTA sets the counter
//     back to 0, so the caller's counters, zeroed once, stay zeroed.
//
// An index whose tables are row-sharded over ranks (parallel/dist.py) is
// gathered by the wrapper between two launches: stage 1 writes the rows to
// gather, the wrapper's collective gathers them, and stage 2 reads the
// gathered rows (pre = 1) where it would gather, votes and accepts.
//
// What bounds these kernels: bytes.  The lch and sa_ctx gathers are random
// 8-byte reads, a 32-byte sector each, a few million a chunk; the tables
// write 21 bytes a seed; the codes are read once.  A 1 kb chunk (B 2048)
// moves ~0.15 GB: ~45 us at 3.35 TB/s.  The vote's sort is C log2 C
// compare-and-selects a row, a few us of the card's integer rate.  The
// seed tables' lch gathers land in a 2.1 GB table at hlen 14: a TLB miss
// as much as a sector each (PERF.md: the same kernel takes 0.07 ms on a
// 134 MB table and 0.09 ms on the 2.1 GB one for as many seeds).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>


// The kernels' arguments, one struct a kernel, filled through ctypes
// (ops/seed_vote.py, ops/vote.py): every field is 8 bytes, so both sides
// see the same layout.  Outside the anonymous namespace: the C entries
// take them, and must keep external linkage.
struct TablesArgs {
  const int8_t* codes;      // (B, L)
  const int32_t* lens;      // (B,)
  const int32_t* lch;       // (H, 2), or (N, 2) gathered rows when pre
  const uint8_t* lch_hi;    // like lch, pos64 only
  const void* c4;           // (4,) int32 or int64
  const int32_t* packed;    // (npw,) BWT words
  const void* occ;          // (nocc, 4) int32 or int64
  int32_t* qw;              // outputs, (N,) each
  void* k12;                // int32, int64 under pos64
  int32_t* cnt12;
  uint8_t* wide;
  void* kw;                 // like k12
  int32_t* cw;
  int64_t* rows;            // stage kStageRows: the lch row of each seed
  long long H, npw, nocc, dollar_pos;
  long long B, L, P, S, step, seed_len, hlen, left, thres;
  long long pos64, c4_64, occ_64, pre, stage;
};


struct RowsArgs {
  const int32_t* cnt12;     // per seed, (BP, S) each
  const void* k12;          // int32, int64 under pos64
  const void* kw;           // like k12
  const int32_t* cw;
  const int32_t* rank;      // the flat inclusive count of wide seeds
  const int32_t* qw;
  const uint8_t* wide;
  const int32_t* lens;      // (B,)
  const int32_t* sa_ctx;    // (n, 2) full, (n,) slim; (BP*C, ...) when pre
  const uint8_t* sa_hi;     // (n,), pos64 only; (BP*C,) when pre
  const int32_t* text_pair; // (m_pair, 2), slim only; (BP*C, 2) when pre
  int64_t* rows;            // stage kStageRows: p_safe (BP, C)
  int32_t* v1;              // per row, (BP,) each
  void* key1;               // int32, int64 under pos64
  int32_t* v2;
  int32_t* total;
  uint8_t* row_ovf;         // a wide seed of the row was dropped
  void* best;               // per read, (B,): like key1
  uint8_t* overflow;
  int32_t* tickets;         // (B,) at least, 0 between launches
  unsigned char* scratch;   // use_global: BP rows of row_bytes
  long long B, P, S, step, C, Cpad, n, m_pair, left, lanes, nacc, dacc;
  long long pos64, slim, pre, stage, use_global, row_bytes;
};

struct Top2Args {
  const void* keys;         // (B, V) int32, or int64 when k64
  const uint8_t* valid;     // (B, V)
  int32_t* v1;
  void* key1;
  int32_t* v2;
  unsigned char* scratch;
  long long B, V, Vpad, k64, use_global, row_bytes;
};

namespace {

constexpr unsigned kM01 = 0x55555555u;
constexpr int kStageAll = 0;    // the whole kernel, gathers included
constexpr int kStageRows = 1;   // only the rows to gather (a sharded index)
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpMaxPad = 512;   // rows of at most this many pairs: a warp
constexpr int kWarpRows = 8;       // warps of a warp-path CTA, at most
constexpr int kCtaPairs = 4;       // pairs a thread of the CTA kernels
constexpr int kCtaMaxThreads = 1024;
constexpr int kGatherBatch = 8;    // slots whose gathers a lane has in flight

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------------------
// FM rank, as ops/rank.occ: occ(c, loc) = #c in bwt[0..loc], '$' packed as
// code 0 and taken back out.
__device__ long long occ_at(const TablesArgs& a, int c, long long loc) {
  const int wid = static_cast<int>(loc >> 4);    // .to(int32)
  const int off = static_cast<int>(loc & 15);
  const uint32_t word = static_cast<uint32_t>(
      a.packed[clampll(wid, 0, a.npw - 1)]);
  const uint32_t pat = word ^ (static_cast<uint32_t>(c) * kM01);
  const uint32_t hit = ~pat & ~(pat >> 1) & kM01;
  const uint32_t keep = kM01 >> (2 * (15 - off));
  int cnt = __popc(hit & keep);
  cnt -= (c == 0 && wid == static_cast<int>(a.dollar_pos >> 4)
          && (a.dollar_pos & 15) <= off);
  const long long row = clampll(wid, 0, a.nocc - 1) * 4 + c;
  const long long samp =
      a.occ_64 ? static_cast<const long long*>(a.occ)[row]
               : static_cast<const int32_t*>(a.occ)[row];
  return samp + cnt;
}

__device__ __forceinline__ long long c4_at(const TablesArgs& a, int c) {
  return a.c4_64 ? static_cast<const long long*>(a.c4)[c]
                 : static_cast<const int32_t*>(a.c4)[c];
}

extern __shared__ __align__(16) unsigned char lrm_smem[];

// ---------------------------------------------------------------------------
// seed_tables_kernel: grid (B, chunks of a read).  A CTA takes the seeds (p,
// s), p in [p0, p0 + np), s in [s0, s0 + ns) of read b: whole phase rows (ns
// = S) where a read's rows are short, else a slice of one row (np = 1);
// either way a contiguous run of the flat index e = (b*P + p)*S + s, so its
// writes coalesce.  (A CTA of a few seeds of every row loads 21 times fewer
// codes at 10 and 50 kb, but writes short runs of e, and measured 7-18%
// slower there: PERF.md.)  It loads the codes of its seeds' window [jlo,
// jhi) from global memory once, 16 bytes a thread, and packs them in shared
// memory: 2 bits a code (c & 3) in a word of 16, a bit of 16 for each code
// that is not 0-3 (`inv`: N, and every position past L, which the plain
// version pads with 4), and one for each code that is not 0-4 (`exo`).  A
// seed's 32 codes are then three words and a funnel shift; its qw and lchash
// key are the fields of it, a 4 adding the bit above its field as the plain
// OR of (c << 2t) does; a seed with an `exo` code reads its bytes as before.
// Each thread takes kSeedsPerThread seeds and issues their lch gathers back
// to back.  A wide seed is queued (warp ballot, shared memory) and
// LF-narrowed after the CTA's main pass, a queued seed a thread, so the
// narrowing's dependent loads do not hold up the warps of the other seeds.
struct SeedPart {
  int np;      // phase rows a CTA
  int ns;      // seeds of a row a CTA
  int cpr;     // CTAs a phase row (ns < S), else 1
  int units;   // 16-code units of the largest window, margin included
};

constexpr int kSeedThreads = 512;
constexpr int kSeedsPerThread = 2;
constexpr int kSeedsPerCta = kSeedThreads * kSeedsPerThread;

__device__ __forceinline__ uint32_t mask32(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

// bit t of x (t < 16) to bit 2t
__device__ __forceinline__ uint32_t spread2(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// 32 codes from position x of the packed window, the first lowest
__device__ __forceinline__ unsigned long long codes_at(const uint32_t* cw,
                                                       int x) {
  const int u = x >> 4;
  const int sh = 2 * (x & 15);
  const unsigned long long lo =
      cw[u] | (static_cast<unsigned long long>(cw[u + 1]) << 32);
  return sh ? (lo >> sh) | (static_cast<unsigned long long>(cw[u + 2])
                            << (64 - sh))
            : lo;
}

// 32 flags from position x of a window bitmap, the first lowest
__device__ __forceinline__ uint32_t flags_at(const uint16_t* m, int x) {
  const int u = x >> 4;
  const unsigned long long w =
      m[u] | (static_cast<unsigned long long>(m[u + 1]) << 16)
      | (static_cast<unsigned long long>(m[u + 2]) << 32);
  return static_cast<uint32_t>(w >> (x & 15));
}

__global__ void __launch_bounds__(kSeedThreads)
seed_tables_kernel(TablesArgs a, SeedPart q) {
  // the wide queue (k12, l12, qw, the seed's index in the CTA), then the
  // packed window
  long long* q_k = reinterpret_cast<long long*>(lrm_smem);
  long long* q_l = q_k + kSeedsPerCta;
  uint32_t* q_qw = reinterpret_cast<uint32_t*>(q_l + kSeedsPerCta);
  int* q_at = reinterpret_cast<int*>(q_qw + kSeedsPerCta);
  uint32_t* cw = reinterpret_cast<uint32_t*>(q_at + kSeedsPerCta);
  uint16_t* inv = reinterpret_cast<uint16_t*>(cw + q.units);
  uint16_t* exo = inv + q.units;
  __shared__ int s_nq;
  const int b = blockIdx.x;
  const int c = blockIdx.y;
  const int P = static_cast<int>(a.P);
  const int S = static_cast<int>(a.S);
  const int step = static_cast<int>(a.step);
  const int sl = static_cast<int>(a.seed_len);
  const int left = static_cast<int>(a.left);
  const int hlen = static_cast<int>(a.hlen);
  const int L = static_cast<int>(a.L);
  const int p0 = c / q.cpr * q.np;
  const int s0 = c % q.cpr * q.ns;
  const int np = min(q.np, P - p0);
  const int ns = min(q.ns, S - s0);
  const int n = np * ns;
  const long long e0 = (static_cast<long long>(b) * P + p0) * S + s0;
  // the window: from the first seed's start to the last one's end
  const int wlo = (p0 + step * s0) & ~15;
  const int units =
      (p0 + np - 1 + step * (s0 + ns - 1) + sl - wlo + 15) / 16 + 2;
  const int8_t* row = a.codes + static_cast<long long>(b) * L;
  if (threadIdx.x == 0) s_nq = 0;
#pragma unroll 4
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int x0 = wlo + 16 * u;
    uint32_t by[4];                     // the unit's 16 bytes
    if (x0 + 16 <= L && (reinterpret_cast<uintptr_t>(row + x0) & 15) == 0) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(row + x0));
      by[0] = v.x;
      by[1] = v.y;
      by[2] = v.z;
      by[3] = v.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        by[t] = 0;
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          const int x = x0 + 4 * t + z;
          by[t] |= static_cast<uint32_t>(static_cast<uint8_t>(
                       x < L ? row[x] : 4)) << (8 * z);
        }
      }
    }
    uint32_t w = 0;
    uint32_t iv = 0;
    uint32_t ex = 0;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int cc = static_cast<int8_t>(by[t >> 2] >> (8 * (t & 3)));
      w |= static_cast<uint32_t>(cc & 3) << (2 * t);
      iv |= static_cast<uint32_t>(cc < 0 || cc > 3) << t;
      ex |= static_cast<uint32_t>(cc < 0 || cc > 4) << t;
    }
    cw[u] = w;
    inv[u] = static_cast<uint16_t>(iv);
    exo[u] = static_cast<uint16_t>(ex);
  }
  __syncthreads();
  const int lens_b = a.lens[b];
  int at[kSeedsPerThread];
  int jj[kSeedsPerThread];
  uint32_t qws[kSeedsPerThread];
  int32_t nums[kSeedsPerThread];
  bool oks[kSeedsPerThread];
#pragma unroll
  for (int k = 0; k < kSeedsPerThread; ++k) {
    const int l = threadIdx.x + k * kSeedThreads;
    at[k] = l;
    const int p = p0 + l / ns;
    const int j = p + step * (s0 + l % ns);
    jj[k] = j;
    if (l >= n) continue;
    const int x = j - wlo;
    const uint32_t iv = flags_at(inv, x) & mask32(sl);
    uint32_t qw;
    uint32_t num;
    bool ok = iv == 0;
    if ((flags_at(exo, x) & mask32(sl)) == 0) {
      const unsigned long long bits = codes_at(cw, x);
      qw = static_cast<uint32_t>(bits) & mask32(2 * left);
      // the key's codes, the first highest: reverse the 2-bit fields
      uint32_t r = __brev(static_cast<uint32_t>(bits >> (2 * left))
                          & mask32(2 * hlen));
      r = ((r >> 1) & kM01) | ((r & kM01) << 1);
      num = r >> (32 - 2 * hlen);
      if (iv) {
        // a 4 sets the bit above its field (dropped past bit 31)
        qw |= spread2(iv & mask32(left)) << 2;
        num |= spread2(__brev(iv >> left) >> (32 - hlen)) << 2;
      }
    } else {
      // a code outside 0-4: the bytes themselves, as the plain version
      // (which takes a negative code as valid)
      qw = 0;
      num = 0;
      ok = true;
      for (int t = 0; t < sl; ++t) {
        const int cc = j + t < L ? static_cast<int>(row[j + t]) : 4;
        ok = ok && cc < 4;
        if (t < left) {
          qw |= static_cast<uint32_t>(cc) << (2 * t);
        } else {
          num |= static_cast<uint32_t>(cc) << (2 * (hlen - 1 - (t - left)));
        }
      }
    }
    qws[k] = qw;
    nums[k] = static_cast<int32_t>(num);
    oks[k] = ok;
  }
  if (a.stage == kStageRows) {
#pragma unroll
    for (int k = 0; k < kSeedsPerThread; ++k) {
      if (at[k] < n) a.rows[e0 + at[k]] = clampll(nums[k], 0, a.H - 1);
    }
    return;
  }
  // the lch gathers, all in flight before any is used
  int2 kl[kSeedsPerThread];
  uchar2 hi[kSeedsPerThread];
#pragma unroll
  for (int k = 0; k < kSeedsPerThread; ++k) {
    if (at[k] >= n) continue;
    const long long g = a.pre ? e0 + at[k] : clampll(nums[k], 0, a.H - 1);
    kl[k] = __ldg(reinterpret_cast<const int2*>(a.lch) + g);
    if (a.pos64) hi[k] = __ldg(reinterpret_cast<const uchar2*>(a.lch_hi) + g);
  }
#pragma unroll
  for (int k = 0; k < kSeedsPerThread; ++k) {
    const bool in = at[k] < n;
    const long long e = e0 + at[k];
    long long k12 = 0;
    long long l12 = 0;
    bool wide = false;
    if (in) {
      const int32_t klo = kl[k].x;
      const int32_t llo = kl[k].y;
      k12 = klo;
      l12 = llo;
      if (a.pos64) {
        k12 = (static_cast<long long>(hi[k].x) << 32)
              | static_cast<uint32_t>(klo);
        l12 = (static_cast<long long>(hi[k].y) << 32)
              | static_cast<uint32_t>(llo);
      }
      const bool seed_ok = jj[k] < lens_b - sl;
      const bool present = oks[k] && seed_ok && !(k12 == 0 && l12 == 0);
      int cnt = 0;
      if (present) {
        if (a.pos64) {
          const long long d = l12 - k12 + 1;
          cnt = static_cast<int32_t>(d < a.thres ? d : a.thres);
        } else {
          const int32_t d = static_cast<int32_t>(
              static_cast<uint32_t>(llo) - static_cast<uint32_t>(klo) + 1u);
          cnt = d < a.thres ? d : static_cast<int32_t>(a.thres);
        }
      }
      wide = present && cnt >= a.thres;
      a.qw[e] = static_cast<int32_t>(qws[k]);
      a.cnt12[e] = cnt;
      a.wide[e] = wide;
      if (a.pos64) {
        static_cast<long long*>(a.k12)[e] = k12;
      } else {
        static_cast<int32_t*>(a.k12)[e] = static_cast<int32_t>(k12);
      }
      if (!wide) {
        a.cw[e] = 0;
        if (a.pos64) {
          static_cast<long long*>(a.kw)[e] = k12;
        } else {
          static_cast<int32_t*>(a.kw)[e] = static_cast<int32_t>(k12);
        }
      }
    }
    // queue the warp's wide seeds
    const unsigned m = __ballot_sync(kFull, wide);
    if (m) {
      const int lane = threadIdx.x & 31;
      int base = 0;
      if (lane == 0) base = atomicAdd(&s_nq, __popc(m));
      base = __shfl_sync(kFull, base, 0);
      if (wide) {
        const int slot = base + __popc(m & ((1u << lane) - 1u));
        q_k[slot] = k12;
        q_l[slot] = l12;
        q_qw[slot] = qws[k];
        q_at[slot] = at[k];
      }
    }
  }
  __syncthreads();
  // LF-narrow each queued seed to its seed_len-mer: the left codes, last
  // first
  for (int t0 = threadIdx.x; t0 < s_nq; t0 += blockDim.x) {
    long long k = q_k[t0];
    long long l = q_l[t0];
    const uint32_t qw = q_qw[t0];
    for (int t = left - 1; t >= 0; --t) {
      if (k > l) break;                 // empty: no later step is active
      const int cc = (static_cast<int32_t>(qw) >> (2 * t)) & 3;
      const long long cb = c4_at(a, cc);
      const long long sk = k < 1 ? 1 : k;
      const long long sl2 = clampll(l, 0, a.nocc * 16 - 1);
      k = cb + occ_at(a, cc, sk - 1) + 1;
      l = cb + occ_at(a, cc, sl2);
    }
    const long long hits = k <= l ? l - k + 1 : 0;
    const long long e = e0 + q_at[t0];
    a.cw[e] = hits > 0 && hits < a.thres ? static_cast<int>(hits) : 0;
    if (a.pos64) {
      static_cast<long long*>(a.kw)[e] = k;
    } else {
      static_cast<int32_t*>(a.kw)[e] = static_cast<int32_t>(k);
    }
  }
}

// The CTA split of a launch and its shared memory: whole phase rows a CTA
// while a read's rows are short, else slices of one row.
SeedPart seed_part(const TablesArgs& a, long long* chunks, size_t* smem) {
  SeedPart q;
  if (a.S >= kSeedsPerCta) {
    q.cpr = static_cast<int>((a.S + kSeedsPerCta - 1) / kSeedsPerCta);
    q.ns = static_cast<int>((a.S + q.cpr - 1) / q.cpr);
    q.np = 1;
    *chunks = a.P * q.cpr;
  } else {
    q.cpr = 1;
    q.ns = static_cast<int>(a.S);
    q.np = static_cast<int>(kSeedsPerCta / a.S < a.P ? kSeedsPerCta / a.S
                                                      : a.P);
    *chunks = (a.P + q.np - 1) / q.np;
  }
  const long long span =
      q.np - 1 + a.step * (q.ns - 1) + a.seed_len + 15;   // wlo's 15 below
  q.units = static_cast<int>((span + 15) / 16 + 2);
  *smem = static_cast<size_t>(kSeedsPerCta) * (8 + 8 + 4 + 4)
          + static_cast<size_t>(q.units) * (4 + 2 + 2);
  return q;
}


// ---------------------------------------------------------------------------
// A vote as one sortable pair.  P32 (int32 keys): one word, the bucket
// (key >> 4) + 128 biased to unsigned order in the high half (the sentinel
// 0x7FFFFFFF, biased to all ones, sorts last) and sl = slot << 4 | key & 15
// in the low half.  P64 (int64 keys): the bucket key >> 4 (sentinel
// LLONG_MAX) and sl, compared as a pair.  key(mn) is the bucket's minimum
// key once mn is the run's minimum key & 15.

struct P32 {
  unsigned long long w;
  using KT = int32_t;
  static constexpr int kBytes = 8;
  __device__ static P32 vote(long long key, int slot) {
    const int32_t k = static_cast<int32_t>(key);
    const uint32_t b = static_cast<uint32_t>((k >> 4) + 128) ^ 0x80000000u;
    return {(static_cast<unsigned long long>(b) << 32)
            | static_cast<uint32_t>((slot << 4) | (k & 15))};
  }
  __device__ static P32 none(int slot) {
    return {(0xFFFFFFFFull << 32) | static_cast<uint32_t>(slot << 4)};
  }
  __device__ bool valid() const { return (w >> 32) != 0xFFFFFFFFull; }
  __device__ bool same(const P32& o) const {
    return (w >> 32) == (o.w >> 32);
  }
  __device__ bool lt(const P32& o) const { return w < o.w; }
  __device__ uint32_t sl() const { return static_cast<uint32_t>(w); }
  __device__ long long key(int mn) const {
    const int32_t b = static_cast<int32_t>(
        static_cast<uint32_t>(w >> 32) ^ 0x80000000u);
    return static_cast<int32_t>((b - 128) * 16 + mn);
  }
};

struct P64 {
  long long b;
  uint32_t s;
  using KT = long long;
  static constexpr int kBytes = 12;
  __device__ static P64 vote(long long key, int slot) {
    return {key >> 4, static_cast<uint32_t>((slot << 4) | (key & 15))};
  }
  __device__ static P64 none(int slot) {
    return {LLONG_MAX, static_cast<uint32_t>(slot << 4)};
  }
  __device__ bool valid() const { return b != LLONG_MAX; }
  __device__ bool same(const P64& o) const { return b == o.b; }
  __device__ bool lt(const P64& o) const {
    return b < o.b || (b == o.b && s < o.s);
  }
  __device__ uint32_t sl() const { return s; }
  __device__ long long key(int mn) const { return b * 16 + mn; }
};

__device__ __forceinline__ P32 shfl_xor(P32 p, int m) {
  return {__shfl_xor_sync(kFull, p.w, m)};
}
__device__ __forceinline__ P64 shfl_xor(P64 p, int m) {
  return {__shfl_xor_sync(kFull, p.b, m), __shfl_xor_sync(kFull, p.s, m)};
}
__device__ __forceinline__ P32 shfl_up(P32 p, int d) {
  return {__shfl_up_sync(kFull, p.w, d)};
}
__device__ __forceinline__ P64 shfl_up(P64 p, int d) {
  return {__shfl_up_sync(kFull, p.b, d), __shfl_up_sync(kFull, p.s, d)};
}
__device__ __forceinline__ P32 shfl_down(P32 p, int d) {
  return {__shfl_down_sync(kFull, p.w, d)};
}
__device__ __forceinline__ P64 shfl_down(P64 p, int d) {
  return {__shfl_down_sync(kFull, p.b, d),
          __shfl_down_sync(kFull, p.s, d)};
}

// A row's pairs in memory: shared memory, or its global scratch row.
template <class P> struct Mem;
template <> struct Mem<P32> {
  unsigned long long* w;
  __device__ Mem(unsigned char* base, int) {
    w = reinterpret_cast<unsigned long long*>(base);
  }
  __device__ P32 ld(int i) const { return {w[i]}; }
  __device__ void st(int i, const P32& p) const { w[i] = p.w; }
};
template <> struct Mem<P64> {
  long long* b;
  uint32_t* s;
  __device__ Mem(unsigned char* base, int n) {
    b = reinterpret_cast<long long*>(base);
    s = reinterpret_cast<uint32_t*>(base + 8LL * n);
  }
  __device__ P64 ld(int i) const { return {b[i], s[i]}; }
  __device__ void st(int i, const P64& p) const {
    b[i] = p.b;
    s[i] = p.s;
  }
};

// ---------------------------------------------------------------------------
// The bitonic network over N pairs, element i compared with i ^ j at stage
// `size`, ascending where i & size is 0.  A lane holds K consecutive
// elements, i0 = its first: strides below K are register swaps, strides K
// to 16K a __shfl_xor_sync with the lane j / K away.

template <int K, int J, class P>
struct RegSteps {
  __device__ static void run(P (&p)[K], int i0, int size) {
    if (J < size) {
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        if ((kk & J) == 0) {
          const bool asc = ((i0 + kk) & size) == 0;
          if (p[kk | J].lt(p[kk]) == asc) {
            const P t = p[kk];
            p[kk] = p[kk | J];
            p[kk | J] = t;
          }
        }
      }
    }
    RegSteps<K, J / 2, P>::run(p, i0, size);
  }
};
template <int K, class P>
struct RegSteps<K, 0, P> {
  __device__ static void run(P (&)[K], int, int) {}
};

template <int K, class P>
__device__ __forceinline__ void lane_step(P (&p)[K], int m, bool asc,
                                          int lane) {
  const bool keep_min = ((lane & m) == 0) == asc;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const P q = shfl_xor(p[kk], m);
    if (q.lt(p[kk]) == keep_min) p[kk] = q;
  }
}

// Every stage up to 32K of the warp's span of 32K elements from cb.
template <int K, class P>
__device__ void warp_sort(P (&p)[K], int cb, int lane) {
  const int i0 = cb + lane * K;
  for (int size = 2; size <= 32 * K; size <<= 1) {
    for (int j = size >> 1; j >= K; j >>= 1) {
      lane_step<K>(p, j / K, (i0 & size) == 0, lane);
    }
    RegSteps<K, K / 2, P>::run(p, i0, size);
  }
}

// The steps of stride < 32K of a stage size > 32K.
template <int K, class P>
__device__ void warp_merge(P (&p)[K], int cb, int lane, int size) {
  const int i0 = cb + lane * K;
  for (int j = 16 * K; j >= K; j >>= 1) {
    lane_step<K>(p, j / K, (i0 & size) == 0, lane);
  }
  RegSteps<K, K / 2, P>::run(p, i0, size);
}

// The block sorts the N pairs of m (N a power of 2, >= 32K): each warp's
// spans in registers, the strides >= 32K through memory.
template <int K, class P>
__device__ void cta_sort(const Mem<P>& m, int N) {
  const int lane = threadIdx.x & 31;
  const int span = 32 * K;
  const int first = (threadIdx.x >> 5) * span;
  const int every = (blockDim.x >> 5) * span;
  for (int cb = first; cb < N; cb += every) {
    P p[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) p[kk] = m.ld(cb + lane * K + kk);
    warp_sort<K>(p, cb, lane);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) m.st(cb + lane * K + kk, p[kk]);
  }
  __syncthreads();
  for (int size = 2 * span; size <= N; size <<= 1) {
    for (int j = size >> 1; j >= span; j >>= 1) {
      for (int q = threadIdx.x; q < (N >> 1); q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const P x = m.ld(i);
        const P y = m.ld(i + j);
        if (y.lt(x) == ((i & size) == 0)) {
          m.st(i, y);
          m.st(i + j, x);
        }
      }
      __syncthreads();
    }
    for (int cb = first; cb < N; cb += every) {
      P p[K];
#pragma unroll
      for (int kk = 0; kk < K; ++kk) p[kk] = m.ld(cb + lane * K + kk);
      warp_merge<K>(p, cb, lane, size);
#pragma unroll
      for (int kk = 0; kk < K; ++kk) m.st(cb + lane * K + kk, p[kk]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Scans.  Seg is a run's state at a sorted pair: a = count << 5 | head << 4
// | minimum key & 15 since the run's head, hs = the head's slot; seg(l, r)
// continues l by r unless r holds a head.  Counts stay below 2^27.

struct Seg {
  uint32_t a;
  uint32_t hs;
};

__device__ __forceinline__ Seg op(Seg l, Seg r) {
  if (r.a & 16u) return r;
  const uint32_t mn = min(l.a & 15u, r.a & 15u);
  return {(((l.a >> 5) + (r.a >> 5)) << 5) | (l.a & 16u) | mn, l.hs};
}
__device__ __forceinline__ uint32_t op(uint32_t l, uint32_t r) {
  return l + r;
}
__device__ __forceinline__ Seg shfl_up(Seg x, int d) {
  return {__shfl_up_sync(kFull, x.a, d), __shfl_up_sync(kFull, x.hs, d)};
}
__device__ __forceinline__ uint32_t shfl_up(uint32_t x, int d) {
  return __shfl_up_sync(kFull, x, d);
}
template <class T> __device__ __forceinline__ T ident();
template <> __device__ __forceinline__ Seg ident<Seg>() { return {15u, 0u}; }
template <> __device__ __forceinline__ uint32_t ident<uint32_t>() {
  return 0u;
}

template <class T>
__device__ __forceinline__ T warp_incl(T x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up(x, d);
    if (lane >= d) x = op(y, x);
  }
  return x;
}

template <class T>
__device__ __forceinline__ T warp_excl(T x, int lane) {
  const T e = shfl_up(warp_incl(x, lane), 1);
  return lane ? e : ident<T>();
}

// The block's exclusive scan in thread order; *tot = the block's whole.
// sh: 32 entries.  Ends with the block in step.
template <class T>
__device__ T block_excl(T x, T* sh, T* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const T inc = warp_incl(x, lane);
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nw ? sh[lane] : ident<T>();
    w = warp_incl(w, lane);
    if (lane < nw) sh[lane] = w;
  }
  __syncthreads();
  T ex = shfl_up(inc, 1);
  if (lane == 0) ex = ident<T>();
  const T before = warp ? sh[warp - 1] : ident<T>();
  *tot = sh[nw - 1];
  __syncthreads();
  return op(before, ex);
}

// The run states of a lane's K sorted pairs: s[kk] from the lane's first
// pair; `prev` is the pair before it (ignored at element 0).
template <int K, class P>
__device__ __forceinline__ void lane_runs(const P (&e)[K], const P& prev,
                                          int i0, Seg (&s)[K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const P& before = kk ? e[kk - 1] : prev;
    const bool head = i0 + kk == 0 || !before.same(e[kk]);
    const Seg x = {(1u << 5) | (head ? 16u : 0u) | (e[kk].sl() & 15u),
                   e[kk].sl() >> 4};
    s[kk] = kk ? op(s[kk - 1], x) : x;
  }
}

// ---------------------------------------------------------------------------
// The top-2 of a row's sorted pairs.

// A warp's row of 32K pairs in registers (at most 512: counts and slots
// fit 16 bits): a run end's candidate is count << 16 | 0xFFFF - first
// slot; v1 and its run from the warp's maximum, v2 the maximum of every
// lane's best other candidate.
template <int K, class P>
__device__ void warp_top2(const P (&p)[K], int lane, int* v1, long long* key1,
                          int* v2) {
  const P prev = shfl_up(p[K - 1], 1);
  const P next = shfl_down(p[0], 1);
  Seg s[K];
  lane_runs<K>(p, prev, lane * K, s);
  const Seg ex = warp_excl(s[K - 1], lane);
  uint32_t b1 = 0;
  uint32_t b2 = 0;
  long long k1 = 0;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const bool end = kk + 1 < K ? !p[kk + 1].same(p[kk])
                                : lane == 31 || !next.same(p[kk]);
    if (p[kk].valid() && end) {
      const Seg f = op(ex, s[kk]);
      const uint32_t c = ((f.a >> 5) << 16) | (0xFFFFu - f.hs);
      if (c > b1) {
        b2 = b1;
        b1 = c;
        k1 = p[kk].key(f.a & 15u);
      } else if (c > b2) {
        b2 = c;
      }
    }
  }
  const uint32_t w = __reduce_max_sync(kFull, b1);
  const uint32_t o = __reduce_max_sync(kFull, b1 == w ? b2 : b1);
  const unsigned who = __ballot_sync(kFull, w != 0 && b1 == w);
  const long long k = __shfl_sync(kFull, k1, who ? __ffs(who) - 1 : 0);
  *v1 = static_cast<int>(w >> 16);
  *v2 = static_cast<int>(o >> 16);
  *key1 = who ? k : 0;
}

// The block's top-1 candidate (count << 32 | ~first slot) with its key, and
// the best other candidate.
struct Top {
  unsigned long long b1;
  unsigned long long b2;
  long long k1;
};

__device__ __forceinline__ Top top_merge(Top x, Top y) {
  if (y.b1 > x.b1) {
    const Top t = x;
    x = y;
    y = t;
  }
  x.b2 = x.b2 > y.b1 ? x.b2 : y.b1;
  return x;
}

// A row of N sorted pairs in memory, by the block in spans of K pairs a
// thread, the run states carried from span to span.  Thread 0's result is
// the row's.
template <int K, class P>
__device__ Top cta_top2(const Mem<P>& m, int N, Seg* sh_seg, Top* sh_top) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  Seg carry = ident<Seg>();
  Top t = {0, 0, 0};
  for (int c0 = 0; c0 < N; c0 += blockDim.x * K) {
    // a thread past N (N < the block's span) holds empty pairs
    const int i0 = c0 + tid * K;
    const bool in = i0 < N;
    P e[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) e[kk] = in ? m.ld(i0 + kk) : P::none(0);
    const P prev = in && i0 ? m.ld(i0 - 1) : e[0];
    const bool last = i0 + K == N;
    const P next = in && !last ? m.ld(i0 + K) : e[K - 1];
    Seg s[K];
    lane_runs<K>(e, prev, i0, s);
    Seg tot;
    const Seg pre = op(carry, block_excl(s[K - 1], sh_seg, &tot));
    carry = op(carry, tot);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const bool end = kk + 1 < K ? !e[kk + 1].same(e[kk])
                                  : last || !next.same(e[kk]);
      if (e[kk].valid() && end) {
        const Seg f = op(pre, s[kk]);
        const unsigned long long c =
            (static_cast<unsigned long long>(f.a >> 5) << 32)
            | (0xFFFFFFFFu - f.hs);
        t = top_merge(t, {c, 0, e[kk].key(f.a & 15u)});
      }
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    const Top o = {__shfl_xor_sync(kFull, t.b1, d),
                   __shfl_xor_sync(kFull, t.b2, d),
                   __shfl_xor_sync(kFull, t.k1, d)};
    t = top_merge(t, o);
  }
  if (lane == 0) sh_top[tid >> 5] = t;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      t = top_merge(t, sh_top[w]);
    }
  }
  return t;
}

// ---------------------------------------------------------------------------
// The vote rows: a row's seeds, staged where its slots can search them.

template <class KT>
struct Seeds {
  KT* base;          // k_seed - start (int32 wrapping, or int64)
  int32_t* cum;      // the inclusive scan of the counts
  int32_t* qw;
  uint8_t* wide;
  __device__ Seeds(unsigned char* p, int S) {
    base = reinterpret_cast<KT*>(p);
    cum = reinterpret_cast<int32_t*>(p + sizeof(KT) * S);
    qw = cum + S;
    wide = reinterpret_cast<uint8_t*>(qw + S);
  }
};

// Bytes of a row's staged seeds, 16-byte aligned.
__host__ __device__ __forceinline__ long long seed_bytes(long long S,
                                                         int kt) {
  return (S * (kt + 9) + 15) / 16 * 16;
}

__device__ __forceinline__ int32_t minus_start(int32_t k, int32_t start) {
  return static_cast<int32_t>(static_cast<uint32_t>(k)
                              - static_cast<uint32_t>(start));
}
__device__ __forceinline__ long long minus_start(long long k,
                                                 int32_t start) {
  return k - start;
}
__device__ __forceinline__ long long plus_slot(int32_t b, int c) {
  return static_cast<int32_t>(static_cast<uint32_t>(b)
                              + static_cast<uint32_t>(c));
}
__device__ __forceinline__ long long plus_slot(long long b, int c) {
  return b + c;
}

// Seed e's count and k_seed as pick_wide_seeds forms them; *drop when it
// is a wide seed past the lanes.  Every table is read unconditionally, so
// the loads go out together.
template <class KT>
__device__ __forceinline__ void seed_pick(const RowsArgs& a, long long e,
                                          int32_t* cnt, KT* ks, bool* drop) {
  const bool wide = a.wide[e] != 0;
  const int32_t rank = a.rank[e];
  const int32_t c12 = a.cnt12[e];
  const int32_t cw = a.cw[e];
  const KT k12 = static_cast<const KT*>(a.k12)[e];
  const KT kw = static_cast<const KT*>(a.kw)[e];
  const bool picked = wide && rank <= a.lanes;
  *cnt = wide ? (picked ? cw : 0) : c12;
  *ks = picked ? kw : k12;
  *drop = wide && !picked;
}

// A warp stages its row's seeds, 32 at a time; returns the row's total.
template <class KT>
__device__ int32_t warp_stage(const RowsArgs& a, long long r,
                              const Seeds<KT>& sd, int lane, bool* drop) {
  const int S = static_cast<int>(a.S);
  uint32_t carry = 0;
  bool dr = false;
  __syncwarp();
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const long long e = r * a.S + s;
    int32_t cnt = 0;
    KT ks = 0;
    bool d = false;
    int32_t qw = 0;
    if (s < S) {
      seed_pick(a, e, &cnt, &ks, &d);
      qw = a.qw[e];
    }
    const uint32_t inc = warp_incl(static_cast<uint32_t>(cnt), lane) + carry;
    if (s < S) {
      sd.cum[s] = static_cast<int32_t>(inc);
      sd.base[s] = minus_start(ks, static_cast<int32_t>(
          inc - static_cast<uint32_t>(cnt)));
      sd.qw[s] = qw;
      sd.wide[s] = a.wide[e];
    }
    dr = __any_sync(kFull, d) || dr;
    carry = __shfl_sync(kFull, inc, 31);
  }
  __syncwarp();
  *drop = dr;
  return static_cast<int32_t>(carry);
}

// The block stages its row's seeds (loads in thread order, then the scan
// of contiguous chunks); returns the row's total.
template <class KT>
__device__ int32_t cta_stage(const RowsArgs& a, long long r,
                             const Seeds<KT>& sd, uint32_t* sh, bool* drop) {
  const int S = static_cast<int>(a.S);
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  int dr = 0;
  for (int s = tid; s < S; s += T) {
    const long long e = r * a.S + s;
    int32_t cnt;
    KT ks;
    bool d;
    seed_pick(a, e, &cnt, &ks, &d);
    sd.cum[s] = cnt;
    sd.base[s] = ks;
    sd.qw[s] = a.qw[e];
    sd.wide[s] = a.wide[e];
    dr |= d;
  }
  *drop = __syncthreads_or(dr) != 0;
  const int chunk = (S + T - 1) / T;
  const int lo = tid * chunk < S ? tid * chunk : S;
  const int hi = lo + chunk < S ? lo + chunk : S;
  uint32_t sum = 0;
  for (int s = lo; s < hi; ++s) sum += static_cast<uint32_t>(sd.cum[s]);
  uint32_t tot;
  uint32_t run = block_excl(sum, sh, &tot);
  for (int s = lo; s < hi; ++s) {
    const uint32_t cnt = static_cast<uint32_t>(sd.cum[s]);
    run += cnt;
    sd.cum[s] = static_cast<int32_t>(run);
    sd.base[s] = minus_start(sd.base[s], static_cast<int32_t>(run - cnt));
  }
  __syncthreads();
  return static_cast<int32_t>(tot);
}

// The first seed whose cum passes c (searchsorted right).
__device__ __forceinline__ int owner(const int32_t* cum, int S, int c) {
  int lo = 0;
  int hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The pairs of G slots c[] of row r: owners, p_safe, every gather issued
// before any is used, the verify and the key.  Stage kStageRows writes
// p_safe of each slot < C instead.
template <int G, class P>
__device__ void fill_slots(const RowsArgs& a, long long r,
                           const Seeds<typename P::KT>& sd,
                           const int (&c)[G], P (&out)[G]) {
  using KT = typename P::KT;
  const int S = static_cast<int>(a.S);
  const int C = static_cast<int>(a.C);
  int own[G];
  long long ps[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    own[g] = c[g] < C ? owner(sd.cum, S, c[g]) : S;
    const long long pr = own[g] < S ? plus_slot(sd.base[own[g]], c[g])
                                    : c[g];
    ps[g] = clampll(pr, 0, a.n - 1);
  }
  if (a.stage == kStageRows) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (c[g] < C) a.rows[r * a.C + c[g]] = ps[g];
    }
    return;
  }
  int32_t lo[G];
  uint32_t ctx[G];
  uint32_t hi[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lo[g] = 0;
    ctx[g] = 0;
    hi[g] = 0;
    if (own[g] < S) {
      const long long gi = a.pre ? r * a.C + c[g] : ps[g];
      if (a.slim) {
        lo[g] = a.sa_ctx[gi];
      } else {
        const int2 v = reinterpret_cast<const int2*>(a.sa_ctx)[gi];
        lo[g] = v.x;
        ctx[g] = static_cast<uint32_t>(v.y);
      }
      if (a.pos64) hi[g] = a.sa_hi[gi];
    }
  }
  const int shift = static_cast<int>(2 * (16 - a.left));
  if (a.slim && a.left > 0) {
    // _ctx_window: the 16 bases before sa12 from one text pair
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (own[g] < S && !sd.wide[own[g]]) {
        const long long sa12 = (static_cast<long long>(hi[g]) << 32)
                               | static_cast<uint32_t>(lo[g]);
        const long long start = (a.pos64 ? sa12 : lo[g]) - 16;
        const int o = static_cast<int>(start & 15);
        const long long pi = a.pre ? r * a.C + c[g]
                                   : clampll((start >> 4) + 1, 0,
                                             a.m_pair - 1);
        const int2 t = reinterpret_cast<const int2*>(a.text_pair)[pi];
        const uint32_t w_lo = static_cast<uint32_t>(t.x);
        const uint32_t w_hi = static_cast<uint32_t>(t.y);
        // o == 0 takes nothing of the high word (a shift by 32 is
        // undefined)
        ctx[g] = (w_lo >> (2 * o)) | (o ? w_hi << (32 - 2 * o) : 0u);
      }
    }
  }
  const long long p = r % a.P;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    out[g] = P::none(c[g]);
    if (own[g] >= S) continue;
    const bool wide = sd.wide[own[g]] != 0;
    const long long sa12 =
        a.pos64 ? (static_cast<long long>(hi[g]) << 32)
                      | static_cast<uint32_t>(lo[g])
                : lo[g];
    const bool verified =
        a.left == 0 || wide
        || (sa12 >= a.left
            && (ctx[g] >> shift) == static_cast<uint32_t>(sd.qw[own[g]]));
    if (!verified) continue;
    const long long j = p + a.step * own[g];
    const long long off = wide ? 0 : a.left;
    if (sizeof(KT) == 8) {
      out[g] = P::vote(sa12 - off - j, c[g]);
    } else {
      out[g] = P::vote(static_cast<int32_t>(
          static_cast<uint32_t>(lo[g]) - static_cast<uint32_t>(off)
          - static_cast<uint32_t>(j)), c[g]);
    }
  }
}

template <class KT>
__device__ __forceinline__ void write_row(const RowsArgs& a, long long r,
                                          int v1, long long key1, int v2,
                                          int32_t total, bool drop) {
  a.v1[r] = v1;
  a.v2[r] = v2;
  a.total[r] = total;
  a.row_ovf[r] = drop;
  static_cast<KT*>(a.key1)[r] = static_cast<KT>(key1);
}

// Read b's accept by one warp, from its P rows' outputs (read through L2:
// other CTAs may have written them).
template <class KT>
__device__ void read_accept(const RowsArgs& a, long long b) {
  const int lane = threadIdx.x & 31;
  const int P = static_cast<int>(a.P);
  const long long r0 = b * a.P;
  const KT* key1 = static_cast<const KT*>(a.key1);
  const int32_t ns = a.lens[b] / static_cast<int32_t>(a.step);
  int first = P;
  for (int p = lane; p < P; p += 32) {
    const uint32_t v = static_cast<uint32_t>(__ldcg(a.v1 + r0 + p))
                       + static_cast<uint32_t>(__ldcg(a.v2 + r0 + p));
    const bool acc =
        ns > 0
        && static_cast<int32_t>(v * static_cast<uint32_t>(a.dacc))
               > static_cast<int32_t>(static_cast<uint32_t>(a.nacc)
                                      * static_cast<uint32_t>(ns));
    if (acc && p < first) first = p;
  }
  first = __reduce_min_sync(kFull, first);
  const bool any = first < P;
  // the outer histogram: phases before the accepted one (all if none)
  // whose v1 != 0, top-1 by (count desc, first phase asc)
  const int upto = any ? first : P;
  uint32_t win = 0;
  KT wkey = 0;
  for (int p = lane; p < upto && ns > 0; p += 32) {
    if (__ldcg(a.v1 + r0 + p) == 0) continue;
    const KT kp = __ldcg(key1 + r0 + p);
    int count = 0;
    bool head = true;
    KT mn = kp;
    for (int q = 0; q < upto; ++q) {
      if (__ldcg(a.v1 + r0 + q) == 0) continue;
      const KT kq = __ldcg(key1 + r0 + q);
      if ((kq >> 4) != (kp >> 4)) continue;
      ++count;
      head = head && q >= p;
      mn = kq < mn ? kq : mn;
    }
    const uint32_t w = (static_cast<uint32_t>(count) << 16)
                       | (0xFFFFu - static_cast<uint32_t>(p));
    if (head && w > win) {
      win = w;
      wkey = mn;
    }
  }
  const uint32_t w = __reduce_max_sync(kFull, win);
  const unsigned who = __ballot_sync(kFull, w != 0 && win == w);
  const KT k = __shfl_sync(kFull, wkey, who ? __ffs(who) - 1 : 0);
  const KT outer = who ? k : 0;
  // no acceptance, or acceptance on the last phase: the outer top-1
  const KT best = !any || first == P - 1 ? outer : __ldcg(key1 + r0 + first);
  // overflow over the executed phases: up to the accepted one (all if none)
  const int last = any ? first : P - 1;
  bool ovf = false;
  for (int p = lane; p <= last; p += 32) {
    ovf = ovf || __ldcg(a.total + r0 + p) > a.C
          || __ldcg(a.row_ovf + r0 + p) != 0;
  }
  ovf = __any_sync(kFull, ovf);
  if (lane == 0) {
    static_cast<KT*>(a.best)[b] = best;
    a.overflow[b] = ovf;
  }
}

// Lane `lane`'s K slots l*K .. of row r.
template <int K, class P>
__device__ __forceinline__ void warp_fill(const RowsArgs& a, long long r,
                                          const Seeds<typename P::KT>& sd,
                                          int lane, P (&p)[K]) {
  constexpr int G = K < kGatherBatch ? K : kGatherBatch;
#pragma unroll
  for (int g0 = 0; g0 < K; g0 += G) {
    int c[G];
    P q[G];
#pragma unroll
    for (int g = 0; g < G; ++g) c[g] = lane * K + g0 + g;
    fill_slots<G>(a, r, sd, c, q);
#pragma unroll
    for (int g = 0; g < G; ++g) p[g0 + g] = q[g];
  }
}

// A warp's vote of row r at the fewest pairs a lane whose 32K slots hold
// the row's `need` occupied ones (every slot past the total is empty, so
// the rest would only sort sentinels): fill, sort, top-2, write.
// The sizes are inlined into one body: a non-inlined function a K took
// 0.125 ms against 0.091 for a 1 kb chunk on an H100, its call frame
// costing more than the few bytes the inlined body spills.
template <int K, class P>
__device__ void warp_vote(const RowsArgs& a, long long r,
                          const Seeds<typename P::KT>& sd, int lane,
                          uint32_t need, int32_t total, bool drop) {
  if constexpr (K > 1) {
    if (need <= 16 * K) {
      warp_vote<K / 2, P>(a, r, sd, lane, need, total, drop);
      return;
    }
  }
  P p[K];
  warp_fill<K>(a, r, sd, lane, p);
  warp_sort<K>(p, 0, lane);
  int v1;
  int v2;
  long long key1;
  warp_top2<K>(p, lane, &v1, &key1, &v2);
  if (lane == 0) write_row<typename P::KT>(a, r, v1, key1, v2, total, drop);
}

// A warp's row: stage its seeds, then the vote (or, at stage kStageRows,
// every slot's row to gather).
template <int K, class P>
__device__ void warp_row(const RowsArgs& a, long long r,
                         const Seeds<typename P::KT>& sd, int lane) {
  bool drop;
  const int32_t total = warp_stage(a, r, sd, lane, &drop);
  if (a.stage == kStageRows) {
    P p[K];
    warp_fill<K>(a, r, sd, lane, p);
    return;
  }
  const uint32_t occupied = static_cast<uint32_t>(total);
  warp_vote<K, P>(a, r, sd, lane,
                  occupied < a.C ? occupied : static_cast<uint32_t>(a.C),
                  total, drop);
}

// ---------------------------------------------------------------------------
// A CTA a read (blockIdx.x = b), a warp a row; then the read's accept.
// Dynamic shared memory: each warp's staged seeds.
template <int K, class P>
__global__ void __launch_bounds__(kWarpRows * 32)
vote_warp_kernel(RowsArgs a) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x;
  const Seeds<typename P::KT> sd(
      lrm_smem + warp * seed_bytes(a.S, sizeof(typename P::KT)),
      static_cast<int>(a.S));
  for (int p = warp; p < a.P; p += blockDim.x >> 5) {
    warp_row<K, P>(a, b * a.P + p, sd, lane);
  }
  if (a.stage == kStageRows) return;
  __syncthreads();
  if (warp == 0) read_accept<typename P::KT>(a, b);
}

// A CTA a row (blockIdx.x = r) of Cpad pairs, kCtaPairs a thread; the CTA
// that writes a read's last row runs its accept.  Dynamic shared memory (or
// the row's global scratch): the pairs, then the staged seeds.
template <class P>
__global__ void __launch_bounds__(kCtaMaxThreads)
vote_cta_kernel(RowsArgs a) {
  constexpr int K = kCtaPairs;
  __shared__ uint32_t sh_u[32];
  __shared__ Seg sh_seg[32];
  __shared__ Top sh_top[32];
  __shared__ int sh_last;
  const long long r = blockIdx.x;
  const int N = static_cast<int>(a.Cpad);
  unsigned char* base = a.use_global ? a.scratch + r * a.row_bytes
                                     : lrm_smem;
  const Mem<P> m(base, N);
  const Seeds<typename P::KT> sd(base + static_cast<long long>(P::kBytes) * N,
                                 static_cast<int>(a.S));
  bool drop;
  const int32_t total = cta_stage(a, r, sd, sh_u, &drop);
  // the vote sorts the fewest pairs (a power of 2, 128 at least) that hold
  // the row's occupied slots: every slot past the total is empty
  const uint32_t occupied = static_cast<uint32_t>(total);
  int n = 32 * K;
  while (static_cast<uint32_t>(n) < occupied && n < a.C) n <<= 1;
  const int fill = a.stage == kStageRows ? N : n;
  for (int c0 = 0; c0 < fill; c0 += blockDim.x * K) {
    int c[K];
    P q[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) c[kk] = c0 + kk * blockDim.x + threadIdx.x;
    fill_slots<K>(a, r, sd, c, q);
    if (a.stage == kStageRows) continue;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      if (c[kk] < n) m.st(c[kk], q[kk]);
    }
  }
  if (a.stage == kStageRows) return;
  __syncthreads();
  cta_sort<K>(m, n);
  const Top t = cta_top2<K>(m, n, sh_seg, sh_top);
  const long long b = r / a.P;
  if (threadIdx.x == 0) {
    write_row<typename P::KT>(a, r, static_cast<int>(t.b1 >> 32),
                              t.b1 ? t.k1 : 0, static_cast<int>(t.b2 >> 32),
                              total, drop);
    __threadfence();
    sh_last = atomicAdd(a.tickets + b, 1) == a.P - 1;
  }
  __syncthreads();
  if (sh_last && threadIdx.x < 32) {
    __threadfence();
    read_accept<typename P::KT>(a, b);
    if (threadIdx.x == 0) a.tickets[b] = 0;
  }
}

// ---------------------------------------------------------------------------
// top2_votes: column c of row r is slot c.

template <class P>
__device__ __forceinline__ P top2_pair(const Top2Args& a, long long r,
                                       int c) {
  if (c >= a.V || !a.valid[r * a.V + c]) return P::none(c);
  return P::vote(static_cast<const typename P::KT*>(a.keys)[r * a.V + c], c);
}

template <class KT>
__device__ __forceinline__ void top2_write(const Top2Args& a, long long r,
                                           int v1, long long key1, int v2) {
  a.v1[r] = v1;
  a.v2[r] = v2;
  static_cast<KT*>(a.key1)[r] = static_cast<KT>(key1);
}

// kWarpRows rows a CTA, a warp a row of 32K pairs in registers.
template <int K, class P>
__global__ void __launch_bounds__(kWarpRows * 32)
top2_warp_kernel(Top2Args a) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarpRows
                      + (threadIdx.x >> 5);
  if (r >= a.B) return;
  P p[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) p[kk] = top2_pair<P>(a, r, lane * K + kk);
  warp_sort<K>(p, 0, lane);
  int v1;
  int v2;
  long long key1;
  warp_top2<K>(p, lane, &v1, &key1, &v2);
  if (lane == 0) top2_write<typename P::KT>(a, r, v1, key1, v2);
}

// A CTA a row of Vpad pairs in shared memory or its global scratch row.
template <class P>
__global__ void __launch_bounds__(kCtaMaxThreads)
top2_cta_kernel(Top2Args a) {
  constexpr int K = kCtaPairs;
  __shared__ Seg sh_seg[32];
  __shared__ Top sh_top[32];
  const long long r = blockIdx.x;
  const int N = static_cast<int>(a.Vpad);
  const Mem<P> m(a.use_global ? a.scratch + r * a.row_bytes : lrm_smem, N);
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    m.st(c, top2_pair<P>(a, r, c));
  }
  __syncthreads();
  cta_sort<K>(m, N);
  const Top t = cta_top2<K>(m, N, sh_seg, sh_top);
  if (threadIdx.x == 0) {
    top2_write<typename P::KT>(a, r, static_cast<int>(t.b1 >> 32),
                               t.b1 ? t.k1 : 0, static_cast<int>(t.b2 >> 32));
  }
}

// ---------------------------------------------------------------------------
// Launches.

// Dynamic shared memory past the default 48 KB a block, less room for the
// kernels' static arrays (at most 8 KB), needs the opt-in attribute.
int set_smem(const void* kernel, long long smem) {
  if (smem + 8 * 1024 > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

// Dynamic shared memory a block may take: the card's 227 KB less room for
// the static arrays.  A CTA kernel's row that needs more lives in a global
// scratch row (use_global).
constexpr long long kSmemMax = 227 * 1024 - 8 * 1024;

// Bytes of a CTA kernel's row: its n pairs, then its S staged seeds (none
// for top2_votes).
template <class P>
long long row_need(long long n, long long S) {
  return P::kBytes * n + seed_bytes(S, sizeof(typename P::KT));
}

// Whether the wrapper's use_global and row_bytes fit a row of `need` bytes.
bool scratch_ok(long long use_global, long long row_bytes, long long need) {
  return use_global == (need > kSmemMax)
         && (!use_global || row_bytes >= need);
}

// Threads of a CTA kernel's row of n pairs: kCtaPairs pairs each, at most
// kCtaMaxThreads.
int cta_threads(long long n) {
  const long long t = n / kCtaPairs;
  return static_cast<int>(t > kCtaMaxThreads ? kCtaMaxThreads : t);
}

template <int K, class P>
int vote_warp_launch(const RowsArgs& a, int warps, long long smem,
                     cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&vote_warp_kernel<K, P>);
  const int err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  vote_warp_kernel<K, P><<<static_cast<unsigned>(a.B), warps * 32,
                           static_cast<size_t>(smem), st>>>(a);
  return cudaGetLastError();
}

template <class P>
int vote_launch(const RowsArgs& a, cudaStream_t st) {
  const long long sb = seed_bytes(a.S, sizeof(typename P::KT));
  if (a.Cpad <= kWarpMaxPad) {
    if (a.use_global) return -1;
    // the fewest rows a warp, then the fewest warps that take them
    const long long per = (a.P + kWarpRows - 1) / kWarpRows;
    long long warps = (a.P + per - 1) / per;
    while (warps > 1 && warps * sb > kSmemMax) --warps;
    if (warps * sb > kSmemMax) return -1;
    const int w = static_cast<int>(warps);
    switch (a.Cpad <= 32 ? 32 : a.Cpad) {
      case 32: return vote_warp_launch<1, P>(a, w, warps * sb, st);
      case 64: return vote_warp_launch<2, P>(a, w, warps * sb, st);
      case 128: return vote_warp_launch<4, P>(a, w, warps * sb, st);
      case 256: return vote_warp_launch<8, P>(a, w, warps * sb, st);
      default: return vote_warp_launch<16, P>(a, w, warps * sb, st);
    }
  }
  const long long need = row_need<P>(a.Cpad, a.S);
  if (!scratch_ok(a.use_global, a.row_bytes, need)) return -1;
  const long long smem = a.use_global ? 0 : need;
  const void* fn = reinterpret_cast<const void*>(&vote_cta_kernel<P>);
  const int err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  vote_cta_kernel<P><<<static_cast<unsigned>(a.B * a.P),
                       cta_threads(a.Cpad), static_cast<size_t>(smem),
                       st>>>(a);
  return cudaGetLastError();
}

template <int K, class P>
int top2_warp_launch(const Top2Args& a, cudaStream_t st) {
  const long long grid = (a.B + kWarpRows - 1) / kWarpRows;
  top2_warp_kernel<K, P><<<static_cast<unsigned>(grid), kWarpRows * 32, 0,
                           st>>>(a);
  return cudaGetLastError();
}

template <class P>
int top2_launch(const Top2Args& a, cudaStream_t st) {
  if (a.Vpad <= kWarpMaxPad) {
    if (a.use_global) return -1;
    switch (a.Vpad <= 32 ? 32 : a.Vpad) {
      case 32: return top2_warp_launch<1, P>(a, st);
      case 64: return top2_warp_launch<2, P>(a, st);
      case 128: return top2_warp_launch<4, P>(a, st);
      case 256: return top2_warp_launch<8, P>(a, st);
      default: return top2_warp_launch<16, P>(a, st);
    }
  }
  const long long need = row_need<P>(a.Vpad, 0);
  if (!scratch_ok(a.use_global, a.row_bytes, need)) return -1;
  const long long smem = a.use_global ? 0 : need;
  const void* fn = reinterpret_cast<const void*>(&top2_cta_kernel<P>);
  const int err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  top2_cta_kernel<P><<<static_cast<unsigned>(a.B), cta_threads(a.Vpad),
                       static_cast<size_t>(smem), st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Each launch returns 0 on success, a cudaError_t
// code when the launch is refused, or -1 for arguments the kernel does not
// take.  The argument structs are filled by ops/seed_vote.py and
// ops/vote.py.

// Bytes of global scratch a row of n_pad pairs (and S staged seeds; 0 for
// top2_votes) needs: 0 when the row sorts in a warp's registers or in
// shared memory.  The wrappers size use_global, row_bytes and the scratch
// by it, so the rows' layout is known here only.
extern "C" long long lrm_vote_scratch_bytes(long long n_pad, long long S,
                                            long long k64) {
  if (n_pad <= kWarpMaxPad) return 0;
  const long long need = k64 ? row_need<P64>(n_pad, S)
                             : row_need<P32>(n_pad, S);
  return need > kSmemMax ? (need + 15) / 16 * 16 : 0;
}

extern "C" int lrm_seed_tables(const TablesArgs* args, void* stream) {
  TablesArgs a = *args;
  if (a.B <= 0 || a.P <= 0 || a.S <= 0 || a.L <= 0 || a.H <= 0
      || a.left < 0 || a.left > 16 || a.hlen <= 0 || a.hlen > 16
      || a.seed_len != a.left + a.hlen || a.npw <= 0 || a.nocc <= 0
      || a.step <= 0) {
    return -1;
  }
  // the kernel's positions and CTA indices are 32-bit
  if (a.B > 0x7FFFFFFFLL || a.L > 0x7FFFFFFFLL
      || a.P + a.step * a.S + a.seed_len + 32 > 0x7FFFFFFFLL) {
    return -1;
  }
  long long chunks = 0;
  size_t smem = 0;
  const SeedPart q = seed_part(a, &chunks, &smem);
  if (chunks > 65535 || smem > static_cast<size_t>(227 * 1024)) return -1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        seed_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  seed_tables_kernel<<<dim3(static_cast<unsigned>(a.B),
                            static_cast<unsigned>(chunks)),
                       kSeedThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a, q);
  return cudaGetLastError();
}


extern "C" int lrm_vote_rows(const RowsArgs* args, void* stream) {
  RowsArgs a = *args;
  if (a.B <= 0 || a.P <= 0 || a.P > 4096 || a.S <= 0 || a.C <= 0
      || !pow2(a.Cpad) || a.Cpad < a.C || a.Cpad >= (1LL << 26) || a.n <= 0
      || a.left < 0 || a.left > 16 || a.step <= 0 || a.dacc <= 0
      || (a.slim && a.left > 0 && a.m_pair <= 0)
      || a.B * a.P > 0x7FFFFFFFLL) {
    return -1;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.pos64 ? vote_launch<P64>(a, st) : vote_launch<P32>(a, st);
}

extern "C" int lrm_top2_votes(const Top2Args* args, void* stream) {
  Top2Args a = *args;
  if (a.B <= 0 || a.V <= 0 || !pow2(a.Vpad) || a.Vpad < a.V
      || a.Vpad >= (1LL << 26) || a.B > 0x7FFFFFFFLL) {
    return -1;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.k64 ? top2_launch<P64>(a, st) : top2_launch<P32>(a, st);
}
