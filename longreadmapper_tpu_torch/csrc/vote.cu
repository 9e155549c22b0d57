// The seed vote for Hopper (sm_90a): seed_tables_kernel, the per-seed
// tables and lchash gather, and vote_rows_kernel, a (read, phase) row's
// whole vote (slot owners, the sa_ctx gather and verify, the top-2 diagonal
// buckets); top2_votes_kernel is vote_rows_kernel's second half on keys
// given by the caller.
//
// Replaces XLA gathers and sorts of the JAX package (none is a pallas_call):
//   seed_tables_kernel  longreadmapper_tpu/mapping/pipeline.py:362
//                       _position_tables, the lchash gather of _seed_vote
//                       (:581) and the LF narrowing of _narrow_wide_seeds
//   vote_rows_kernel    _slots_by_owner (the owns reduce of :651), the
//                       sa_ctx gather and verify (:690-761) and
//                       longreadmapper_tpu/ops/vote.py:56 top2_votes
//   top2_votes_kernel   longreadmapper_tpu/ops/vote.py:56 top2_votes
// Contract: the plain PyTorch versions seed_tables_plain and
// vote_rows_plain (ops/seed_vote.py) and top2_votes_plain (ops/vote.py),
// bit for bit: every quantity is an integer, and every int32 sum wraps as
// the plain version's does.
//
// seed_tables_kernel: one thread a seed (read b, phase p, seed s), the flat
// index e = (b*P + p)*S + s, start j = p + step*s.  It reads the seed_len
// codes once and builds in registers the verify pattern qw (the first
// `left` codes, 2 bits each, the first lowest), the lchash key (the last
// hlen codes, the first highest) and ok (no code >= 4); gathers the lch
// row (k, l) (and the high bytes under pos64); then present, cnt12 =
// min(l - k + 1, thres) and wide = cnt12 >= thres.  A wide seed is
// LF-narrowed here, `left` backward-search steps over the replicated FM
// tables, to its seed_len-mer interval (kw, cw = its informative count):
// JAX narrows only the first wide_lanes wide seeds of the chunk, and each
// seed's narrowing depends on that seed alone, so the step keeps these
// values for the seeds that JAX picks (pipeline._pick_wide_seeds) and
// drops the rest as JAX does.
//
// vote_rows_kernel: one CTA a row r = b*P + p of C slots.
//   1. cum = the inclusive scan of the row's S counts (int32, wrapping).
//   2. slot c's owner = the first seed with cum > c (torch.searchsorted(...,
//      right=True)): zero-count seeds own nothing; a slot past the total is
//      empty.  An occupied slot gathers the sa_ctx row at p_rank = k_seed -
//      (cum - cnt) + c, clamped to [0, n-1]: (SA, context word), the SA
//      value alone in the slim layout (then the verify window comes from
//      one text_pair row, as _ctx_window), and the high byte under pos64.
//      A wide seed's slot skips the verify and takes a key offset of 0.
//   3. bucket = key >> 4 (+128 in int32), the sentinel for a slot that is
//      empty or fails the verify; the (bucket, slot << 4 | key & 15) pairs
//      are sorted in place (bitonic).  The slot makes every pair distinct,
//      so the order is the plain version's stable sort.
//   4. A run's head thread counts its run and takes the run's minimum
//      key & 15; top-1 = (count desc, first slot asc), top-2 = the largest
//      count of the other runs.  Writes v1, key1, v2 and the row's total.
// Rows whose pairs and counts do not fit the shared-memory limit take the
// same code over a global scratch row (use_global).
//
// An index whose tables are row-sharded over ranks (parallel/dist.py) is
// gathered by the wrapper between two launches: stage 1 writes the rows to
// gather, the wrapper's collective gathers them, and stage 2 reads the
// gathered rows (pre = 1) where it would gather.
//
// What bounds these kernels: bytes.  The lch and sa_ctx gathers are random
// 8-byte reads, a 32-byte sector each, a few million a chunk; the tables
// write 21 bytes a seed.  A 1 kb chunk (B 2048) moves ~0.15 GB: ~45 us at
// 3.35 TB/s.

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
  const int32_t* cnt;       // (BP, S)
  const void* kseed;        // (BP, S) int32, int64 under pos64
  const int32_t* qw;        // (BP, S)
  const uint8_t* wide;      // (BP, S)
  const int32_t* sa_ctx;    // (n, 2) full, (n,) slim; (BP*C, ...) when pre
  const uint8_t* sa_hi;     // (n,), pos64 only; (BP*C,) when pre
  const int32_t* text_pair; // (m_pair, 2), slim only; (BP*C, 2) when pre
  int64_t* rows;            // stage kStageRows: p_safe (BP, C)
  int32_t* v1;              // outputs, (BP,) each
  void* key1;               // int32, int64 under pos64
  int32_t* v2;
  int32_t* total;
  unsigned char* scratch;   // use_global: BP rows of row_bytes
  long long BP, P, S, step, C, Cpad, n, m_pair, left;
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

constexpr int kTablesThreads = 256;
constexpr int kRowMaxThreads = 512;
constexpr unsigned kM01 = 0x55555555u;
constexpr int kSent32 = 0x7FFFFFFF;
constexpr long long kSent64 = LLONG_MAX;
constexpr int kStageAll = 0;    // the whole kernel, gathers included
constexpr int kStageRows = 1;   // only the rows to gather (a sharded index)

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

// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kTablesThreads)
seed_tables_kernel(TablesArgs a) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (e >= a.B * a.P * a.S) return;
  const long long s = e % a.S;
  const long long r = e / a.S;
  const long long p = r % a.P;
  const long long b = r / a.P;
  const long long j = p + a.step * s;
  const int8_t* row = a.codes + b * a.L;
  // codes past L are the pad code 4, as the plain version's padded copy
  uint32_t qw = 0;
  uint32_t num = 0;
  bool ok = true;
  for (int t = 0; t < a.seed_len; ++t) {
    const int c = j + t < a.L ? static_cast<int>(row[j + t]) : 4;
    ok = ok && c < 4;
    if (t < a.left) {
      qw |= static_cast<uint32_t>(c) << (2 * t);
    } else if (t - a.left < a.hlen) {
      num |= static_cast<uint32_t>(c) << (2 * (a.hlen - 1 - (t - a.left)));
    }
  }
  const long long safe = clampll(static_cast<int32_t>(num), 0, a.H - 1);
  if (a.stage == kStageRows) {
    a.rows[e] = safe;
    return;
  }
  const long long g = a.pre ? e : safe;
  const int32_t klo = a.lch[2 * g];
  const int32_t llo = a.lch[2 * g + 1];
  long long k12 = klo;
  long long l12 = llo;
  if (a.pos64) {
    k12 = (static_cast<long long>(a.lch_hi[2 * g]) << 32)
          | static_cast<uint32_t>(klo);
    l12 = (static_cast<long long>(a.lch_hi[2 * g + 1]) << 32)
          | static_cast<uint32_t>(llo);
  }
  const bool seed_ok = j < static_cast<long long>(a.lens[b]) - a.seed_len;
  const bool present = ok && seed_ok && !(k12 == 0 && l12 == 0);
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
  const bool wide = present && cnt >= a.thres;
  long long kw = k12;
  int cw = 0;
  if (wide) {
    // LF-narrow to the seed_len-mer: the left codes, last first
    long long k = k12;
    long long l = l12;
    for (int t = static_cast<int>(a.left) - 1; t >= 0; --t) {
      if (k > l) break;                 // empty: no later step is active
      const int c = (static_cast<int32_t>(qw) >> (2 * t)) & 3;
      const long long cb = c4_at(a, c);
      const long long sk = k < 1 ? 1 : k;
      const long long sl = clampll(l, 0, a.nocc * 16 - 1);
      k = cb + occ_at(a, c, sk - 1) + 1;
      l = cb + occ_at(a, c, sl);
    }
    const long long hits = k <= l ? l - k + 1 : 0;
    cw = hits > 0 && hits < a.thres ? static_cast<int>(hits) : 0;
    kw = k;
  }
  a.qw[e] = static_cast<int32_t>(qw);
  a.cnt12[e] = cnt;
  a.wide[e] = wide;
  a.cw[e] = cw;
  if (a.pos64) {
    static_cast<long long*>(a.k12)[e] = k12;
    static_cast<long long*>(a.kw)[e] = kw;
  } else {
    static_cast<int32_t*>(a.k12)[e] = static_cast<int32_t>(k12);
    static_cast<int32_t*>(a.kw)[e] = static_cast<int32_t>(kw);
  }
}

// ---------------------------------------------------------------------------
// Block helpers.  Each needs every thread of the block.

// In-place inclusive scan of n int32 (wrapping): each thread scans a
// contiguous chunk, then a Hillis-Steele scan of the chunk sums in `part`
// (2 * blockDim words).
__device__ void block_scan(int32_t* x, int n, uint32_t* part) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int chunk = (n + nt - 1) / nt;
  const int lo = tid * chunk;
  const int hi = lo + chunk < n ? lo + chunk : n;
  uint32_t sum = 0;
  for (int i = lo; i < hi; ++i) {
    sum += static_cast<uint32_t>(x[i]);
    x[i] = static_cast<int32_t>(sum);
  }
  part[tid] = sum;
  __syncthreads();
  uint32_t* src = part;
  uint32_t* dst = part + nt;
  for (int d = 1; d < nt; d <<= 1) {
    dst[tid] = src[tid] + (tid >= d ? src[tid - d] : 0u);
    __syncthreads();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
  const uint32_t before = tid ? src[tid - 1] : 0u;
  for (int i = lo; i < hi; ++i) {
    x[i] = static_cast<int32_t>(static_cast<uint32_t>(x[i]) + before);
  }
  __syncthreads();
}

// Ascending bitonic sort of npad (a power of 2) (bk, sl) pairs.
__device__ void block_sort(long long* bk, int32_t* sl, int npad) {
  const int nt = blockDim.x;
  for (int k = 2; k <= npad; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int q = threadIdx.x; q < npad / 2; q += nt) {
        const int i = 2 * jj * (q / jj) + (q % jj);
        const int o = i + jj;
        const long long bi = bk[i];
        const long long bo = bk[o];
        const int32_t si = sl[i];
        const int32_t so = sl[o];
        const bool gt = bi > bo || (bi == bo && si > so);
        if (gt == ((i & k) == 0)) {
          bk[i] = bo;
          bk[o] = bi;
          sl[i] = so;
          sl[o] = si;
        }
      }
      __syncthreads();
    }
  }
}

// The top-2 of a row's sorted pairs (its first n are the row's votes, the
// rest pads): run heads count their runs; top-1 by (count desc, first slot
// asc), top-2 the largest count of another run.  Ends with the block in
// step; thread 0 holds the results in *best, *v2, *key1.
__device__ void block_top2(const long long* bk, const int32_t* sl, int n,
                           bool k64, unsigned long long* best, int* v2,
                           long long* key1) {
  const int nt = blockDim.x;
  for (int pass = 0; pass < 2; ++pass) {
    const unsigned long long win = *best;
    const int wslot = static_cast<int>(0xFFFFFFFFu
                                       - static_cast<uint32_t>(win));
    for (int i = threadIdx.x; i < n; i += nt) {
      const long long b = bk[i];
      const bool valid = k64 ? b != kSent64 : b < kSent32;
      if (!valid || (i > 0 && bk[i - 1] == b)) continue;
      int count = 1;
      int mn = sl[i] & 15;
      for (int q = i + 1; q < n && bk[q] == b; ++q) {
        ++count;
        mn = min(mn, sl[q] & 15);
      }
      const int first = sl[i] >> 4;
      if (pass == 0) {
        atomicMax(best, (static_cast<unsigned long long>(count) << 32)
                            | (0xFFFFFFFFu - static_cast<uint32_t>(first)));
      } else if (first == wslot) {
        *key1 = k64 ? b * 16 + mn
                    : static_cast<int32_t>((b - 128) * 16 + mn);
      } else {
        atomicMax(v2, count);
      }
    }
    __syncthreads();
  }
}

// The block's share of dynamic shared memory, or its row of the global
// scratch.
__device__ __forceinline__ unsigned char* row_base(unsigned char* smem,
                                                   unsigned char* scratch,
                                                   long long use_global,
                                                   long long row_bytes) {
  return use_global ? scratch + blockIdx.x * row_bytes : smem;
}

extern __shared__ __align__(16) unsigned char lrm_smem[];

// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kRowMaxThreads)
vote_rows_kernel(RowsArgs a) {
  __shared__ uint32_t part[2 * kRowMaxThreads];
  __shared__ unsigned long long best;
  __shared__ int v2;
  __shared__ long long key1;
  const long long r = blockIdx.x;
  const int S = static_cast<int>(a.S);
  const int C = static_cast<int>(a.C);
  const int Cpad = static_cast<int>(a.Cpad);
  unsigned char* base = row_base(lrm_smem, a.scratch, a.use_global,
                                 a.row_bytes);
  long long* bk = reinterpret_cast<long long*>(base);
  int32_t* sl = reinterpret_cast<int32_t*>(base + 8 * a.Cpad);
  int32_t* cum = sl + Cpad;
  if (threadIdx.x == 0) {
    best = 0;
    v2 = 0;
    key1 = 0;
  }
  const int32_t* cnt = a.cnt + r * a.S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) cum[s] = cnt[s];
  __syncthreads();
  block_scan(cum, S, part);

  const long long p = r % a.P;
  const int shift = static_cast<int>(2 * (16 - a.left));
  for (int c = threadIdx.x; c < Cpad; c += blockDim.x) {
    long long bkt = kSent64;
    int32_t nib = 0;
    if (c < C) {
      if (!a.pos64) bkt = kSent32;
      // the first seed whose cum passes c
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
      const int own = lo;
      const long long e = r * a.S + own;
      long long p_rank = c;
      if (own < S) {
        const int32_t start = own ? cum[own - 1] : 0;
        if (a.pos64) {
          p_rank = static_cast<const long long*>(a.kseed)[e] - start + c;
        } else {
          p_rank = static_cast<int32_t>(
              static_cast<uint32_t>(static_cast<const int32_t*>(a.kseed)[e])
              - static_cast<uint32_t>(start) + static_cast<uint32_t>(c));
        }
      }
      const long long p_safe = clampll(p_rank, 0, a.n - 1);
      if (a.stage == kStageRows) {
        a.rows[r * a.C + c] = p_safe;
        continue;
      }
      if (own < S) {
        const long long g = a.pre ? r * a.C + c : p_safe;
        const int32_t sa_lo = a.slim ? a.sa_ctx[g] : a.sa_ctx[2 * g];
        const long long sa12 =
            a.pos64 ? (static_cast<long long>(a.sa_hi[g]) << 32)
                          | static_cast<uint32_t>(sa_lo)
                    : sa_lo;
        const bool wide = a.wide[e] != 0;
        bool verified = true;
        if (a.left > 0 && !wide) {
          uint32_t win;
          if (a.slim) {
            // _ctx_window: the 16 bases before sa12 from one text pair
            const long long start = sa12 - 16;
            const long long w0 = (start >> 4) + 1;
            const int o = static_cast<int>(start & 15);
            const long long pi = a.pre ? r * a.C + c
                                       : clampll(w0, 0, a.m_pair - 1);
            const uint32_t w_lo = static_cast<uint32_t>(a.text_pair[2 * pi]);
            const uint32_t w_hi =
                static_cast<uint32_t>(a.text_pair[2 * pi + 1]);
            // o == 0 takes nothing of the high word (a shift by 32 is
            // undefined)
            win = ((w_lo >> (2 * o)) | (o ? w_hi << (32 - 2 * o) : 0u))
                  >> shift;
          } else {
            win = static_cast<uint32_t>(a.sa_ctx[2 * g + 1]) >> shift;
          }
          verified = sa12 >= a.left
                     && win == static_cast<uint32_t>(a.qw[e]);
        }
        if (verified) {
          const long long j = p + a.step * own;
          const long long off = wide ? 0 : a.left;
          if (a.pos64) {
            const long long key = sa12 - off - j;
            bkt = key >> 4;
            nib = static_cast<int32_t>(key & 15);
          } else {
            const int32_t key = static_cast<int32_t>(
                static_cast<uint32_t>(sa_lo) - static_cast<uint32_t>(off)
                - static_cast<uint32_t>(j));
            bkt = (key >> 4) + 128;
            nib = key & 15;
          }
        }
      }
    }
    bk[c] = bkt;
    sl[c] = (c << 4) | nib;
  }
  if (a.stage == kStageRows) return;
  __syncthreads();
  block_sort(bk, sl, Cpad);
  block_top2(bk, sl, C, a.pos64 != 0, &best, &v2, &key1);
  if (threadIdx.x == 0) {
    a.v1[r] = static_cast<int32_t>(best >> 32);
    a.v2[r] = v2;
    a.total[r] = cum[S - 1];
    if (a.pos64) {
      static_cast<long long*>(a.key1)[r] = key1;
    } else {
      static_cast<int32_t*>(a.key1)[r] = static_cast<int32_t>(key1);
    }
  }
}

// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kRowMaxThreads)
top2_votes_kernel(Top2Args a) {
  __shared__ unsigned long long best;
  __shared__ int v2;
  __shared__ long long key1;
  const long long r = blockIdx.x;
  const int V = static_cast<int>(a.V);
  const int Vpad = static_cast<int>(a.Vpad);
  unsigned char* base = row_base(lrm_smem, a.scratch, a.use_global,
                                 a.row_bytes);
  long long* bk = reinterpret_cast<long long*>(base);
  int32_t* sl = reinterpret_cast<int32_t*>(base + 8 * a.Vpad);
  if (threadIdx.x == 0) {
    best = 0;
    v2 = 0;
    key1 = 0;
  }
  for (int c = threadIdx.x; c < Vpad; c += blockDim.x) {
    long long bkt = kSent64;
    int32_t nib = 0;
    if (c < V) {
      const long long e = r * a.V + c;
      const bool valid = a.valid[e] != 0;
      if (a.k64) {
        const long long key = static_cast<const long long*>(a.keys)[e];
        bkt = valid ? key >> 4 : kSent64;
        nib = static_cast<int32_t>(key & 15);
      } else {
        const int32_t key = static_cast<const int32_t*>(a.keys)[e];
        bkt = valid ? (key >> 4) + 128 : kSent32;
        nib = key & 15;
      }
    }
    bk[c] = bkt;
    sl[c] = (c << 4) | nib;
  }
  __syncthreads();
  block_sort(bk, sl, Vpad);
  block_top2(bk, sl, V, a.k64 != 0, &best, &v2, &key1);
  if (threadIdx.x == 0) {
    a.v1[r] = static_cast<int32_t>(best >> 32);
    a.v2[r] = v2;
    if (a.k64) {
      static_cast<long long*>(a.key1)[r] = key1;
    } else {
      static_cast<int32_t*>(a.key1)[r] = static_cast<int32_t>(key1);
    }
  }
}

// Threads of a row's CTA: half its padded length (one pair each a sort
// step), 32 to kRowMaxThreads.
int row_threads(long long npad) {
  long long t = npad / 2;
  t = t < 32 ? 32 : t;
  return static_cast<int>(t > kRowMaxThreads ? kRowMaxThreads : t);
}

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

}  // namespace

// C interface for ctypes.  Each returns 0 on success, a cudaError_t code
// when the launch is refused, or -1 for arguments the kernel does not take.
// The argument structs are filled by ops/seed_vote.py and ops/vote.py.

extern "C" int lrm_seed_tables(const TablesArgs* args, void* stream) {
  TablesArgs a = *args;
  if (a.B <= 0 || a.P <= 0 || a.S <= 0 || a.L <= 0 || a.H <= 0
      || a.left < 0 || a.left > 16 || a.hlen <= 0 || a.hlen > 16
      || a.seed_len != a.left + a.hlen || a.npw <= 0 || a.nocc <= 0) {
    return -1;
  }
  const long long n = a.B * a.P * a.S;
  const long long grid = (n + kTablesThreads - 1) / kTablesThreads;
  if (grid > 0x7FFFFFFFLL) return -1;
  seed_tables_kernel<<<static_cast<unsigned>(grid), kTablesThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int lrm_vote_rows(const RowsArgs* args, void* stream) {
  RowsArgs a = *args;
  if (a.BP <= 0 || a.P <= 0 || a.S <= 0 || a.C <= 0 || !pow2(a.Cpad)
      || a.Cpad < a.C || a.Cpad >= (1LL << 27) || a.n <= 0 || a.left < 0
      || a.left > 16 || (a.slim && a.left > 0 && a.m_pair <= 0)
      || a.BP > 0x7FFFFFFFLL) {
    return -1;
  }
  const long long need = 12 * a.Cpad + 4 * a.S;
  if (a.use_global ? a.row_bytes < need : a.row_bytes != need) return -1;
  const long long smem = a.use_global ? 0 : need;
  const int err = set_smem(reinterpret_cast<const void*>(vote_rows_kernel),
                           smem);
  if (err != cudaSuccess) return err;
  vote_rows_kernel<<<static_cast<unsigned>(a.BP), row_threads(a.Cpad),
                     static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int lrm_top2_votes(const Top2Args* args, void* stream) {
  Top2Args a = *args;
  if (a.B <= 0 || a.V <= 0 || !pow2(a.Vpad) || a.Vpad < a.V
      || a.Vpad >= (1LL << 27) || a.B > 0x7FFFFFFFLL) {
    return -1;
  }
  const long long need = 12 * a.Vpad;
  if (a.use_global ? a.row_bytes < need : a.row_bytes != need) return -1;
  const long long smem = a.use_global ? 0 : need;
  const int err = set_smem(reinterpret_cast<const void*>(top2_votes_kernel),
                           smem);
  if (err != cudaSuccess) return err;
  top2_votes_kernel<<<static_cast<unsigned>(a.B), row_threads(a.Vpad),
                      static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
