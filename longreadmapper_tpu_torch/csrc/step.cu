// The mapping step's glue for Hopper (sm_90a): the small stages around the
// banded DP and the CIGAR walks.
//
// Replaces no pallas_call.  In the JAX package these stages are XLA fusions
// inside the jitted step (longreadmapper_tpu/mapping/pipeline.py,
// make_map_step: _body and raw_step), which the port ran as chains of
// eager PyTorch ops (about 105 launches of a 1 kb step):
//   encode_kernel         raw_step's ASCII encode and reverse complement
//                         (pipeline.py:1055-1067)
//   locate_window_kernel  _seq_lookup (:798-820), the strand select of q
//                         and the target window from the 2-bit packed text
//                         (:844-880)
//   the lanes             the walk's inputs: ed from the DP's centre column,
//                         the narrow pass's band-short flag (overflow bit
//                         2), the lanes that walk (:896-910, 972-977, 989):
//                         no launch of their own but csrc/lanes.cuh's
//                         lane_out, called by walk_c_kernel (csrc/walk.cu)
//                         for the walk length and by lanes_kernel, the gact
//                         walk's setup (its walk state and its run buffer
//                         of pads), each writing the lane's values that
//                         pack_kernel reads
//   pack_kernel           the meta words, the run entries stably partitioned
//                         with the pads last, the blob and the tail
//                         (:989-1050)
// Contract: the plain versions of ops/step.py, bit for bit: the pads of the
// reverse complement, the first hit of the contig scan, int32 positions
// that wrap as PyTorch's int32 ops do, the pad entries' own values.
//
// What bounds them: bytes, and at the step's sizes the launch itself.  Each
// reads its inputs once and writes each output once: at the 1 kb shape
// (B 2048, L 1024) q and t are 4 MB, the raw encode 6 MB, the pack's runs
// and blob under 1 MB, a few microseconds each at 3.35 TB/s.  So the
// designs are one pass each, with the work laid out for coalesced 16-byte
// access and no division in a thread:
//   encode   grid (B, chunks), a CTA in one row, whose read length it
//            reads from lens, so a ragged part ships raw as a uniform one
//            does: a thread 16 bases, one 16-byte load of the
//            row and one 16-byte store each of codes and codes_rc; the
//            codes by byte-wise compares in registers (__vcmpeq4), the
//            reverse complement's 16 source bytes from two aligned loads,
//            a funnel shift and a byte reversal (the row read as a ring);
//            a per-byte edge where L % 16 != 0 or a pointer is unaligned.
//   window   a thread 16 bases, one packed text word and a 16-byte store
//            each of q and t, after one warp a read has scanned the
//            contig table with a ballot.
//   lanes    the gact setup: a thread a read's walk state, the run buffer
//            filled grid-stride in 16-byte stores.  A launch of its own
//            (the first design, a thread a read writing four arrays) cost a
//            launch, 1.4 us alone on an H100 for ~15 ns of bytes, and its
//            wrapper 40-75 us of host time.
//   pack     the row read once in 16-byte slots, a group-wide scan of
//            each thread's entries that are not pads, each entry written
//            at its rank into an image of the blob row and the tail row in
//            shared memory, then both rows written out in aligned 16-byte
//            stores; a warp a row and 8 rows a CTA for short rows (the 1
//            kb bucket), a CTA of up to 1024 threads a row for long ones,
//            and rows past 32 KB of entries in tiles after a count pass.
// The first designs (a thread a base with a 64-bit modulo; a CTA a read
// whose warps counted, then wrote each entry byte by byte) took 9.5-9.9
// us (encode) and 5.7-11.9 us (pack) alone on an H100.

#include <cuda_runtime.h>

#include "lanes.cuh"

// The C entries' argument blocks, ops/step.py's ctypes Structures: every
// field 8 bytes.  Outside the anonymous namespace, or the C entries that
// take them would not be exported.

struct EncodeArgs {
  const unsigned char* raw;   // (B, L) ASCII
  signed char* codes;         // (B, L)
  signed char* codes_rc;      // (B, L)
  const int* lens;            // (B,) each row's read length L0
  long long B, L;
};

struct LocateArgs {
  const void* loc;               // (B,) int32, or int64 with loc64
  const int* lens;               // (B,)
  const signed char* codes;      // (B, L)
  const signed char* codes_rc;   // (B, L)
  const void* start;             // (M,) P: the contig table
  const void* slen;              // (M,) P
  const int* text;               // kStageAll: text_packed (ntext,);
                                 // kStageWindow: (B, L/16 + 1) words
  unsigned char* found;          // (B,) bool
  int* gi;                       // (B,)
  unsigned char* strand;         // (B,) bool
  void* off;                     // (B,) P
  void* loc_fwd;                 // (B,) P
  void* safe_loc;                // (B,) P
  long long* widx;               // kStageLocate: (B, L/16 + 1)
  signed char* q;                // (B, L)
  signed char* t;                // (B, L)
  long long B, L, M, n, ntext, p64, loc64, stage;
};

// The gact walk's setup: st and buf of csrc/walk.cu::lrm_gact_walk.
struct SetupArgs {
  LanesIn lanes;                 // lanes.wcol null: lanes.lens are the
                                 // walk's lengths as given
  int* st;                       // (3B + 3): i, j, done a lane; then the
                                 // write pointer, nsat and the CTA ticket
  unsigned* buf;                 // (B, n_rows) pairs of eb-byte entries
  long long B, n_rows, eb;       // eb: 2 (int16) or 4 (int32) entries
};

struct PackArgs {
  const void* best;              // (B,) int32, or int64 with best64
  const unsigned char* found;    // (B,) bool
  const int* gi;                 // (B,)
  const unsigned char* strand;   // (B,) bool
  const void* off;               // (B,) int32, or int64 with off64
  const int* ed_raw;             // (B,)
  const int* limit;              // (B,)
  const unsigned char* band_short;   // (B,) bool
  const int* overflow;           // (B,)
  const unsigned char* saturated;    // 0-dim bool (gact), or null
  const void* runs;              // (B, R) int16 (eb 2) or int32 (eb 4)
  signed char* blob;             // (B, 4 * meta words + head)
  signed char* tail;             // (B, eb * R - head)
  long long B, R, eb, head, pos64, best64, off64;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEncodeThreads = 128;   // a thread 16 bases: 2048 a CTA
constexpr int kWindowThreads = 128;   // a thread a 16-base word of a read
constexpr int kLanesThreads = 256;
constexpr unsigned kPadPair = (3u << 16) | 3u;   // two pad entries (op 3)
constexpr int kPackRowsCta = 8;       // warp-a-row CTAs: rows (warps) a CTA
constexpr int kPackSlots = 2;         // 16-byte slots of a row a thread
constexpr int kPackThreads = 1024;    // a CTA-a-row's threads, at most

// locate_window_kernel's stages: all in one launch, or (over a text whose
// rows are sharded) the locate and the window's word indices, then the
// window from the words gathered between the two launches
constexpr long long kStageAll = 0, kStageLocate = 1, kStageWindow = 2;

template <typename P> struct Unsigned;
template <> struct Unsigned<int> { using T = unsigned; };
template <> struct Unsigned<long long> { using T = unsigned long long; };

// position arithmetic that wraps as PyTorch's integer ops do (signed
// overflow is undefined in C++, unsigned wraps)
template <typename P>
__device__ __forceinline__ P wadd(P x, P y) {
  using U = typename Unsigned<P>::T;
  return static_cast<P>(static_cast<U>(x) + static_cast<U>(y));
}

template <typename P>
__device__ __forceinline__ P wsub(P x, P y) {
  using U = typename Unsigned<P>::T;
  return static_cast<P>(static_cast<U>(x) - static_cast<U>(y));
}

__device__ __forceinline__ long long clamp_ll(long long x, long long lo,
                                              long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ------------------------------------------------------------ the encode

// a/c/g/t of either case -> 0-3, every other byte -> 4
__device__ __forceinline__ int base_code(unsigned char c) {
  const unsigned u = c | 32u;
  return u == 'a' ? 0 : u == 'c' ? 1 : u == 'g' ? 2 : u == 't' ? 3 : 4;
}

__device__ __forceinline__ int complement(int c) { return c < 4 ? 3 - c : c; }

// base_code and complement(base_code) of the four ASCII bytes of w, byte
// for byte: __vcmpeq4 sets a byte to 0xff where the bytes are equal
__device__ __forceinline__ void codes4(unsigned w, unsigned& code,
                                       unsigned& comp) {
  const unsigned u = w | 0x20202020u;
  const unsigned ea = __vcmpeq4(u, 0x61616161u);     // 'a'
  const unsigned ec = __vcmpeq4(u, 0x63636363u);     // 'c'
  const unsigned eg = __vcmpeq4(u, 0x67676767u);     // 'g'
  const unsigned et = __vcmpeq4(u, 0x74747474u);     // 't'
  const unsigned other = ~(ea | ec | eg | et) & 0x04040404u;
  code = (ec & 0x01010101u) | (eg & 0x02020202u) | (et & 0x03030303u)
         | other;
  comp = (eg & 0x01010101u) | (ec & 0x02020202u) | (ea & 0x03030303u)
         | other;
}

// the 16 bytes from byte o (0-15) on of the 32 in x (lo) and y (hi),
// reversed: by static register moves (a shift of 2 words, then 1) and a
// funnel shift, so no register is indexed at run time
__device__ __forceinline__ uint4 reversed16(uint4 x, uint4 y, int o) {
  const unsigned w[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  unsigned s2[6], s1[5];
#pragma unroll
  for (int k = 0; k < 6; ++k) s2[k] = (o & 8) ? w[k + 2] : w[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) s1[k] = (o & 4) ? s2[k + 1] : s2[k];
  const unsigned sh = 8 * (o & 3);
  unsigned v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __funnelshift_r(s1[k], s1[k + 1], sh);
  return make_uint4(__byte_perm(v[3], 0, 0x0123),
                    __byte_perm(v[2], 0, 0x0123),
                    __byte_perm(v[1], 0, 0x0123),
                    __byte_perm(v[0], 0, 0x0123));
}

// codes_rc is the flipped complement rolled left by L - L0, L0 the row's
// own read length (lens, clamped to [0, L]): the read's L0 bases
// front-aligned, then the row's other bytes (pads or not) in reverse
// order, so codes_rc[j] = comp(raw[(L0 - 1 - j) mod L]).  grid (B, chunks
// of kEncodeThreads 16-base windows): a CTA is one row, so its threads
// read one L0; kVec: L % 16 == 0 and every pointer 16-aligned, else each
// thread takes its 16 bases a byte at a time.  In a 16-aligned row the 16
// source bytes of the window at j0 start at s = (L0 - 16 - j0) mod L, at
// the same offset L0 % 16 in its aligned word for every window of the
// row, and run on into the next word (the first, past the row's end).
template <bool kVec>
__global__ void __launch_bounds__(kEncodeThreads)
encode_kernel(const EncodeArgs a) {
  const int L = static_cast<int>(a.L);
  const int L0 = min(max(a.lens[blockIdx.x], 0), L);
  const size_t row = static_cast<size_t>(blockIdx.x) * L;
  const int j0 = 16 * (blockIdx.y * kEncodeThreads + threadIdx.x);
  const unsigned char* raw = a.raw + row;
  signed char* codes = a.codes + row;
  signed char* rc = a.codes_rc + row;
  if (!kVec) {
    for (int j = j0; j < j0 + 16 && j < L; ++j) {
      codes[j] = static_cast<signed char>(base_code(raw[j]));
      const int src = j < L0 ? L0 - 1 - j : L + L0 - 1 - j;
      rc[j] = static_cast<signed char>(complement(base_code(raw[src])));
    }
    return;
  }
  if (j0 >= L) return;
  // two aligned loads give the window's 16 source bytes (a CTA staging its
  // chunk's in shared memory measured 14% slower, PERF.md)
  const int o = L0 & 15;
  int s = L0 - 16 - j0;
  s += s < 0 ? L : 0;                    // in [-L, L - 16]: one wrap
  const int at = s - o;
  const uint4 lo = *reinterpret_cast<const uint4*>(raw + at);
  const uint4 hi =
      *reinterpret_cast<const uint4*>(raw + (at + 16 == L ? 0 : at + 16));
  const uint4 v = *reinterpret_cast<const uint4*>(raw + j0);
  uint4 c, unused;
  codes4(v.x, c.x, unused.x);
  codes4(v.y, c.y, unused.y);
  codes4(v.z, c.z, unused.z);
  codes4(v.w, c.w, unused.w);
  *reinterpret_cast<uint4*>(codes + j0) = c;
  const uint4 r = reversed16(lo, hi, o);
  uint4 rv;
  codes4(r.x, unused.x, rv.x);
  codes4(r.y, unused.y, rv.y);
  codes4(r.z, unused.z, rv.z);
  codes4(r.w, unused.w, rv.w);
  *reinterpret_cast<uint4*>(rc + j0) = rv;
}

// ------------------------------------------- the locate and the window

template <typename P>
struct Located {
  P off, loc_fwd, safe;
  int gi, found, strand;
};

// The first contig (in table order) whose forward or reverse half holds
// [loc, loc + qlen), as the plain version's argmax: the warp tests 32
// contigs at a time and the ballot's lowest set bit is the first hit.
// Called by the 32 lanes of one warp.
template <typename P>
__device__ Located<P> locate(const LocateArgs& a, long long b) {
  using U = typename Unsigned<P>::T;
  const int lane = threadIdx.x & 31;
  const P* start = static_cast<const P*>(a.start);
  const P* slen = static_cast<const P*>(a.slen);
  const long long raw = a.loc64 ? static_cast<const long long*>(a.loc)[b]
                                : static_cast<const int*>(a.loc)[b];
  const P loc = static_cast<P>(static_cast<U>(raw));   // loc.to(P)
  const P ql = static_cast<P>(a.lens[b]);
  const P lq = wadd(loc, ql);
  int gi = 0, found = 0;
  for (long long base = 0; base < a.M; base += 32) {
    const long long g = base + lane;
    bool hit = false;
    if (g < a.M) {
      const P s = start[g], l = slen[g];
      const P mid = wadd(s, l), end = wadd(s, wadd(l, l));
      hit = (loc >= s && lq <= mid) || (loc >= mid && lq <= end);
    }
    const unsigned m = __ballot_sync(kFull, hit);
    if (m) {
      gi = static_cast<int>(base + __ffs(m) - 1);
      found = 1;
      break;
    }
  }
  const P gs = start[gi], gl = slen[gi];
  const P gmid = wadd(gs, gl), gend = wadd(gs, wadd(gl, gl));
  Located<P> r;
  r.gi = gi;
  r.found = found;
  r.strand = found && loc >= gmid && lq <= gend;
  r.off = r.strand ? wsub(wsub(gend, loc), ql) : wsub(loc, gs);
  r.loc_fwd = r.strand ? wadd(r.off, gs) : loc;
  const P top = static_cast<P>(a.n - 1);
  const P safe = found ? r.loc_fwd : P(0);
  r.safe = safe < P(0) ? P(0) : (safe > top ? top : safe);
  return r;
}

// grid (B, chunks of kWindowThreads words): every CTA of a read locates it
// (a scan of the contig table by its first warp), the CTA of chunk 0
// writes the read's outputs, and each thread realigns one 16-base word of
// the window: lo = w >> 2o | (o ? w' << (32 - 2o) : 0), positions past
// n - 2 ('$' and beyond) become 5, and copies the read's 16 codes on its
// strand
template <typename P>
__global__ void __launch_bounds__(kWindowThreads)
locate_window_kernel(const LocateArgs a) {
  __shared__ P sh_safe;
  __shared__ int sh_strand;
  const long long b = blockIdx.x;
  const long long nw = a.L >> 4;
  if (a.stage == kStageWindow) {
    if (threadIdx.x == 0) {
      sh_safe = static_cast<const P*>(a.safe_loc)[b];
      sh_strand = a.strand[b] != 0;
    }
  } else if (threadIdx.x < 32) {
    const Located<P> r = locate<P>(a, b);
    if (threadIdx.x == 0) {
      sh_safe = r.safe;
      sh_strand = r.strand;
      if (blockIdx.y == 0) {
        a.found[b] = static_cast<unsigned char>(r.found);
        a.gi[b] = r.gi;
        a.strand[b] = static_cast<unsigned char>(r.strand);
        static_cast<P*>(a.off)[b] = r.off;
        static_cast<P*>(a.loc_fwd)[b] = r.loc_fwd;
        static_cast<P*>(a.safe_loc)[b] = r.safe;
      }
    }
  }
  __syncthreads();
  const long long k = blockIdx.y * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  const P safe = sh_safe;                      // in [0, n - 1]
  const long long w0 = static_cast<long long>(safe >> 4);
  const int o = static_cast<int>(safe & 15);
  const long long wrow = b * (nw + 1);
  if (a.stage == kStageLocate) {
    if (k <= nw) a.widx[wrow + k] = clamp_ll(w0 + k, 0, a.ntext - 1);
    return;
  }
  if (k >= nw) return;
  unsigned lo, hi;
  if (a.stage == kStageAll) {
    lo = static_cast<unsigned>(a.text[clamp_ll(w0 + k, 0, a.ntext - 1)]);
    hi = static_cast<unsigned>(a.text[clamp_ll(w0 + k + 1, 0,
                                               a.ntext - 1)]);
  } else {
    lo = static_cast<unsigned>(a.text[wrow + k]);
    hi = static_cast<unsigned>(a.text[wrow + k + 1]);
  }
  // a shift by 32 is undefined: o == 0 takes no bits of the next word
  const unsigned w = (lo >> (2 * o)) | (o ? hi << (32 - 2 * o) : 0u);
  const long long p0 = static_cast<long long>(safe) + 16 * k;
  const long long last = a.n - 1;
  uint4 tv;
  unsigned char* tb = reinterpret_cast<unsigned char*>(&tv);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    tb[i] = p0 + i >= last ? 5 : static_cast<unsigned char>(
                                     (w >> (2 * i)) & 3u);
  }
  const long long at = b * a.L + 16 * k;
  *reinterpret_cast<uint4*>(a.t + at) = tv;
  const signed char* src = sh_strand ? a.codes_rc : a.codes;
  *reinterpret_cast<uint4*>(a.q + at) =
      *reinterpret_cast<const uint4*>(src + at);
}

// ------------------------------------------------ the gact walk's setup

// Thread b < B writes lane b's walk state (i = j = its walk length, done
// when that is 0 or less; from lane_out, which writes the lane's values
// for the pack, where the lanes' inputs are given), threads B .. B + 2
// zero the shared words (the write pointer, the saturated count, the CTA
// ticket), and the grid fills the run buffer with pad pairs in 16-byte
// stores in a grid-stride loop (buf is 16-aligned).  lrm_gact_setup gives
// every lane and shared word its own thread: the same items in a
// grid-stride loop cost the 50 kb setup 0.39 us more alone on an H100.
// EB is the entry's bytes: a pair of int16 pads is one 32-bit word, a
// pair of int32 pads two.  A gact step launches this kernel once, so a
// trace counts the step's entry width by its instantiation.
template <int EB>
__global__ void __launch_bounds__(kLanesThreads)
lanes_kernel(const SetupArgs a) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * blockDim.x;
  if (t < a.B) {
    const int len = a.lanes.lens[t];
    const int n = a.lanes.wcol ? lane_out(a.lanes, t, len) : len;
    a.st[t] = n;
    a.st[a.B + t] = n;
    a.st[2 * a.B + t] = n <= 0;
  } else if (t < a.B + 3) {
    a.st[2 * a.B + t] = 0;                     // st[3B + t - B]
  }
  // a pair a word (EB 2) or two (EB 4)
  const long long words = a.B * a.n_rows * (EB / 2);
  constexpr unsigned kFill = EB == 2 ? kPadPair : 3u;
  const long long vecs = words >> 2;
  uint4* b4 = reinterpret_cast<uint4*>(a.buf);
  for (long long k = t; k < vecs; k += nt) {
    b4[k] = make_uint4(kFill, kFill, kFill, kFill);
  }
  for (long long k = 4 * vecs + t; k < words; k += nt) a.buf[k] = kFill;
}

// -------------------------------------------------------------- the pack

// The pack's shared-memory image of a row: the meta words (mb bytes), then
// the compact row of entries (K = eb R bytes: the entries that are not
// pads in path order, then the pads in theirs), with 16 bytes to spare for
// the copy's reads past the end.  The blob row is the image's first mb +
// head bytes, the tail row the rest.  A slot is 16 bytes of the runs from
// a 16-aligned address, so a row that starts d entries past one has
// ceil((R + d) / epv) slots, at most slots_max.
__host__ __device__ __forceinline__ int pack_slots_max(int R, int eb) {
  const int epv = 16 / eb;
  return (R + 2 * epv - 2) / epv;
}

__host__ __device__ __forceinline__ int pack_image_bytes(int slots, int mb) {
  return (mb + 16 * slots + 16 + 15) & ~15;
}

// rows of at most this many slots run a warp a row, kPackRowsCta a CTA
constexpr int kPackWarpSlots = 32 * kPackSlots;
// a CTA-a-row's tile: rows of more slots go through it in tiles
constexpr int kPackTileSlots = kPackThreads * kPackSlots;

// the meta word i of read b: [best, (best hi), found, gi, strand, off,
// (off hi), ed, limit, overflow], the words in brackets under pos64 only.
// Every lane loads every field (one address for the warp: broadcast
// loads, all in flight at once) and selects its word, so no lane waits
// on a branch of its own.
__device__ __forceinline__ unsigned meta_word(const PackArgs& a, int b,
                                              int i) {
  const unsigned long long best = static_cast<unsigned long long>(
      a.best64 ? static_cast<const long long*>(a.best)[b]
               : static_cast<long long>(static_cast<const int*>(a.best)[b]));
  const unsigned long long off = static_cast<unsigned long long>(
      a.off64 ? static_cast<const long long*>(a.off)[b]
              : static_cast<long long>(static_cast<const int*>(a.off)[b]));
  const unsigned found = a.found[b] != 0, strand = a.strand[b] != 0;
  const unsigned gi = static_cast<unsigned>(a.gi[b]);
  const int ed_raw = a.ed_raw[b], lim = a.limit[b];
  const bool short_band = a.band_short[b] != 0;
  const unsigned ovf = static_cast<unsigned>(a.overflow[b])
                       | (a.saturated && *a.saturated ? 2u : 0u);
  const unsigned ed = static_cast<unsigned>(
      ed_raw <= lim && !short_band ? ed_raw : -1);
  const int f = a.pos64 || i == 0 ? i : (i <= 4 ? i + 1 : i + 2);
  const unsigned lo = f == 0 ? static_cast<unsigned>(best)
                    : f == 1 ? static_cast<unsigned>(best >> 32)
                    : f == 2 ? found : f == 3 ? gi : strand;
  const unsigned hi = f == 5 ? static_cast<unsigned>(off)
                    : f == 6 ? static_cast<unsigned>(off >> 32)
                    : f == 7 ? ed : f == 8 ? static_cast<unsigned>(lim)
                    : ovf;
  return f < 5 ? lo : hi;
}

// slot `slot` of a row whose 16-aligned start is base16 and whose entry 0
// lies d entries into it: the 16 bytes in v, the entries of the row's [0,
// R) that it holds as the returned bit mask (a 16-byte load where it holds
// a whole slot of them, else one load an entry)
template <int EB>
__device__ __forceinline__ unsigned load_slot(const unsigned char* base16,
                                              int slot, int d, int R,
                                              uint4& v) {
  constexpr int kEpv = 16 / EB;
  const int i0 = slot * kEpv - d;
  const unsigned char* p = base16 + 16 * slot;
  if (i0 >= 0 && i0 + kEpv <= R) {
    v = *reinterpret_cast<const uint4*>(p);
    return (1u << kEpv) - 1;
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
  unsigned present = 0;
#pragma unroll
  for (int k = 0; k < kEpv; ++k) {
    if (i0 + k >= 0 && i0 + k < R) {
      const unsigned e = EB == 2
          ? *reinterpret_cast<const unsigned short*>(p + 2 * k)
          : *reinterpret_cast<const unsigned*>(p + 4 * k);
      w[(k * EB) >> 2] |= e << (8 * ((k * EB) & 3));
      present |= 1u << k;
    }
  }
  v = make_uint4(w[0], w[1], w[2], w[3]);
  return present;
}

// entry k (of 16 / EB) of a slot, as its EB bytes
template <int EB>
__device__ __forceinline__ unsigned slot_entry(const uint4& v, int k) {
  const unsigned w = (k * EB >> 2) == 0 ? v.x : (k * EB >> 2) == 1 ? v.y
                     : (k * EB >> 2) == 2 ? v.z : v.w;
  return EB == 2 ? (w >> (16 * (k & 1))) & 0xffffu : w;
}

// the mask of a slot's entries whose op is not the pad (3)
template <int EB>
__device__ __forceinline__ unsigned real_mask(const uint4& v) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 16 / EB; ++k) {
    m |= ((slot_entry<EB>(v, k) & 3u) != 3u ? 1u : 0u) << k;
  }
  return m;
}

__device__ __forceinline__ int warp_inclusive(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    x += lane >= o ? y : 0;
  }
  return x;
}

// the exclusive prefix sum of x over the warp (kWarp) or the CTA, and the
// group's total; every thread of the group calls it.  The CTA's form reads
// sh (32 ints) after its second barrier: the caller puts a barrier
// between two calls.
template <bool kWarp>
__device__ __forceinline__ int group_scan(int x, int& total, int* sh) {
  const int lane = threadIdx.x & 31;
  const int inc = warp_inclusive(x, lane);
  if (kWarp) {
    total = __shfl_sync(kFull, inc, 31);
    return inc - x;
  }
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_inclusive(lane < warps ? sh[lane] : 0, lane);
    if (lane < warps) sh[lane] = w;
  }
  __syncthreads();
  total = sh[warps - 1];
  return (warp ? sh[warp - 1] : 0) + inc - x;
}

template <bool kWarp>
__device__ __forceinline__ void group_sync() {
  if (kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// 4 bytes of shared memory from byte `at` of the 16-aligned sb on, at any
// alignment: two aligned words and a funnel shift
__device__ __forceinline__ unsigned sm_word(const unsigned char* sb,
                                            int at) {
  const unsigned* w = reinterpret_cast<const unsigned*>(sb) + (at >> 2);
  return __funnelshift_r(w[0], w[1], 8 * (at & 3));
}

// dst[0, n) = sb[at, at + n) by the group's nt threads (t is the caller's
// rank): 16-byte stores from dst's first 16-aligned byte on, and the
// edges before and after by the widest store their alignment allows (8,
// 4 or 2 bytes: every address and length here is even)
__device__ __forceinline__ void copy_edge(signed char* dst,
                                          const unsigned char* sb, int at,
                                          int n) {
  for (int p = 0; p < n;) {
    const unsigned ad = static_cast<unsigned>(
        reinterpret_cast<unsigned long long>(dst + p));
    if ((ad & 7) == 0 && n - p >= 8) {
      *reinterpret_cast<uint2*>(dst + p) =
          make_uint2(sm_word(sb, at + p), sm_word(sb, at + p + 4));
      p += 8;
    } else if ((ad & 3) == 0 && n - p >= 4) {
      *reinterpret_cast<unsigned*>(dst + p) = sm_word(sb, at + p);
      p += 4;
    } else {
      *reinterpret_cast<unsigned short*>(dst + p) =
          static_cast<unsigned short>(sm_word(sb, at + p));
      p += 2;
    }
  }
}

__device__ __forceinline__ void copy_out(signed char* dst,
                                         const unsigned char* sb, int at,
                                         int n, int t, int nt) {
  if (n <= 0) return;
  const int mis = static_cast<int>(
      reinterpret_cast<unsigned long long>(dst) & 15);
  const int pre = min((16 - mis) & 15, n);
  const int body = (n - pre) >> 4;
  for (int k = t; k < body; k += nt) {
    const int s = at + pre + 16 * k;
    *reinterpret_cast<uint4*>(dst + pre + 16 * k) =
        make_uint4(sm_word(sb, s), sm_word(sb, s + 4), sm_word(sb, s + 8),
                   sm_word(sb, s + 12));
  }
  if (t == 0) copy_edge(dst, sb, at, pre);
  if (t == nt - 1) {
    const int done = pre + 16 * body;
    copy_edge(dst + done, sb, at + done, n - done);
  }
}

// The pack of read b by a group (a warp, kWarp, or the CTA) of nt threads:
// the meta words, then the row's entries that are not pads (op 3) first in
// path order and the pads after them in theirs, as a stable sort on the
// pad flag; the blob row (meta words, then the compact row's first head
// bytes) and the tail row (the rest).  Thread t takes V consecutive slots
// of a tile of nt V slots; the group's scan of each thread's entries that
// are not pads ranks them, and the pads after them: a pad's rank among
// the tile's pads is its index in the tile less the tile's entries that
// are not pads before it.  A row of one tile (every row up to
// kPackTileSlots slots) is read once, its image built whole and written
// out; a longer row is counted first (its entries that are not pads, the
// pads' base), then each tile staged, its two runs (those that are not
// pads, the pads) written to their places in the blob and the tail.
template <int EB, bool kWarp>
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const PackArgs a) {
  extern __shared__ __align__(16) unsigned char pack_smem[];
  __shared__ int sh_scan[32];
  constexpr int kEpv = 16 / EB;
  const int t = kWarp ? threadIdx.x & 31 : threadIdx.x;
  const int nt = kWarp ? 32 : blockDim.x;
  const int R = static_cast<int>(a.R), head = static_cast<int>(a.head);
  const int mb = a.pos64 ? 40 : 32, K = EB * R;
  const int b = kWarp ? blockIdx.x * kPackRowsCta + (threadIdx.x >> 5)
                      : blockIdx.x;
  if (b >= a.B) return;                            // a whole warp (kWarp)
  unsigned char* sm = pack_smem + (kWarp ? (threadIdx.x >> 5)
      * pack_image_bytes(pack_slots_max(R, EB), mb) : 0);
  const size_t rb = b;
  const unsigned char* row =
      static_cast<const unsigned char*>(a.runs) + rb * K;
  signed char* brow = a.blob + rb * (mb + head);
  signed char* trow = a.tail + rb * (K - head);
  // in flight with the row's loads; stored before the first barrier
  const unsigned meta = meta_word(a, b, min(t, mb / 4 - 1));
  const int d = static_cast<int>(
      reinterpret_cast<unsigned long long>(row) & 15) / EB;
  const unsigned char* base16 = row - EB * d;
  const int S = (R + d + kEpv - 1) / kEpv;
  const bool whole = S <= nt * kPackSlots;
  const int V = whole ? (S + nt - 1) / nt : kPackSlots;
  unsigned char* stage = sm + mb;
  int n_real = 0;
  if (!whole) {                                    // the count pass
    int mine = 0;
    for (int s0 = 0; s0 < S; s0 += nt * V) {
#pragma unroll
      for (int v = 0; v < kPackSlots; ++v) {
        uint4 x;
        const unsigned present = load_slot<EB>(base16, s0 + t * V + v, d,
                                               R, x);
        mine += __popc(real_mask<EB>(x) & present);
      }
    }
    group_scan<kWarp>(mine, n_real, sh_scan);
    group_sync<kWarp>();
  }
  int r_before = 0;                  // the row's reals before the tile
  for (int s0 = 0; s0 < S; s0 += nt * V) {
    uint4 x[kPackSlots];
    unsigned present[kPackSlots], real[kPackSlots];
    int mine = 0;
#pragma unroll
    for (int v = 0; v < kPackSlots; ++v) {
      present[v] = v < V ? load_slot<EB>(base16, s0 + t * V + v, d, R, x[v])
                         : 0u;
      real[v] = v < V ? real_mask<EB>(x[v]) & present[v] : 0u;
      mine += __popc(real[v]);
    }
    int n_tile;                      // the tile's entries that are not pads
    int lr = group_scan<kWarp>(mine, n_tile, sh_scan);
    const int e0 = max(0, s0 * kEpv - d);          // the tile's first entry
    const int e1 = min(R, (s0 + nt * V) * kEpv - d);
#pragma unroll
    for (int v = 0; v < kPackSlots; ++v) {
      const int i0 = (s0 + t * V + v) * kEpv - d;
#pragma unroll
      for (int k = 0; k < kEpv; ++k) {
        if (present[v] >> k & 1u) {
          const bool r = real[v] >> k & 1u;
          const int at = r ? lr : n_tile + (i0 + k - e0) - lr;
          const unsigned e = slot_entry<EB>(x[v], k);
          if (EB == 2) {
            reinterpret_cast<unsigned short*>(stage)[at] =
                static_cast<unsigned short>(e);
          } else {
            reinterpret_cast<unsigned*>(stage)[at] = e;
          }
          lr += r;
        }
      }
    }
    if (s0 == 0 && t < mb / 4) reinterpret_cast<unsigned*>(sm)[t] = meta;
    group_sync<kWarp>();
    if (whole) {
      copy_out(brow, sm, 0, mb + head, t, nt);
      copy_out(trow, sm, mb + head, K - head, t, nt);
    } else {
      if (s0 == 0) copy_out(brow, sm, 0, mb, t, nt);
      // the tile's two runs: [x, x + n) of the compact row from stage byte
      // at; its bytes below head go to the blob row, the rest to the tail
      const int runs[2][3] = {
          {EB * r_before, EB * n_tile, 0},
          {EB * (n_real + e0 - r_before), EB * (e1 - e0 - n_tile),
           EB * n_tile}};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int x0 = runs[q][0], x1 = x0 + runs[q][1];
        const int at = mb + runs[q][2];
        const int split = min(max(head, x0), x1);
        copy_out(brow + mb + x0, sm, at, split - x0, t, nt);
        copy_out(trow + (split - head), sm, at + split - x0, x1 - split, t,
                 nt);
      }
      r_before += n_tile;
      group_sync<kWarp>();           // the next tile overwrites the stage
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

}  // namespace

extern "C" int lrm_encode(const EncodeArgs* args, void* stream) {
  const EncodeArgs a = *args;
  // in-row indices are 32-bit (j + L0 < 2 L)
  if (a.B <= 0 || a.B > 0x7FFFFFFFLL || a.L <= 0 || a.L > (1LL << 30)
      || a.lens == nullptr) {
    return -1;
  }
  const long long chunks = (a.L + 16LL * kEncodeThreads - 1)
                           / (16LL * kEncodeThreads);
  if (chunks > 65535) return -1;
  const dim3 grid(static_cast<unsigned>(a.B), static_cast<unsigned>(chunks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.L % 16 == 0 && aligned16(a.raw) && aligned16(a.codes)
      && aligned16(a.codes_rc)) {
    encode_kernel<true><<<grid, kEncodeThreads, 0, st>>>(a);
  } else {
    encode_kernel<false><<<grid, kEncodeThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

extern "C" int lrm_locate_window(const LocateArgs* args, void* stream) {
  const LocateArgs a = *args;
  const long long chunks = ((a.L >> 4) + 1 + kWindowThreads - 1)
                           / kWindowThreads;
  if (a.B <= 0 || a.B > 0x7FFFFFFFLL || a.L <= 0 || a.L % 16 != 0
      || a.M <= 0 || a.n <= 0 || a.ntext <= 0 || chunks > 65535
      || a.stage < kStageAll || a.stage > kStageWindow) {
    return -1;
  }
  if (a.stage != kStageLocate
      && !(aligned16(a.codes) && aligned16(a.codes_rc) && aligned16(a.q)
           && aligned16(a.t))) {
    return -1;
  }
  const dim3 grid(static_cast<unsigned>(a.B), static_cast<unsigned>(chunks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.p64) {
    locate_window_kernel<long long><<<grid, kWindowThreads, 0, st>>>(a);
  } else {
    locate_window_kernel<int><<<grid, kWindowThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

// The gact walk's setup: -1 for arguments it does not take (buf not
// 16-aligned, lanes whose B is not the setup's).
extern "C" int lrm_gact_setup(const SetupArgs* args, void* stream) {
  const SetupArgs a = *args;
  if (a.B <= 0 || a.B > 0x7FFFFFFFLL || a.n_rows <= 0 || a.lanes.B != a.B
      || a.lanes.L < 0 || !aligned16(a.buf) || (a.eb != 2 && a.eb != 4)) {
    return -1;
  }
  // a thread for each lane and shared word; the fill's blocks capped at
  // 4096 (it strides past them)
  const long long lane_blocks = (a.B + 3 + kLanesThreads - 1) / kLanesThreads;
  long long blocks = (a.B * a.n_rows * (a.eb / 2) / 4 + kLanesThreads - 1)
                     / kLanesThreads;
  blocks = blocks < 4096 ? blocks : 4096;
  blocks = blocks > lane_blocks ? blocks : lane_blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.eb == 2) {
    lanes_kernel<2><<<static_cast<unsigned>(blocks), kLanesThreads, 0, st>>>(
        a);
  } else {
    lanes_kernel<4><<<static_cast<unsigned>(blocks), kLanesThreads, 0, st>>>(
        a);
  }
  return cudaGetLastError();
}

extern "C" int lrm_pack(const PackArgs* args, void* stream) {
  const PackArgs a = *args;
  const unsigned long long odd =
      reinterpret_cast<unsigned long long>(a.blob)
      | reinterpret_cast<unsigned long long>(a.tail);
  // in-row offsets are 32-bit; the blob and tail rows' stores 2-aligned,
  // each run entry aligned to its size
  if (a.B <= 0 || a.B > 0x7FFFFFFFLL || a.R <= 0
      || (a.eb != 2 && a.eb != 4) || a.eb * a.R > (1LL << 30)
      || a.head < 0 || a.head > a.eb * a.R || a.head % a.eb != 0
      || (odd & 1) || reinterpret_cast<unsigned long long>(a.runs) % a.eb) {
    return -1;
  }
  const int R = static_cast<int>(a.R), eb = static_cast<int>(a.eb);
  const int mb = a.pos64 ? 40 : 32;
  const int slots = pack_slots_max(R, eb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slots <= kPackWarpSlots) {
    const long long ctas = (a.B + kPackRowsCta - 1) / kPackRowsCta;
    const size_t smem = kPackRowsCta * pack_image_bytes(slots, mb);
    if (eb == 2) {
      pack_kernel<2, true><<<static_cast<unsigned>(ctas), 32 * kPackRowsCta,
                             smem, st>>>(a);
    } else {
      pack_kernel<4, true><<<static_cast<unsigned>(ctas), 32 * kPackRowsCta,
                             smem, st>>>(a);
    }
  } else {
    const int threads = min(kPackThreads, (slots + 31) / 32 * 32);
    const size_t smem = pack_image_bytes(min(slots, kPackTileSlots), mb);
    if (eb == 2) {
      pack_kernel<2, false><<<static_cast<unsigned>(a.B), threads, smem,
                              st>>>(a);
    } else {
      pack_kernel<4, false><<<static_cast<unsigned>(a.B), threads, smem,
                              st>>>(a);
    }
  }
  return cudaGetLastError();
}
