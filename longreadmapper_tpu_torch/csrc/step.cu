// The mapping step's glue for Hopper (sm_90a): the four small stages around
// the banded DP and the CIGAR walks, one launch each.
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
//   lanes_kernel          the walk's inputs: ed from the DP's centre column,
//                         the narrow pass's band-short flag (overflow bit
//                         2), the lanes that walk (:907-909, 975-977, 989)
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
// designs are one pass each, with the work laid out for coalesced access:
// a thread a base (encode); a thread 16 bases, one packed text word and a
// 16-byte store each of q and t (window), after one warp a read has
// scanned the contig table with a ballot; a thread a read (lanes); a CTA a
// read (pack: its warps split the row of run entries; a first pass counts
// each warp's entries that are not pads, a prefix over the warps' counts
// places each warp's share, a second pass writes each entry at its rank,
// a ballot/popc prefix over 32 entries at a time).  The pack had first
// been a warp a read: at 50 kb (40 reads of 10,456 entries) that is 40
// warps on the card and took 0.22 ms of the step.

#include <cuda_runtime.h>

// The C entries' argument blocks, ops/step.py's ctypes Structures: every
// field 8 bytes.  Outside the anonymous namespace, or the C entries that
// take them would not be exported.

struct EncodeArgs {
  const unsigned char* raw;   // (B, L) ASCII
  signed char* codes;         // (B, L)
  signed char* codes_rc;      // (B, L)
  long long B, L, L0;
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

struct LanesArgs {
  const short* wcol;             // (L + 1, B): the DP's centre column
  const int* lens;               // (B,)
  const int* limit;              // (B,)
  const unsigned char* found;    // (B,) bool
  const unsigned char* ovf_in;   // (B,) bool: the seed vote's overflow
  int* ed_raw;                   // (B,)
  unsigned char* band_short;     // (B,) bool
  int* overflow;                 // (B,): ovf_in | 4 * band_short
  int* lens_tb;                  // (B,): the walk's lengths, 0 = no walk
  long long B, L, Wp, narrow;
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
constexpr int kEncodeThreads = 256;
constexpr int kWindowThreads = 128;   // a thread a 16-base word of a read
constexpr int kLanesThreads = 256;
constexpr int kPackEntries = 256;     // a warp's share of a row, at least

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

// codes_rc is the flipped complement rolled left by L - L0: the read's
// L0 bases front-aligned, then the row's other bytes (pads or not) in
// reverse order
__global__ void encode_kernel(const EncodeArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= a.B * a.L) return;
  const long long j = i % a.L;
  const long long row = i - j;
  const long long src = j < a.L0 ? a.L0 - 1 - j : a.L - 1 - (j - a.L0);
  a.codes[i] = static_cast<signed char>(base_code(a.raw[i]));
  a.codes_rc[i] = static_cast<signed char>(
      complement(base_code(a.raw[row + src])));
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

// ------------------------------------------------------------- the lanes

__global__ void lanes_kernel(const LanesArgs a) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (b >= a.B) return;
  const int len = a.lens[b];
  const int ed = a.wcol[clamp_ll(len, 0, a.L) * a.B + b];
  const int lim = a.limit[b];
  const bool found = a.found[b] != 0;
  const bool bs = a.narrow && found && ed >= a.Wp && lim >= a.Wp;
  a.ed_raw[b] = ed;
  a.band_short[b] = bs;
  a.overflow[b] = (a.ovf_in[b] != 0 ? 1 : 0) | (bs ? 4 : 0);
  a.lens_tb[b] = found && ed <= lim && !bs ? len : 0;
}

// -------------------------------------------------------------- the pack

__device__ __forceinline__ void put_bytes(signed char* dst, unsigned v,
                                          int n) {
  for (int i = 0; i < n; ++i) {
    dst[i] = static_cast<signed char>((v >> (8 * i)) & 0xffu);
  }
}

// a CTA a read of as many warps as the row has kPackEntries entries (1 to
// 32): thread 0 writes the meta words; then the entries whose op is not the
// pad (3) go first in path order and the pads after them in theirs, as a
// stable sort on the pad flag, each written to the blob's head or to the
// tail by its byte offset.  Warp w takes the row's w-th segment of `seg`
// entries (a multiple of 32): its entries that are not pads go after those
// of the warps before it, its pads after every entry that is not a pad and
// the pads of the warps before it.
__global__ void __launch_bounds__(1024)
pack_kernel(const PackArgs a) {
  __shared__ int sh_real[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long b = blockIdx.x;
  const long long mb = a.pos64 ? 40 : 32;
  const long long K = a.eb * a.R;
  signed char* row = a.blob + b * (mb + a.head);
  signed char* trow = a.tail + b * (K - a.head);
  if (threadIdx.x == 0) {
    const long long best = a.best64
        ? static_cast<const long long*>(a.best)[b]
        : static_cast<const int*>(a.best)[b];
    const long long off = a.off64 ? static_cast<const long long*>(a.off)[b]
                                  : static_cast<const int*>(a.off)[b];
    const int ed_raw = a.ed_raw[b], lim = a.limit[b];
    const int ed = ed_raw <= lim && !a.band_short[b] ? ed_raw : -1;
    const int ovf = a.overflow[b] | (a.saturated && *a.saturated ? 2 : 0);
    const unsigned long long ub = static_cast<unsigned long long>(best);
    const unsigned long long uo = static_cast<unsigned long long>(off);
    unsigned w[10];
    int k = 0;
    w[k++] = static_cast<unsigned>(ub);
    if (a.pos64) w[k++] = static_cast<unsigned>(ub >> 32);
    w[k++] = a.found[b] != 0;
    w[k++] = static_cast<unsigned>(a.gi[b]);
    w[k++] = a.strand[b] != 0;
    w[k++] = static_cast<unsigned>(uo);
    if (a.pos64) w[k++] = static_cast<unsigned>(uo >> 32);
    w[k++] = static_cast<unsigned>(ed);
    w[k++] = static_cast<unsigned>(lim);
    w[k++] = static_cast<unsigned>(ovf);
    for (int i = 0; i < k; ++i) put_bytes(row + 4 * i, w[i], 4);
  }
  const short* r16 = static_cast<const short*>(a.runs) + b * a.R;
  const int* r32 = static_cast<const int*>(a.runs) + b * a.R;
  const long long seg = ((a.R + warps - 1) / warps + 31) / 32 * 32;
  const long long lo = warp * seg < a.R ? warp * seg : a.R;
  const long long hi = lo + seg < a.R ? lo + seg : a.R;
  int n = 0;
  for (long long base = lo; base < hi; base += 32) {
    const long long j = base + lane;
    const int e = j < hi ? (a.eb == 2 ? r16[j] : r32[j]) : 3;
    n += __popc(__ballot_sync(kFull, (e & 3) != 3));
  }
  if (lane == 0) sh_real[warp] = n;
  __syncthreads();
  long long before = 0, n_real = 0;
  for (int v = 0; v < warps; ++v) {
    before += v < warp ? sh_real[v] : 0;
    n_real += sh_real[v];
  }
  const unsigned below = (1u << lane) - 1u;
  long long at_real = before, at_pad = n_real + (lo - before);
  for (long long base = lo; base < hi; base += 32) {
    const long long j = base + lane;
    const bool valid = j < hi;
    const int e = valid ? (a.eb == 2 ? r16[j] : r32[j]) : 3;
    const bool pad = (e & 3) == 3;
    const unsigned m_real = __ballot_sync(kFull, valid && !pad);
    const unsigned m_pad = __ballot_sync(kFull, valid && pad);
    if (valid) {
      const long long p = pad ? at_pad + __popc(m_pad & below)
                              : at_real + __popc(m_real & below);
      const long long byte = p * a.eb;
      signed char* dst = byte < a.head ? row + mb + byte
                                       : trow + (byte - a.head);
      put_bytes(dst, static_cast<unsigned>(e), static_cast<int>(a.eb));
    }
    at_real += __popc(m_real);
    at_pad += __popc(m_pad);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

}  // namespace

extern "C" int lrm_encode(const EncodeArgs* args, void* stream) {
  const EncodeArgs a = *args;
  if (a.B <= 0 || a.L <= 0 || a.L0 < 0 || a.L0 > a.L
      || a.B * a.L > 0x7FFFFFFFLL * kEncodeThreads) {
    return -1;
  }
  const long long blocks = (a.B * a.L + kEncodeThreads - 1) / kEncodeThreads;
  encode_kernel<<<static_cast<unsigned>(blocks), kEncodeThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
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

extern "C" int lrm_lanes(const LanesArgs* args, void* stream) {
  const LanesArgs a = *args;
  if (a.B <= 0 || a.B > 0x7FFFFFFFLL || a.L < 0) return -1;
  const long long blocks = (a.B + kLanesThreads - 1) / kLanesThreads;
  lanes_kernel<<<static_cast<unsigned>(blocks), kLanesThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int lrm_pack(const PackArgs* args, void* stream) {
  const PackArgs a = *args;
  if (a.B <= 0 || a.B > 0x7FFFFFFFLL || a.R <= 0
      || (a.eb != 2 && a.eb != 4) || a.head < 0 || a.head > a.eb * a.R
      || a.head % a.eb != 0) {
    return -1;
  }
  long long warps = (a.R + kPackEntries - 1) / kPackEntries;
  warps = warps < 1 ? 1 : (warps > 32 ? 32 : warps);
  pack_kernel<<<static_cast<unsigned>(a.B), static_cast<unsigned>(32 * warps),
                0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
