// A lane's walk inputs (G3 of the step glue), as one device function that
// the kernels which need them call where they need them: walk_c_kernel
// (csrc/walk.cu) for the walk length and lanes_kernel (the gact walk's
// setup, csrc/step.cu) for the walk state.  Neither is a pass of its own:
// each value is a function of the read's entry in the DP's centre column
// and four per-read values.  Each also writes the lane's ed', band-short
// flag and overflow word (lane_out) for pack_kernel's meta words: the
// pack computing them itself, a load behind the read's length, took
// 0.3-0.35 us more alone on an H100 than reading them.
//
// Replaces no pallas_call: JAX computes these in its jitted step
// (longreadmapper_tpu/mapping/pipeline.py:896-910 on the gact path,
// :972-977 on the resident path, :989 ed_raw).  Contract:
// ops/step.py::lanes_plain, bit for bit, with the read's length clamped to
// [0, L] for the column read (lanes_plain indexes the column with it;
// every length the step hands over is in range).
#pragma once

// The inputs, every field 8 bytes (ops/step.py::LanesIn).  Outside any
// anonymous namespace: the C entries' argument blocks embed it.
struct LanesIn {
  const short* wcol;             // (L + 1, B): the DP's centre column; null:
                                 // no lanes (a consumer takes given lengths)
  const int* lens;               // (B,)
  const int* limit;              // (B,)
  const unsigned char* found;    // (B,) bool
  const unsigned char* ovf_in;   // (B,) bool: the seed vote's overflow
  int* ed_raw;                   // (B,) lane_out's: ed'
  unsigned char* band_short;     // (B,) bool
  int* overflow;                 // (B,) ovf_in | 4 * band_short
  long long B, L, Wp, narrow;
};

struct Lane {
  int ed_raw;                    // ed': the centre column at the length
  int band_short;                // the narrow pass cannot certify ed'
  int overflow;                  // ovf_in | 4 * band_short
  int walk_len;                  // the walk's length, 0: no walk
};

// Lane b of length len (a.lens[b]).  Narrow pass: values below Wp are
// exact; a lane whose ed' reaches Wp while its limit does too flags bit 2
// for the full-band retry and skips its walk.  Unmapped and over-limit
// lanes (CIGAR '*') skip theirs.
__device__ __forceinline__ Lane lane_of(const LanesIn& a, long long b,
                                        int len) {
  const long long row = len < 0 ? 0 : (len > a.L ? a.L : len);
  const int ed = a.wcol[row * a.B + b];
  const int lim = a.limit[b];
  const bool found = a.found[b] != 0;
  const bool short_band = a.narrow && found && ed >= a.Wp && lim >= a.Wp;
  Lane r;
  r.ed_raw = ed;
  r.band_short = short_band;
  r.overflow = (a.ovf_in[b] != 0 ? 1 : 0) | (short_band ? 4 : 0);
  r.walk_len = found && ed <= lim && !short_band ? len : 0;
  return r;
}

// lane_of(a, b, len), its ed', band-short flag and overflow word written
// to a's outputs; returns its walk length
__device__ __forceinline__ int lane_out(const LanesIn& a, long long b,
                                        int len) {
  const Lane r = lane_of(a, b, len);
  a.ed_raw[b] = r.ed_raw;
  a.band_short[b] = static_cast<unsigned char>(r.band_short);
  a.overflow[b] = r.overflow;
  return r.walk_len;
}
