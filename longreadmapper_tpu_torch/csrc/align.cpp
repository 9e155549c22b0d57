// Banded global (NW) unit-cost alignment on the host: the port's copy of
// longreadmapper_tpu/native/align.cpp (same algorithm, same C entry
// points), built with g++ by longreadmapper_tpu_torch/native_build.py and
// loaded by longreadmapper_tpu_torch/native.py (`traceback`,
// `banded_align`, and the window path of `myers_align`).
//
// It realizes the observable contract of the reference's GACT aligner:
// align a read against a reference window, produce run-length CIGAR ops
// covering the read and the edit distance.  `lrm_traceback` walks a
// precomputed banded score matrix H back to a CIGAR (the matrix of
// ops/wavefront.py::banded_nw_scores); `lrm_banded_align` fills H itself.
//
// Band coordinates: H has rows 0..qlen and `band` columns; column d encodes
// diagonal j - i + W (W = half band width). Cells outside the band hold INF.
// Tie-break order is M > I > D (diagonal first), the order of the device
// walks and of the JAX package.
//
// Exported C ABI (ctypes, native.py):
//   lrm_traceback(H, band, W, q, t, qlen, tlen, ops_out, len_out, max_ops)
//     -> n_ops, or -1 when no in-band path exists
//   lrm_banded_align(q, qlen, t, tlen, W, ops_out, len_out, max_ops, ed_out)
//     -> n_ops; *ed_out = edit distance, -1 when out of band

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {
const int16_t INF16 = 0x3FFF;
}

extern "C" {

// Traceback over a precomputed banded H (int16, rows=(qlen+1) x band).
// Writes run-length ops into ops_out ('M','I','D' bytes) / len_out.
// Returns the number of ops, or -1 if no in-band path exists.
int32_t lrm_traceback(const int16_t* H, int32_t band, int32_t W,
                      const uint8_t* q, const uint8_t* t, int32_t qlen,
                      int32_t tlen, uint8_t* ops_out, int32_t* len_out,
                      int32_t max_ops) {
  int32_t i = qlen, j = tlen;
  int32_t d = j - i + W;
  if (d < 0 || d >= band) return -1;
  if (H[i * band + d] >= INF16) return -1;

  // Emit ops back-to-front into a scratch, then run-length encode reversed.
  std::vector<uint8_t> rev;
  rev.reserve(qlen + tlen);
  while (i > 0 || j > 0) {
    int16_t cur = H[i * band + d];
    if (i > 0 && j > 0 && H[(i - 1) * band + d] < INF16 &&
        static_cast<int16_t>(H[(i - 1) * band + d] +
                             (q[i - 1] != t[j - 1] ? 1 : 0)) == cur) {
      rev.push_back('M');
      --i; --j;
    } else if (i > 0 && d + 1 < band &&
               static_cast<int16_t>(H[(i - 1) * band + d + 1] + 1) == cur) {
      rev.push_back('I');  // consumes query only
      --i; ++d;
    } else if (j > 0 && d - 1 >= 0 &&
               static_cast<int16_t>(H[i * band + d - 1] + 1) == cur) {
      rev.push_back('D');  // consumes target only
      --j; --d;
    } else {
      return -1;  // inconsistent H
    }
  }

  int32_t n_ops = 0;
  for (int64_t k = static_cast<int64_t>(rev.size()) - 1; k >= 0;) {
    uint8_t op = rev[k];
    int32_t run = 0;
    while (k >= 0 && rev[k] == op) { ++run; --k; }
    if (n_ops >= max_ops) return -1;
    ops_out[n_ops] = op;
    len_out[n_ops] = run;
    ++n_ops;
  }
  return n_ops;
}

// Standalone banded NW aligner (CPU oracle / fallback): fills H internally.
// Returns n_ops (>=0) and writes the edit distance to *ed_out; if the global
// distance cannot be realized inside the band, *ed_out = -1 and returns 0.
int32_t lrm_banded_align(const uint8_t* q, int32_t qlen, const uint8_t* t,
                         int32_t tlen, int32_t W, uint8_t* ops_out,
                         int32_t* len_out, int32_t max_ops, int32_t* ed_out) {
  const int32_t band = 2 * W + 1;
  std::vector<int16_t> H(static_cast<size_t>(qlen + 1) * band, INF16);
  // Row 0: H(0, j) = j for j in [0, W]
  for (int32_t d = W; d < band; ++d) {
    int32_t j = d - W;
    if (j <= tlen) H[d] = static_cast<int16_t>(j);
  }
  for (int32_t i = 1; i <= qlen; ++i) {
    const int16_t* prev = &H[(i - 1) * band];
    int16_t* row = &H[i * band];
    for (int32_t d = 0; d < band; ++d) {
      int32_t j = i + d - W;
      if (j < 0 || j > tlen) continue;
      int32_t best = INF16;
      if (j == 0) {
        best = i;  // H(i, 0) = i
      } else {
        if (prev[d] < INF16) {
          int32_t v = prev[d] + (q[i - 1] != t[j - 1] ? 1 : 0);
          if (v < best) best = v;
        }
        if (d + 1 < band && prev[d + 1] < INF16) {
          int32_t v = prev[d + 1] + 1;
          if (v < best) best = v;
        }
        if (d - 1 >= 0 && row[d - 1] < INF16) {
          int32_t v = row[d - 1] + 1;
          if (v < best) best = v;
        }
      }
      row[d] = static_cast<int16_t>(best < INF16 ? best : INF16);
    }
  }
  int32_t d_end = tlen - qlen + W;
  if (d_end < 0 || d_end >= band || H[qlen * band + d_end] >= INF16) {
    *ed_out = -1;
    return 0;
  }
  *ed_out = H[qlen * band + d_end];
  int32_t n = lrm_traceback(H.data(), band, W, q, t, qlen, tlen, ops_out,
                            len_out, max_ops);
  if (n < 0) { *ed_out = -1; return 0; }
  return n;
}

}  // extern "C"
