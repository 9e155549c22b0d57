// Affine-gap banded Smith-Waterman with traceback: the port's copy of
// longreadmapper_tpu/native/affine.cpp (same algorithm, same C entry
// point), built with g++ by longreadmapper_tpu_torch/native_build.py and
// loaded by ops/affine.py::affine_align.  It is the host-side counterpart
// of the batched scorer (ops/affine.py::banded_sw_affine) and the
// equivalent of the reference's SSW wrapper `compute_cigar` (the
// reference's ssw/ssw_use.c:27-54: match=2, mismatch=-2, gap open 3, gap
// extend 1, N scores 0 against everything).
//
// Band coordinate d = j - i + W, band width 2W+1.  Gap convention matches
// ssw: a gap's first base costs open+ext, each further base ext.
// Traceback: from the best-scoring cell back to the first H==0 cell,
// preferring M over I (query gap) over D (target gap) on ties.
//
// Exported C ABI (ctypes, ops/affine.py):
//   lrm_affine_align(q, qlen, t, tlen, W, match, mismatch, open, ext,
//                    ops_out, lens_out, max_ops, out5)
//   -> n_ops (>=0), -1 when nothing scores positive, -2 when the ops do
//      not fit max_ops.
//   out5 = {score, q_beg, q_end, t_beg, t_end} (0-based, end exclusive).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {
const int32_t NEG = -(1 << 28);

inline int32_t max3(int32_t a, int32_t b, int32_t c) {
    int32_t m = a > b ? a : b;
    return m > c ? m : c;
}
}  // namespace

extern "C" int32_t lrm_affine_align(
    const uint8_t *q, int32_t qlen, const uint8_t *t, int32_t tlen,
    int32_t W, int32_t match, int32_t mismatch, int32_t gap_open,
    int32_t gap_ext, uint8_t *ops_out, int32_t *lens_out, int32_t max_ops,
    int32_t *out5) {
    const int32_t band = 2 * W + 1;
    const int32_t oe = gap_open + gap_ext;
    const int64_t rows = (int64_t)qlen + 1;
    std::vector<int32_t> H(rows * band, 0), E(rows * band, NEG),
        F(rows * band, NEG);

    int32_t best = 0, bi = 0, bj = 0;
    for (int32_t i = 1; i <= qlen; ++i) {
        for (int32_t d = 0; d < band; ++d) {
            const int32_t j = i + d - W;
            if (j < 1 || j > tlen) continue;
            const int32_t hup = (d + 1 < band) ? H[(i - 1) * band + d + 1]
                                               : NEG;
            const int32_t fup = (d + 1 < band) ? F[(i - 1) * band + d + 1]
                                               : NEG;
            const int32_t f = (hup - oe > fup - gap_ext) ? hup - oe
                                                         : fup - gap_ext;
            const int32_t hleft = (d >= 1) ? H[i * band + d - 1] : NEG;
            const int32_t eleft = (d >= 1) ? E[i * band + d - 1] : NEG;
            const int32_t e = (hleft - oe > eleft - gap_ext)
                                  ? hleft - oe : eleft - gap_ext;
            const bool acgt = q[i - 1] < 4 && t[j - 1] < 4;
            const int32_t s = acgt ? (q[i - 1] == t[j - 1] ? match : mismatch)
                                   : 0;
            const int32_t diag = H[(i - 1) * band + d] + s;
            int32_t h = max3(diag, e, f);
            if (h < 0) h = 0;
            H[i * band + d] = h;
            E[i * band + d] = e;
            F[i * band + d] = f;
            if (h > best) { best = h; bi = i; bj = j; }
        }
    }
    if (best <= 0) return -1;

    // traceback from (bi, bj) to the first H == 0
    std::vector<uint8_t> rev;
    int32_t i = bi, j = bj;
    int state = 0;  // 0 = H, 1 = E (target gap, D), 2 = F (query gap, I)
    while (i > 0 && j > 0) {
        const int32_t d = j - i + W;
        if (state == 0) {
            const int32_t h = H[i * band + d];
            if (h == 0) break;
            const bool acgt = q[i - 1] < 4 && t[j - 1] < 4;
            const int32_t s = acgt ? (q[i - 1] == t[j - 1] ? match : mismatch)
                                   : 0;
            if (H[(i - 1) * band + d] + s == h) {
                rev.push_back('M'); --i; --j;
            } else if (F[i * band + d] == h) {
                state = 2;
            } else {
                state = 1;
            }
        } else if (state == 1) {  // E: gap in query sequence (op D)
            const int32_t e = E[i * band + d];
            rev.push_back('D');
            const int32_t hleft = (d >= 1) ? H[i * band + d - 1] : NEG;
            state = (hleft - oe == e) ? 0 : 1;
            --j;
        } else {  // F: gap in target sequence (op I)
            const int32_t f = F[i * band + d];
            rev.push_back('I');
            const int32_t hup = (d + 1 < band) ? H[(i - 1) * band + d + 1]
                                               : NEG;
            state = (hup - oe == f) ? 0 : 2;
            --i;
        }
    }

    out5[0] = best;
    out5[1] = i;       // q_beg (0-based)
    out5[2] = bi;      // q_end (exclusive)
    out5[3] = j;       // t_beg
    out5[4] = bj;      // t_end
    // run-length encode reversed ops
    int32_t n = 0;
    for (int64_t k = (int64_t)rev.size() - 1; k >= 0;) {
        const uint8_t op = rev[k];
        int32_t run = 0;
        while (k >= 0 && rev[k] == op) { ++run; --k; }
        if (n >= max_ops) return -2;
        ops_out[n] = op;
        lens_out[n] = run;
        ++n;
    }
    return n;
}
