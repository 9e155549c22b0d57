// Myers bit-parallel edit distance (multi-block) in the three edlib modes:
// the port's copy of longreadmapper_tpu/native/myers.cpp (same algorithm,
// same C entry point), built with g++ by
// longreadmapper_tpu_torch/native_build.py and loaded by
// longreadmapper_tpu_torch/native.py (`myers_distance`, `myers_align`).
// It is the equivalent of the reference's vendored edlib (modes NW global /
// SHW prefix / HW infix, task DISTANCE+LOC, `edlibAlign`'s bounded-k
// search).  The alignment PATH of a located pair comes from the banded
// aligner (align.cpp) instead of edlib's Hirschberg path: the same CIGAR
// alphabet, a documented divergence.
//
// Implementation: the block recurrence of Hyyro's "A Bit-Vector Algorithm
// for Computing Levenshtein and Damerau Edit Distances" (2003) / Myers
// (JACM 1999), word size 64, with a k-bounded Ukkonen band over blocks:
//
//   * Any DP cell with i query chars against j target chars has true cost
//     >= i - j in every mode (each target char consumes at most one query
//     char for free), so rows i > j + k cannot lie on a <=k path; only
//     blocks covering rows <= j + k are computed.
//   * A block activated mid-scan starts from the all-+1 vertical state —
//     an UPPER bound on its previous-column values (each value is at most
//     one more than the cell above), so computed scores can only
//     overestimate; any result <= k is exact, results > k collapse to -1
//     (the edlib "not found within k" contract).
//   * Early abort: per column the best achievable final score is bounded
//     below by score - (columns remaining) (the score changes by at most
//     one per column); once min(best, that bound) > k the scan stops.
//
// Exported C ABI (ctypes, native.py):
//   lrm_myers_distance(q, m, t, n, mode, k, out2) -> 0
//     mode: 0 = NW, 1 = SHW, 2 = HW;  k < 0 = unbounded
//     out2 = {distance, end_pos}  (end_pos = 1-based target end; n for NW;
//            distance = -1 and end = 0 when the distance exceeds k)

#include <cstdint>
#include <vector>

namespace {

inline int advance_block(uint64_t Eq, uint64_t &Pv, uint64_t &Mv, int hin,
                         uint64_t hibit) {
    uint64_t Xv = Eq | Mv;
    if (hin < 0) Eq |= 1ULL;
    uint64_t Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
    uint64_t Ph = Mv | ~(Xh | Pv);
    uint64_t Mh = Pv & Xh;
    int hout = 0;
    if (Ph & hibit) hout = 1;
    else if (Mh & hibit) hout = -1;
    Ph <<= 1;
    Mh <<= 1;
    if (hin < 0) Mh |= 1ULL;
    else if (hin > 0) Ph |= 1ULL;
    Pv = Mh | ~(Xv | Ph);
    Mv = Ph & Xv;
    return hout;
}

constexpr int64_t KINF = INT64_MAX / 4;

}  // namespace

extern "C" int lrm_myers_distance(const uint8_t *q, int64_t m,
                                  const uint8_t *t, int64_t n, int mode,
                                  int64_t k, int64_t *out2) {
    if (k < 0) k = KINF;
    if (m == 0) {  // empty query: NW/SHW cost = n gaps / 0 by free end
        const int64_t d = (mode == 0) ? n : 0;
        out2[0] = d > k ? -1 : d;
        out2[1] = d > k ? 0 : ((mode == 0) ? n : 0);
        return 0;
    }
    // mode-independent floor: q must be fully consumed, at most n target
    // chars help; NW additionally pays for unconsumed target
    const int64_t floor_d = (mode == 0) ? (m > n ? m - n : n - m)
                                        : (m > n ? m - n : 0);
    if (floor_d > k) {
        out2[0] = -1;
        out2[1] = 0;
        return 0;
    }
    if (n == 0) {  // empty target: q inserts wholesale in every mode
        out2[0] = m > k ? -1 : m;
        out2[1] = 0;
        return 0;
    }
    const int64_t nw = (m + 63) >> 6;
    // per-symbol pattern masks (codes 0..3 = ACGT, 4 = N: matches nothing)
    std::vector<uint64_t> peq(5 * nw, 0);
    for (int64_t i = 0; i < m; ++i) {
        const int c = q[i] < 4 ? q[i] : 4;
        peq[c * nw + (i >> 6)] |= 1ULL << (i & 63);
    }
    std::vector<uint64_t> Pv(nw, ~0ULL), Mv(nw, 0);
    // active band: blocks [0, active); score = value at the band's bottom
    // row min(64*active, m)
    auto bottom_row = [&](int64_t a) { return a * 64 < m ? a * 64 : m; };
    int64_t active = k >= m ? nw : ((k + 1 + 63) >> 6);  // rows i <= j+1+k at j=0
    if (active > nw) active = nw;
    int64_t score = bottom_row(active);
    int64_t best = KINF, best_pos = 0;
    const int hin0 = (mode == 2) ? 0 : 1;  // HW: free target prefix
    for (int64_t j = 0; j < n; ++j) {
        // extend the band to cover rows <= (j+1) + k; fresh blocks carry
        // the all-+1 vertical state they were initialized with (a valid
        // upper bound on the skipped columns)
        const int64_t want_rows = (j + 1) + k;
        int64_t want = want_rows >= m ? nw : ((want_rows + 63) >> 6);
        if (want > nw) want = nw;
        if (want > active) {
            score += bottom_row(want) - bottom_row(active);
            active = want;
        }
        const int c = t[j] < 4 ? t[j] : 4;
        int hin = hin0;
        for (int64_t b = 0; b < active; ++b) {
            const uint64_t hibit =
                (b == nw - 1) ? (1ULL << ((m - 1) & 63)) : (1ULL << 63);
            hin = advance_block(peq[c * nw + b], Pv[b], Mv[b], hin, hibit);
        }
        score += hin;
        if (active == nw) {
            if (mode != 0 && score < best) { best = score; best_pos = j + 1; }
            // score moves by at most 1 per remaining column
            const int64_t reach = score - (n - 1 - j);
            if ((mode == 0 ? reach : (best < reach ? best : reach)) > k)
                break;
        }
    }
    int64_t d, pos;
    if (mode == 0) {
        d = active == nw ? score : KINF;
        pos = n;
    } else {
        d = best;
        pos = best_pos;
    }
    out2[0] = d > k ? -1 : d;
    out2[1] = d > k ? 0 : pos;
    return 0;
}
