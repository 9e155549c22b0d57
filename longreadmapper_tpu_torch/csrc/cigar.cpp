// The SAM assembly's CIGAR strings: every row of a chunk part's run buffer
// turned into its CIGAR text in one host call, built with g++ by
// longreadmapper_tpu_torch/native_build.py and called through ctypes by
// models/mapper.py (`_Cigars`).
//
// A row holds the walk's run entries exactly as the step's blob, its lazy
// tail and the retry's splice leave them: entries of 1, 2 or 4 bytes,
// signed little-endian, each `(count << 2) | op` (op 0 M, 1 I, 2 D; 3 is
// the pad), in reverse path order.  A row's width past its last whole
// entry is dropped.  An entry with op 3 or a count <= 0 is skipped, and
// adjacent entries of one op merge into one group, across skipped entries
// too; a group is written as its total count in decimal and its op letter.
// These are the semantics of the JAX package's `_rle_groups`.
//
// Exported C ABI (ctypes):
//   lrm_cigar_batch(runs, B, row_bytes, row_stride, entry_bytes, out,
//                   out_cap, row_end) -> bytes written, or -1
//     runs: B rows of row_bytes bytes, row r at runs + r * row_stride
//     out: every row's text back to back; row_end[r] = the offset where
//          row r's text ends (a row without runs writes nothing)
//     -1 when entry_bytes is not 1, 2 or 4 or the text passes out_cap
//     (B * (row_bytes / entry_bytes) * 11 always holds it: a group of k
//     entries totals under k * 2^29, at most 11 k bytes with its letter)

#include <cstdint>

namespace {

template <int EB>
inline int32_t entry_at(const uint8_t* p) {
    if (EB == 1) return static_cast<int8_t>(p[0]);
    if (EB == 2)
        return static_cast<int16_t>(static_cast<uint16_t>(
            p[0] | static_cast<uint16_t>(p[1]) << 8));
    return static_cast<int32_t>(
        static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
        static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24);
}

// Append `count` in decimal and `op`'s letter at out + pos; false when the
// text would pass cap.
inline bool put_group(char* out, int64_t& pos, int64_t cap, int64_t count,
                      int op) {
    char digits[20];
    int n = 0;
    do {
        digits[n++] = static_cast<char>('0' + count % 10);
        count /= 10;
    } while (count);
    if (pos + n + 1 > cap) return false;
    while (n) out[pos++] = digits[--n];
    out[pos++] = "MID"[op];
    return true;
}

template <int EB>
int64_t cigar_rows(const uint8_t* runs, int64_t B, int64_t row_bytes,
                   int64_t row_stride, char* out, int64_t cap,
                   int64_t* row_end) {
    const int64_t n = row_bytes / EB;
    int64_t pos = 0;
    for (int64_t r = 0; r < B; ++r) {
        const uint8_t* row = runs + r * row_stride;
        int op = -1;
        int64_t total = 0;
        for (int64_t j = n - 1; j >= 0; --j) {
            const int32_t e = entry_at<EB>(row + j * EB);
            // e < 4: a count <= 0 (a negative entry's count is negative)
            if (e < 4 || (e & 3) == 3) continue;
            if ((e & 3) != op) {
                if (op >= 0 && !put_group(out, pos, cap, total, op))
                    return -1;
                op = e & 3;
                total = 0;
            }
            total += e >> 2;
        }
        if (op >= 0 && !put_group(out, pos, cap, total, op)) return -1;
        row_end[r] = pos;
    }
    return pos;
}

}  // namespace

extern "C" int64_t lrm_cigar_batch(const void* runs, int64_t B,
                                   int64_t row_bytes, int64_t row_stride,
                                   int entry_bytes, char* out,
                                   int64_t out_cap, int64_t* row_end) {
    const auto* p = static_cast<const uint8_t*>(runs);
    switch (entry_bytes) {
        case 1:
            return cigar_rows<1>(p, B, row_bytes, row_stride, out, out_cap,
                                 row_end);
        case 2:
            return cigar_rows<2>(p, B, row_bytes, row_stride, out, out_cap,
                                 row_end);
        case 4:
            return cigar_rows<4>(p, B, row_bytes, row_stride, out, out_cap,
                                 row_end);
        default:
            return -1;
    }
}
