// Native K-way merge for the external-memory SA build: the port's copy of
// longreadmapper_tpu/native/samerge.cpp (same algorithm, same C entry
// point), built with g++ by longreadmapper_tpu_torch/native_build.py and
// loaded by index/sa_external.py, so the port needs nothing of the JAX
// package.  It is the streamed counterpart of pSAscan's multiway
// partial-SA merge (the reference's psascan/src/psascan_src/merge.h:57+,
// async vbyte gap readers), and the port's only merge: there is no numpy
// merge to fall back to.
//
//   * Each partial SA is a disk file of 5-byte ui40 absolute positions
//     (the .sa5 codec itself: 40 bits cover any 2^40-byte text) in
//     suffix order; heads are refilled through fread buffers.
//   * Per head a 8-byte big-endian prefix key of the suffix is cached;
//     the winner scan compares keys and falls back to memcmp against the
//     mmap'd text only on key equality.  The text's final byte is unique
//     (the '$' terminator, the reference's asindex.c:108-110), so two
//     distinct suffixes always differ within the text: the merge order is
//     exactly the global suffix order, byte-identical to the in-RAM
//     build, with no repair stage.
//   * Output is written directly in the 5-byte little-endian .sa5 codec
//     (the reference's psascan/sa_use.h:17-28) through a flush buffer.
//
// Exported C ABI (ctypes, index/sa_external.py::sa_merge_files):
//   lrm_sa_merge(text_path, n, part_paths, counts, K, out_path)
//     -> total entries written (int64_t), or -1 on failure.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr int64_t kReadChunk = 1 << 20;   // entries per refill (8 MB)
constexpr int64_t kOutChunk = 1 << 20;    // entries per output flush (5 MB)

struct Run {
    FILE *f = nullptr;
    int64_t remaining = 0;     // entries still on disk
    std::vector<uint8_t> buf;  // loaded 5-byte ui40 entries
    int64_t at = 0;            // next entry index into buf
    int64_t loaded = 0;        // entries in buf
    int64_t head_pos = -1;     // current head position (text offset)
    uint64_t head_key = 0;     // big-endian 8-byte prefix of the suffix

    bool done() const { return head_pos < 0; }
};

inline uint64_t prefix_key(const uint8_t *text, int64_t n, int64_t pos) {
    uint64_t k = 0;
    if (pos + 8 <= n) {
        std::memcpy(&k, text + pos, 8);
    } else {
        std::memcpy(&k, text + pos, static_cast<size_t>(n - pos));
        // zero padding past the end — never decisive: any suffix shorter
        // than 8 bytes contains the unique terminator inside the key, so
        // no other suffix can share those bytes
    }
    return __builtin_bswap64(k);
}

inline void advance(Run &r, const uint8_t *text, int64_t n) {
    if (r.at >= r.loaded) {
        if (r.remaining <= 0) {
            r.head_pos = -1;
            return;
        }
        const int64_t take = r.remaining < kReadChunk ? r.remaining
                                                      : kReadChunk;
        r.buf.resize(static_cast<size_t>(take) * 5);
        const size_t got = fread(r.buf.data(), 5,
                                 static_cast<size_t>(take), r.f);
        if (static_cast<int64_t>(got) != take) {
            r.head_pos = -2;  // read error; surfaced by the caller loop
            return;
        }
        r.remaining -= take;
        r.loaded = take;
        r.at = 0;
    }
    const uint8_t *e = r.buf.data() + static_cast<size_t>(r.at++) * 5;
    uint32_t low;
    std::memcpy(&low, e, 4);  // little-endian low word + high byte
    r.head_pos = static_cast<int64_t>(low) |
                 (static_cast<int64_t>(e[4]) << 32);
    r.head_key = prefix_key(text, n, r.head_pos);
}

// exact suffix comparison beyond the cached key (keys already equal, so
// both suffixes have >= 8 identical leading bytes inside the text)
inline bool suffix_less(const uint8_t *text, int64_t n, int64_t a,
                        int64_t b) {
    const int64_t la = n - a, lb = n - b;
    const int64_t l = la < lb ? la : lb;
    if (l <= 8) return la < lb;  // key equality implies l > 8; defensive
    const int c = std::memcmp(text + a + 8, text + b + 8,
                              static_cast<size_t>(l - 8));
    if (c != 0) return c < 0;
    return la < lb;  // unreachable with a unique terminator; kept safe
}

}  // namespace

extern "C" int64_t lrm_sa_merge(const char *text_path, int64_t n,
                                const char *const *part_paths,
                                const int64_t *counts, int32_t K,
                                const char *out_path) {
    if (K <= 0) return -1;
    const int fd = open(text_path, O_RDONLY);
    if (fd < 0) return -1;
    void *map = mmap(nullptr, static_cast<size_t>(n), PROT_READ,
                     MAP_PRIVATE, fd, 0);
    close(fd);
    if (map == MAP_FAILED) return -1;
    const uint8_t *text = static_cast<const uint8_t *>(map);

    std::vector<Run> runs(static_cast<size_t>(K));
    FILE *out = nullptr;
    int64_t written = 0;
    bool fail = false;
    for (int32_t i = 0; i < K && !fail; ++i) {
        Run &r = runs[static_cast<size_t>(i)];
        r.f = fopen(part_paths[i], "rb");
        r.remaining = counts[i];
        if (!r.f) { fail = true; break; }
        advance(r, text, n);
        if (r.head_pos == -2) fail = true;
    }
    if (!fail) {
        out = fopen(out_path, "wb");
        fail = out == nullptr;
    }

    std::vector<uint8_t> obuf(static_cast<size_t>(kOutChunk) * 5);
    size_t ofill = 0;
    while (!fail) {
        int best = -1;
        for (int32_t i = 0; i < K; ++i) {
            const Run &r = runs[static_cast<size_t>(i)];
            if (r.done()) continue;
            if (best < 0) { best = i; continue; }
            const Run &b = runs[static_cast<size_t>(best)];
            if (r.head_key < b.head_key ||
                (r.head_key == b.head_key &&
                 suffix_less(text, n, r.head_pos, b.head_pos)))
                best = i;
        }
        if (best < 0) break;  // all runs exhausted
        Run &w = runs[static_cast<size_t>(best)];
        const uint64_t v = static_cast<uint64_t>(w.head_pos);
        uint8_t *p = obuf.data() + ofill;
        const uint32_t low = static_cast<uint32_t>(v & 0xFFFFFFFFu);
        std::memcpy(p, &low, 4);                       // LE low word
        p[4] = static_cast<uint8_t>(v >> 32);          // high byte
        ofill += 5;
        ++written;
        if (ofill == obuf.size()) {
            if (fwrite(obuf.data(), 1, ofill, out) != ofill) fail = true;
            ofill = 0;
        }
        advance(w, text, n);
        if (w.head_pos == -2) fail = true;
    }
    if (!fail && ofill) {
        if (fwrite(obuf.data(), 1, ofill, out) != ofill) fail = true;
    }

    for (Run &r : runs)
        if (r.f) fclose(r.f);
    if (out) fclose(out);
    munmap(map, static_cast<size_t>(n));
    return fail ? -1 : written;
}
