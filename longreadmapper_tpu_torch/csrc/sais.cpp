// Suffix-array construction by induced sorting (SA-IS): the port's copy of
// longreadmapper_tpu/native/sais.cpp (same algorithm, same C entry point),
// built with g++ by longreadmapper_tpu_torch/native_build.py and loaded by
// index/sa.py, so the port needs nothing of the JAX package.
//
// This is the host-native replacement for the reference's pSAscan + divsufsort
// stack (the reference's psascan/, SURVEY.md L0/L1): the index builder needs
// the full suffix array of the concatenated reference text (.cat) to derive
// the BWT, sampled-Occ and sampled-SA tables.  pSAscan is an external-memory
// parallel construction; for in-RAM genomes a single-pass SA-IS (Nong, Zhang
// & Chan, DCC'09 algorithm — implemented here from the paper's description)
// is simpler and fast (O(n), ~10s per GB).  External-memory blocks can be
// layered on later if >RAM genomes are required.
//
// Convention: suffixes compared with an implicit terminal sentinel smaller
// than every character (matches pSAscan's plain suffix order on .cat, whose
// final '$' byte is itself smaller than all ACGT bytes).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

template <typename TS, typename I>
void sais_rec(const TS* s, I* SA, I n, I K) {
  // s: values in [0, K); s[n-1] is the unique smallest character (sentinel).
  const I EMPTY = static_cast<I>(-1);
  std::vector<uint8_t> t(n);  // 1 = S-type, 0 = L-type
  t[n - 1] = 1;
  for (I i = n - 2; i >= 0; --i)
    t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;
  auto is_lms = [&](I i) { return i > 0 && t[i] && !t[i - 1]; };

  std::vector<I> cnt(K, 0), bkt(K);
  for (I i = 0; i < n; ++i) cnt[s[i]]++;
  auto bkt_ends = [&]() {
    I sum = 0;
    for (I c = 0; c < K; ++c) { sum += cnt[c]; bkt[c] = sum; }
  };
  auto bkt_starts = [&]() {
    I sum = 0;
    for (I c = 0; c < K; ++c) { bkt[c] = sum; sum += cnt[c]; }
  };

  auto induce = [&]() {
    bkt_starts();
    for (I i = 0; i < n; ++i) {
      I j = SA[i];
      if (j != EMPTY && j > 0 && !t[j - 1]) SA[bkt[s[j - 1]]++] = j - 1;
    }
    bkt_ends();
    for (I i = n - 1; i >= 0; --i) {
      I j = SA[i];
      if (j != EMPTY && j > 0 && t[j - 1]) SA[--bkt[s[j - 1]]] = j - 1;
    }
  };

  // Stage 1: sort LMS substrings by one round of induced sorting.
  std::fill(SA, SA + n, EMPTY);
  bkt_ends();
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) SA[--bkt[s[i]]] = i;
  induce();

  // Compact the (substring-)sorted LMS suffixes to the front.
  I n1 = 0;
  for (I i = 0; i < n; ++i)
    if (SA[i] != EMPTY && is_lms(SA[i])) SA[n1++] = SA[i];

  // Name LMS substrings into the tail half of SA.
  std::fill(SA + n1, SA + n, EMPTY);
  I name = 0, prev = EMPTY;
  for (I i = 0; i < n1; ++i) {
    I pos = SA[i];
    bool diff = (prev == EMPTY);
    if (!diff) {
      for (I d = 0;; ++d) {
        if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
          if (!(is_lms(pos + d) && is_lms(prev + d))) diff = true;
          break;
        }
      }
    }
    if (diff) { ++name; prev = pos; }
    SA[n1 + pos / 2] = name - 1;
  }
  for (I i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] != EMPTY) SA[j--] = SA[i];

  // Recurse if names are not yet unique.
  I* s1 = SA + n - n1;
  if (name < n1) {
    sais_rec<I, I>(s1, SA, n1, name);
  } else {
    for (I i = 0; i < n1; ++i) SA[s1[i]] = i;
  }

  // Map reduced-problem order back to LMS text positions.
  for (I i = 1, k = 0; i < n; ++i)
    if (is_lms(i)) s1[k++] = i;
  for (I i = 0; i < n1; ++i) SA[i] = s1[SA[i]];

  // Stage 2: induce the final SA from the fully sorted LMS suffixes.
  std::fill(SA + n1, SA + n, EMPTY);
  bkt_ends();
  for (I i = n1 - 1; i >= 0; --i) {
    I j = SA[i];
    SA[i] = EMPTY;
    SA[--bkt[s[j]]] = j;
  }
  induce();
}

template <typename I>
void sais_bytes(const uint8_t* text, int64_t n, int64_t* sa_out) {
  // Append an explicit sentinel (rank 0).  Genome texts have a tiny
  // alphabet (ACGTN + separators), so the shifted copy is a rank-remapped
  // uint8 whenever < 256 distinct bytes occur (1 byte/char); the general
  // fallback is the +1-shifted uint16 (258 symbols).  Either way the copy
  // stays O(n) bytes, never 8n.
  int64_t cnt256[256] = {0};
  for (int64_t i = 0; i < n; ++i) cnt256[text[i]]++;
  uint16_t rank_of[256];
  int distinct = 0;
  for (int c = 0; c < 256; ++c)
    if (cnt256[c]) rank_of[c] = static_cast<uint16_t>(++distinct);
  std::vector<I> SA;
  I* SAp;
  if (sizeof(I) == 8) {
    // genome scale: build directly in the caller's (n+1)-slot buffer —
    // a separate internal SA would double the 8(n+1)-byte footprint
    // (~50 GB at an hg19-class 6.2e9 .cat)
    SAp = reinterpret_cast<I*>(sa_out);
  } else {
    SA.resize(n + 1);
    SAp = SA.data();
  }
  if (distinct < 256) {
    std::vector<uint8_t> s(n + 1);
    for (int64_t i = 0; i < n; ++i)
      s[i] = static_cast<uint8_t>(rank_of[text[i]]);
    s[n] = 0;
    sais_rec<uint8_t, I>(s.data(), SAp, static_cast<I>(n + 1),
                         static_cast<I>(distinct + 1));
  } else {
    std::vector<uint16_t> s(n + 1);
    for (int64_t i = 0; i < n; ++i) s[i] = static_cast<uint16_t>(text[i]) + 1;
    s[n] = 0;
    sais_rec<uint16_t, I>(s.data(), SAp, static_cast<I>(n + 1),
                          static_cast<I>(257));
  }
  // SA[0] is the sentinel suffix; drop it.
  if (sizeof(I) == 8) {
    std::memmove(sa_out, sa_out + 1, static_cast<size_t>(n) * 8);
  } else {
    for (int64_t i = 0; i < n; ++i) sa_out[i] = static_cast<int64_t>(SAp[i + 1]);
  }
}

}  // namespace

extern "C" {

// Suffix array of `text[0..n)` into `sa_out` (int64). Returns 0 on ok.
// sa_out MUST have capacity for n + 1 entries (the build runs in the
// caller's buffer at genome scale; the final entry is scratch).
int lrm_sais_u8(const uint8_t* text, int64_t n, int64_t* sa_out) {
  if (n <= 0) return 0;
  if (n + 1 < (1LL << 31)) {
    sais_bytes<int32_t>(text, n, sa_out);
  } else {
    sais_bytes<int64_t>(text, n, sa_out);
  }
  return 0;
}

}  // extern "C"
