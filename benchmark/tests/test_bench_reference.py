"""The plain reference: its banded distance against a cell-by-cell DP, its
vote against a literal transcription of the reference's phase loop, and a
whole run of the harness on the CPU (the port's plain versions) judged by
it: the reference against the port on a tiny genome."""

import time

import numpy as np
import pytest
import torch

from benchmark import reference as R
from benchmark import run
from benchmark.traffic import make_genome, make_pool


def _brute(q, t, W):
    """lrm_banded_align's distance: cells with |j - i| <= W, H(0, j) = j,
    H(i, 0) = i, -1 when the end is out of band."""
    INF = 10**9
    n, m = len(q), len(t)
    H = [[INF] * (m + 1) for _ in range(n + 1)]
    for j in range(0, min(W, m) + 1):
        H[0][j] = j
    for i in range(1, n + 1):
        for j in range(max(0, i - W), min(m, i + W) + 1):
            if j == 0:
                H[i][j] = i
                continue
            H[i][j] = min(H[i - 1][j - 1] + (q[i - 1] != t[j - 1]),
                          H[i - 1][j] + 1 if abs(j - i + 1) <= W else INF,
                          H[i][j - 1] + 1 if abs(j - 1 - i) <= W else INF)
    return H[n][m] if H[n][m] < INF else -1


def test_banded_distance_against_brute_force():
    rng = np.random.default_rng(1)
    g = make_genome({"contigs": [["c", 2000]]}, 1)
    ref = R.Reference(g, 20, 300, "cpu")
    qs, ts, Ws = [], [], []
    for n, W in [(1, 8), (7, 8), (30, 3), (60, 8), (45, 1), (80, 20),
                 (33, 0), (50, 2)]:
        t = rng.integers(0, 4, n).astype(np.uint8)
        q = t.copy()
        m = rng.random(n) < 0.2
        q[m] = (q[m] + 1) % 4
        # an insertion and a deletion keep the lengths equal
        if n > 10:
            q = np.concatenate([q[:3], [1], q[3:n // 2], q[n // 2 + 1:]])
        qs.append(q.astype(np.uint8))
        ts.append(t)
        Ws.append(W)
    got = ref.banded_ed(qs, ts, Ws)
    want = [_brute(list(q), list(t), W) for q, t, W in zip(qs, ts, Ws)]
    assert got.tolist() == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suffix_order_against_sorted_suffixes(seed):
    rng = np.random.default_rng(seed)
    unit = rng.integers(1, 5, 40)
    # tandem copies: suffixes that agree for far more than any fixed
    # prefix
    text = np.concatenate([rng.integers(1, 5, 30), unit, unit, unit,
                           rng.integers(1, 5, 20), [0]])
    want = sorted(range(text.size), key=lambda i: text[i:].tolist())
    got = R.suffix_array(torch.from_numpy(text)).tolist()
    assert got == want


def _literal_best(ref, seq):
    """alnmain.c:330-405 as the JAX package's oracle writes it: a list of
    [bucket, least key, count] per phase, scanned in insertion order."""
    codes = R._codes(seq)
    sl, phases = ref.seed_len, ref.seed_len + R.GAP_LEN
    text = "".join("ACGT$"[c] for c in ref.cat)
    order = ref.pos.cpu().numpy()

    def occ(j):
        s = "".join("ACGT"[c] for c in codes[j:j + sl])
        hits = [p for p in range(len(text) - sl + 1)
                if text.startswith(s, p)]
        rank = {int(p): r for r, p in enumerate(order)}
        return sorted(hits, key=lambda p: rank[p])

    def top2(entries):
        return R.Reference._top2([(k, v) for _, k, v in entries])

    def add(entries, key):
        for e in entries:
            if e[0] == key >> 4:
                e[2] += 1
                e[1] = min(e[1], key)
                return
        entries.append([key >> 4, key, 1])

    outer, best, acc = [], None, None
    for it in range(phases):
        inner = []
        j = it
        while j < len(codes) - sl:
            hits = occ(j)
            if 0 < len(hits) < ref.thres:
                for p in hits:
                    add(inner, p - j)
            j += phases
        (k1, v1), (_, v2) = top2(inner)
        if (v1 + v2) / (len(codes) // phases) > 0.6:
            best, acc = k1, it
            break
        elif v1 != 0:
            add(outer, k1)
    if best is None or acc == phases - 1:
        best = top2(outer)[0][0]
    return best


def test_vote_against_the_literal_phase_loop():
    g = make_genome({"contigs": [["a", 3000], ["b", 2500]], "repeats": [
        {"family": "t", "length": 500, "copies": 2, "placement": "tandem",
         "contig": "a", "at": 1000}]}, 4)
    ref = R.Reference(g, 20, 300, "cpu")
    mix = dict(lengths={"mean": 15000, "stdev": 13000, "min": 150,
                        "max": 400},
               identity={"mean": 0.9, "max": 0.99, "stdev": 0.05},
               errors={"sub": 1 / 3, "ins": 1 / 3, "dele": 1 / 3},
               chunk_reads=6, reverse_share=0.5, pool_chunks=1)
    pool = make_pool(g, mix, 4)
    # reads of repeats: a window seen twice in the text, and one inside
    # the tandem's first copy, tied with its second
    text = "".join("ACGT"[c] for c in g.codes)
    seqs = pool.seqs + ["ACGT" * 40, text[1100:1400]]
    lens, occ = ref._occurrences(seqs)
    for s, n, (j, keys) in zip(seqs, lens, occ):
        assert ref._best(int(n), j, keys) == _literal_best(ref, s)


def test_reference_against_the_port_on_the_cpu(tiny_cell):
    parts = run.run_cell(tiny_cell, 2**31 + 77, 12.0, False, "cpu",
                         time.perf_counter())
    c = parts["counts"]
    assert c["sampled"] >= 8 and c["sampled_full_band"] >= 1
    assert c["records_wrong"] == 0 and c["failed"] == 0, c
    assert parts["run"]["counters"]["retried_reads"] >= 1
    line = run.result_line(tiny_cell, parts, False, "cpu", 1)
    assert line["correct"] is True
    assert list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"bases_per_s", "chunk_p95_ms",
                                    "setup_s"}


@pytest.mark.cuda
def test_reference_against_the_port_on_the_card(tiny_cell):
    """The same on the card: the port's CUDA kernels at the tiny size."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels")
    parts = run.run_cell(tiny_cell, 2**31 + 78, 4.0, False, "cuda",
                         time.perf_counter())
    c = parts["counts"]
    assert c["sampled"] >= 8 and c["records_wrong"] == 0, c
    assert run.result_line(tiny_cell, parts, False, "gpu", 1)["correct"]
