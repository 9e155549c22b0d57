"""The inputs of tests/test_edge_cases.py through the port's TorchMapper,
held to the JAX TPUMapper's SAM on the CPU: reads shorter than the seed
(lengths 0, 1, 10 and 15), an all-N read, a read with an N run, an empty
chunk, a read across the .cat contig join, a lowercase read, mutated
reads whose records must be well formed, and a genome of 32 contigs.  One
card-only case maps the same inputs through the seed-vote kernels and
walk_c_kernel and holds them to the port on the CPU.

The module imports no JAX (the CPU tests import it themselves), so the
card case runs where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_edge_cases.py
"""

import re

import numpy as np
import pytest
import torch

from longreadmapper_tpu_torch.index.device import load_device_index
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.runtime.accidx import build_index
from longreadmapper_tpu_torch.utils.config import Params

torch.set_num_threads(1)
HLEN = 5


def _genome(rng, n: int) -> str:
    """tests/conftest.py::make_genome without Ns."""
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)
                                             ].tobytes().decode()


def _write_fasta(path: str, seqs) -> None:
    with open(path, "w") as f:
        for name, seq in seqs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")


def _small(tmp):
    """tests/test_edge_cases.py's two-contig genome."""
    genome = _genome(np.random.default_rng(3), 9000)
    fa = str(tmp / "e.fa")
    _write_fasta(fa, [("cA", genome[:5000]), ("cB", genome[5000:])])
    return fa


def _many(tmp):
    """tests/test_edge_cases.py's 32 contigs of 600 bases."""
    rng = np.random.default_rng(12)
    contigs = [(f"ctg{i:02d}", _genome(rng, 600)) for i in range(32)]
    fa = str(tmp / "m.fa")
    _write_fasta(fa, contigs)
    return fa, contigs


def _cat(fa: str) -> str:
    with open(fa + ".cat", "rb") as f:
        return f.read().decode()


def _inputs(cat: str):
    """Named chunks of reads: the edge cases of tests/test_edge_cases.py,
    plus a lowercase read."""
    seq = cat[100:250]
    rng = np.random.default_rng(9)
    src = cat[:5000]
    mutated = []
    for i in range(8):
        p = int(rng.integers(0, len(src) - 220))
        ch = np.frombuffer(src[p:p + 200].encode(), np.uint8).copy()
        m = rng.random(200) < 0.03
        ch[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                              int(m.sum()))]
        mutated.append((f"v{i}", ch.tobytes().decode(), "I" * 200))
    return {
        "shorter than the seed": [("tiny", "ACGTACGTAC", None),
                                  ("one", "A", None),
                                  ("fifteen", cat[300:315], None),
                                  ("empty", "", None)],
        "all N": [("nn", "N" * 150, None)],
        "N run": [("mx", seq[:40] + "NNNNN" + seq[45:], None)],
        "empty chunk": [],
        "contig join": [("join", cat[9950:10050], None)],
        "lowercase": [("low", cat[2000:2200].lower(), None),
                      ("mixed", cat[3000:3100] + cat[3100:3200].lower(),
                       None)],
        "mutated": mutated,
    }


def _sam(mapper, reads) -> list:
    return [r.to_sam() for r in mapper.map_chunk(reads)]


def _check_structure(lines, mta) -> None:
    """tests/test_edge_cases.py's record invariants on SAM lines."""
    contig_len = {m.seq_name: m.seq_len for m in mta}
    for line in lines:
        f = line.rstrip("\n").split("\t")
        assert len(f) == 12 and int(f[1]) in (0, 4, 16)
        if f[1] == "4":
            assert f[5] == "*"
            continue
        if f[5] == "*":
            # a zero-length read "aligns" with ed 0 and no CIGAR, in JAX too
            assert f[9] in ("", "*") and f[11].strip() == "ED:I:0"
            continue
        ops = re.findall(r"(\d+)([MID])", f[5])
        assert "".join(f"{c}{o}" for c, o in ops) == f[5]
        assert sum(int(c) for c, o in ops if o in "MI") == len(f[9])
        assert int(f[3]) - 1 + sum(int(c) for c, o in ops
                                   if o in "MD") <= contig_len[f[2]]


def _mappers(fa: str):
    from _torch_parity import build_both
    from longreadmapper_tpu.models.mapper import TPUMapper
    d = build_both(fa, HLEN)
    params = Params(hlen=HLEN)
    return (TPUMapper(d["idx"], d["meta"], d["mta"], params, chunk_b=8),
            TorchMapper(d["tidx"], d["tmeta"], d["mta"], params, chunk_b=8,
                        device="cpu"), d)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _mappers(_small(tmp_path_factory.mktemp("torch_edge")))


@pytest.mark.parametrize("case", list(_inputs("A" * 10100)))
def test_edge_case_sam_matches_jax(small, case):
    jm, tm, d = small
    reads = _inputs(d["cat"].tobytes().decode())[case]
    want = _sam(jm, reads)
    got = _sam(tm, reads)
    assert got == want
    assert len(got) == len(reads)
    _check_structure(got, d["mta"])
    if case == "all N":
        assert got[0].split("\t")[1] == "4"
    if case in ("lowercase", "mutated"):
        assert all(line.split("\t")[1] in ("0", "16") for line in got)


def test_many_contigs_sam_matches_jax(tmp_path):
    fa, contigs = _many(tmp_path)
    jm, tm, d = _mappers(fa)
    reads = [(f"q{k}", contigs[k][1][100:280], None) for k in (0, 17, 31)]
    got = _sam(tm, reads)
    assert got == _sam(jm, reads)
    for line, k in zip(got, (0, 17, 31)):
        f = line.split("\t")
        assert (f[2], f[3], f[-1].strip()) == (f"ctg{k:02d}", "101",
                                               "ED:I:0")


@pytest.mark.cuda
def test_edge_cases_card_match_cpu(tmp_path):
    """The same inputs on the card: the seed vote's kernels and
    walk_c_kernel on lanes of length 0, 1 and below the seed, all-N and
    lowercase reads, and the 32 contigs; each SAM equal to the port's on
    the CPU (which the tests above hold to JAX's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's card path")
    from longreadmapper_tpu_torch.ops import seed_vote as tsv
    from longreadmapper_tpu_torch.ops.traceback import device_traceback_c
    fa = _small(tmp_path)
    many, contigs = _many(tmp_path)
    for path in (fa, many):
        build_index(path, Params(hlen=HLEN), verbose=False, device=None)
    sets = [(fa, _inputs(_cat(fa))),
            (many, {"32 contigs": [(f"q{k}", contigs[k][1][100:280], None)
                                   for k in (0, 17, 31)]})]
    n = (tsv.seed_tables.launches, tsv.vote_rows.launches,
         device_traceback_c.launches)
    plain = (tsv.seed_tables_plain.cuda_calls, tsv.vote_rows_plain.cuda_calls)
    for path, inputs in sets:
        mappers = {}
        for dev in ("cuda", "cpu"):
            idx, meta, mta = load_device_index(path, dev, verbose=False)
            mappers[dev] = TorchMapper(idx, meta, mta, Params(hlen=HLEN),
                                       chunk_b=8, device=dev)
        for case, reads in inputs.items():
            got = _sam(mappers["cuda"], reads)
            assert got == _sam(mappers["cpu"], reads), case
            _check_structure(got, mta)
    assert tsv.seed_tables.launches > n[0] and tsv.vote_rows.launches > n[1]
    assert device_traceback_c.launches > n[2]
    assert (tsv.seed_tables_plain.cuda_calls,
            tsv.vote_rows_plain.cuda_calls) == plain
