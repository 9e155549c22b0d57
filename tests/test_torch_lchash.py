"""The port's lchash builds against the JAX package: `lc_build_device`
(the batched backward search, here on the CPU in small uneven chunks,
with (k, l) seeded in occ_samp's dtype and in int64) equals JAX's
lc_build_device and lc_build_from_sa, including the reference's
terminal-row quirk; and `cli index --device cpu` (the device build)
writes the five artifacts and the devidx cache byte-identical to JAX
`cli index --host-only` and to the port's own `--host-only`."""

import os

import numpy as np
import pytest
import torch

from conftest import make_genome, write_fasta
from _torch_parity import build_both
from longreadmapper_tpu.index.device import build_device_index
from longreadmapper_tpu.index.lchash import lc_build_device as j_build
from longreadmapper_tpu_torch.index.device import DeviceIndex, bwt_arrays
from longreadmapper_tpu_torch.index.lchash import (lc_build_device,
                                                   lc_build_from_sa)
from longreadmapper_tpu_torch.index.fmi import encode_bytes

torch.set_num_threads(1)


def _genome(kind: str, rng) -> list:
    if kind == "two_contigs_n":
        g = make_genome(rng, 9000, n_frac=0.01)
        return [("a", g[:5000]), ("b", g[5000:])]
    if kind == "three_contigs":
        g = make_genome(rng, 6000)
        return [("a", g[:1000]), ("b", g[1000:4500]), ("c", g[4500:])]
    return [("a", make_genome(rng, 7000))]


@pytest.mark.parametrize("hlen,kind,seed_dtype", [
    (6, "plain", None), (7, "two_contigs_n", None), (8, "plain", None),
    (6, "three_contigs", None), (7, "plain", torch.int64)])
def test_lc_build_device_matches_jax(tmp_path, hlen, kind, seed_dtype):
    rng = np.random.default_rng(hlen * 7 + len(kind))
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, _genome(kind, rng))
    d = build_both(fa, hlen)
    codes = encode_bytes(d["cat"])
    n = codes.shape[0]
    # the reference's terminal-row quirk applies: the k-mer before '$'
    # (create_meta replaces every N) is real and its interval is bumped
    term = codes[n - 1 - hlen:n - 1]
    assert (term < 4).all()
    host = lc_build_from_sa(d["fmi"].sa, codes, hlen)
    jidx, jmeta = build_device_index(
        d["fmi"], np.zeros((1 << (2 * hlen), 2), np.uint64), hlen, d["cat"],
        d["mta"])
    want = j_build(jidx.packed, jidx.occ_samp, jidx.c4, jmeta.dollar_pos,
                   jmeta.n, hlen, chunk=1 << 10)
    arrays, dollar_pos = bwt_arrays(d["fmi"])
    idx = DeviceIndex.from_arrays(dict(arrays, c4=d["fmi"].c4().astype(
        np.int32)), "cpu")
    got = lc_build_device(idx.packed, idx.occ_samp, idx.c4, dollar_pos, n,
                          hlen, chunk=1000, pos_dtype=seed_dtype)
    assert got.dtype == np.uint64 and got.shape == (1 << (2 * hlen), 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, d["kl"])
    assert (got[:, 1] > 0).sum() > (1 << (2 * hlen)) // 8


def _artifacts(fa):
    names = [fa + ext for ext in (".mta", ".cat", ".cat.sa5", ".cat.mfi",
                                  ".cat.lch")]
    dd = fa + ".cat.devidx"
    names += [os.path.join(dd, f) for f in sorted(os.listdir(dd))]
    return {os.path.relpath(p, os.path.dirname(fa)): open(p, "rb").read()
            for p in names}


def test_cli_index_device_cpu_matches_jax_host_only(tmp_path):
    from longreadmapper_tpu import cli as jcli
    from longreadmapper_tpu_torch import cli as tcli
    rng = np.random.default_rng(12)
    genome = make_genome(rng, 16000, n_frac=0.005)
    runs = (("jax", jcli.main, ["--host-only"]),
            ("device", tcli.main, ["--device", "cpu"]),
            ("host", tcli.main, ["--host-only"]))
    out = {}
    for name, main, extra in runs:
        os.makedirs(tmp_path / name)
        fa = str(tmp_path / name / "ref.fa")
        write_fasta(fa, [("c1", genome[:9000]), ("c2", genome[9000:])])
        assert main(["index", fa, "--hlen", "7", "--quiet"] + extra) == 0
        out[name] = _artifacts(fa)
    assert len(out["jax"]) >= 5 + 8                # 5 artifacts, arrays, meta
    for name in ("device", "host"):
        assert sorted(out[name]) == sorted(out["jax"])
        for k in out["jax"]:
            assert out[name][k] == out["jax"][k], (name, k)
