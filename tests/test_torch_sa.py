"""The port's suffix-array builds against the JAX package: the card-side
prefix doubling `sa_build_device` (here on the CPU) against JAX
`sa_build_xla` and the native SA-IS; the external-memory build against
JAX's in both its merges (native and `LRM_SA_MERGE=py`), byte for byte;
`sa_build`'s routing by `ram_use`; `cli index --ram-gb --device cpu`
against JAX `index --ram-gb --host-only` and the port's in-RAM build, all
five artifacts and the devidx cache; the native merge's 64-bit count and
its failure."""

import ctypes
import os

import numpy as np
import pytest
import torch

from conftest import make_genome, write_fasta
from test_torch_lchash import _artifacts
from longreadmapper_tpu import native
from longreadmapper_tpu.index.sa import sa_build_xla
from longreadmapper_tpu.index.sa_external import \
    sa_build_external as j_external
from longreadmapper_tpu_torch import native_build
from longreadmapper_tpu_torch.formats.ui40 import read_sa5
from longreadmapper_tpu_torch.index.fmi import encode_bytes
from longreadmapper_tpu_torch.index.sa import sa_build, sa_build_device
from longreadmapper_tpu_torch.index.sa_external import (_MERGE,
                                                        sa_build_external,
                                                        sa_merge_files)

torch.set_num_threads(1)


def _text(case: str) -> bytes:
    """Texts over ACGT ending in the one '$' (N is outside the contract:
    encode_bytes maps it to 4 like '$')."""
    rng = np.random.default_rng(len(case))
    if case == "random":
        return rng.choice(list(b"ACGT"), 5000).astype(np.uint8).tobytes() \
            + b"$"
    if case == "tandem7":
        return b"ACGTGCA" * 400 + b"$"
    if case == "aca_run":
        return b"ACA" * 700 + b"A" * 500 + b"$"
    if case == "homopolymer":
        return b"A" * 1023 + b"$"
    if case == "two":
        return b"A$"
    return b"$"


# "dollar" (n = 1) runs its only round with k = 1 >= n, where JAX's dynamic
# slice clamps; with one terminator every other text ends with k <= its
# longest repeat < n
@pytest.mark.parametrize("case", ["random", "tandem7", "aca_run",
                                  "homopolymer", "two", "dollar"])
def test_sa_build_device_matches_jax_and_native(case):
    text = _text(case)
    codes = encode_bytes(np.frombuffer(text, np.uint8))
    got = sa_build_device(codes, device="cpu")
    want = sa_build_xla(codes)
    assert got.dtype == np.int64 and got.shape == (len(text),)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, native.suffix_array(np.frombuffer(text, np.uint8)))
    # rounds: k = 1, 2, 4, ... until the 2k-prefixes are distinct
    assert 1 <= sa_build_device.rounds <= max(1, len(text).bit_length())


# the cases of tests/test_sa_external.py: (text, ram bytes, margin)
def _ext_case(case: str):
    rng = np.random.default_rng(3 if case == "mixed" else len(case))
    if case.startswith("random"):
        n, ram, margin = {"random10": (5_000, 6_000, 32),
                          "random24": (60_000, 30_000, 64),
                          "random1": (999, 10 ** 9, 32)}[case]
        text = rng.choice(list(b"ACGT"), n).astype(np.uint8).tobytes() + b"$"
        return text, ram, margin
    if case == "satellite":
        return b"ACGTGCA" * 3000 + b"$", 12_000, 32
    motif = rng.choice(list(b"ACGT"), 60).astype(np.uint8).tobytes()
    parts = [motif if rng.random() < 0.5 else
             rng.choice(list(b"ACGT"), 100).astype(np.uint8).tobytes()
             for _ in range(200)]
    return b"".join(parts) + b"$", 9_000, 48


@pytest.mark.parametrize("mode", ["native", "py"])
@pytest.mark.parametrize("case", ["random10", "random24", "random1",
                                  "satellite", "mixed"])
def test_sa_build_external_matches_jax(tmp_path, monkeypatch, case, mode):
    text, ram, margin = _ext_case(case)
    out = {}
    for pkg, build in (("jax", j_external), ("torch", sa_build_external)):
        os.makedirs(tmp_path / pkg)
        p = str(tmp_path / pkg / "t.cat")
        with open(p, "wb") as f:
            f.write(text)
        monkeypatch.setenv("LRM_SA_MERGE", mode)   # read by JAX's only
        got = build(p, ram, margin=margin, tmpdir=str(tmp_path / pkg))
        blocks = got if pkg == "torch" else None
        with open(p + ".sa5", "rb") as f:
            out[pkg] = f.read()
        assert sorted(os.listdir(tmp_path / pkg)) == ["t.cat", "t.cat.sa5"]
    assert out["torch"] == out["jax"]
    want_blocks = -(-len(text) // max(4 * margin, ram // 12))
    assert blocks == want_blocks and (case == "random1" or blocks >= 5)
    np.testing.assert_array_equal(
        read_sa5(str(tmp_path / "torch" / "t.cat.sa5")),
        native.suffix_array(np.frombuffer(text, np.uint8)))


@pytest.mark.parametrize("route", ["external", "in_ram"])
def test_sa_build_routes_by_ram_use(tmp_path, monkeypatch, route):
    from longreadmapper_tpu_torch.formats.catmeta import create_meta
    from longreadmapper_tpu_torch.index import sa_external
    rng = np.random.default_rng(5)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, [("c1", make_genome(rng, 40000))])
    create_meta(fa, n_seed=0)
    prefix = fa + ".cat"
    n = os.path.getsize(prefix)
    want = sa_build(prefix)
    with open(prefix + ".sa5", "rb") as f:
        want_bytes = f.read()
    os.unlink(prefix + ".sa5")
    calls, heard = [], []
    real = sa_external.sa_build_external
    monkeypatch.setattr(sa_external, "sa_build_external",
                        lambda *a: calls.append(a) or real(*a))
    # ~5 blocks of 16384 (4 x the default margin), or exactly the in-RAM
    # footprint, which stays in RAM
    ram = 16384 * 12 if route == "external" else n * 12
    got = sa_build(prefix, ram_use=ram,
                   log=lambda fmt, *a: heard.append(fmt % a))
    np.testing.assert_array_equal(got, want)
    with open(prefix + ".sa5", "rb") as f:
        assert f.read() == want_bytes
    if route == "external":
        assert calls == [(prefix, ram)]
        assert heard == [f"sa_build: external build, {-(-n // 16384)} "
                         f"blocks within {ram} bytes"]
        assert n // 16384 >= 4
    else:
        assert calls == [] and heard == []


@pytest.mark.parametrize("kind", ["random", "tandem"])
def test_cli_index_ram_gb_matches_jax_and_in_ram(tmp_path, kind):
    """Six blocks of 16384 chars (the block floor at the default margin):
    the external build with the lchash on the device (CPU), against JAX's
    external build with the host lchash and the port's in-RAM build."""
    from longreadmapper_tpu import cli as jcli
    from longreadmapper_tpu_torch import cli as tcli
    rng = np.random.default_rng(17)
    if kind == "random":
        genome = make_genome(rng, 48000)
    else:   # an 8.4 kb period-7 satellite: margin-equal runs to repair
        genome = (make_genome(rng, 20000) + "ACGTGCA" * 1200
                  + make_genome(rng, 19600))
    ram_gb = "0.00002"                        # 21474 bytes: 16384-char blocks
    runs = (("jax", jcli.main, ["--host-only", "--ram-gb", ram_gb]),
            ("torch", tcli.main, ["--device", "cpu", "--ram-gb", ram_gb]),
            ("in_ram", tcli.main, ["--device", "cpu"]))
    out = {}
    for name, main, extra in runs:
        os.makedirs(tmp_path / name)
        fa = str(tmp_path / name / "ref.fa")
        write_fasta(fa, [("c1", genome[:30000]), ("c2", genome[30000:])])
        assert main(["index", fa, "--hlen", "7", "--quiet"] + extra) == 0
        out[name] = _artifacts(fa)
    n = len(out["jax"]["ref.fa.cat"])
    assert n == 2 * len(genome) + 1 and -(-n // 16384) == 6
    assert len(out["jax"]) >= 5 + 8                # 5 artifacts, arrays, meta
    for name in ("torch", "in_ram"):
        assert sorted(out[name]) == sorted(out["jax"])
        for k in out["jax"]:
            assert out[name][k] == out["jax"][k], (name, k)


def test_sa_merge_failure_raises(tmp_path):
    text = b"ACGTACGGT$"
    p = str(tmp_path / "t.cat")
    with open(p, "wb") as f:
        f.write(text)
    with pytest.raises(RuntimeError, match=r"wrote -1 of 10 entries"):
        sa_merge_files(p, len(text), [str(tmp_path / "missing.ui40")], [10],
                       p + ".sa5")
    assert not os.path.exists(p + ".sa5")


def test_load_keeps_64_bit_return(tmp_path, monkeypatch):
    """native_build.load types a function's return as its spec says: a
    (argtypes, restype) pair keeps a count past 2^31 (lrm_sa_merge's
    int64_t); a bare argtypes list stays int, as before."""
    (tmp_path / "wide.cpp").write_text(
        '#include <cstdint>\nextern "C" int64_t lrm_wide(int64_t x) '
        '{ return x + (int64_t(1) << 40); }\n')
    monkeypatch.setattr(native_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setitem(native_build.SOURCES, "wide",
                        ("wide.cpp", native_build._gxx, None))
    monkeypatch.setattr(native_build, "_libs", {})
    lib = native_build.load("wide", {"lrm_wide": ([ctypes.c_int64],
                                                  ctypes.c_int64)})
    assert lib.lrm_wide(5) == (1 << 40) + 5
    native_build._libs.clear()
    lib = native_build.load("wide", {"lrm_wide": [ctypes.c_int64]})
    assert lib.lrm_wide(5) == 5                    # truncated to 32 bits
    assert _MERGE["lrm_sa_merge"][1] is ctypes.c_int64


def test_sa_build_device_refuses_2_31_codes():
    class Codes:                 # the length alone: no 2 GB array needed
        shape = (1 << 31,)

    with pytest.raises(ValueError, match="n < 2"):
        sa_build_device(Codes(), device="cpu")
