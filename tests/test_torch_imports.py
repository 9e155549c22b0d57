"""The port's import rule: no module of longreadmapper_tpu_torch, and not
chip_smoke.py, imports `longreadmapper_tpu` or `jax`.  An AST scan holds
the source to it, and a fresh process that refuses both packages at import
indexes a genome (the lchash by the device build, on the CPU) and maps
reads through the port's CLI in the full and the slim layout; each SAM
equals the SAM of the JAX package's TPUMapper (through the JAX CLI) in
this process.
The host suffix-array build fails loudly, with g++'s message, when its
source does not compile."""

import ast
import contextlib
import glob
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import make_genome, sample_reads, write_fasta, write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("longreadmapper_tpu", "jax", "jaxlib")


def forbidden_imports(source: str, filename: str = "<src>"):
    """(line, module) of every import of a forbidden package in `source`
    (relative imports stay inside the package and are allowed)."""
    bad = []
    for node in ast.walk(ast.parse(source, filename)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


def _port_sources():
    files = sorted(glob.glob(os.path.join(REPO, "longreadmapper_tpu_torch",
                                          "**", "*.py"), recursive=True))
    return files + [os.path.join(REPO, "chip_smoke.py")]


def test_scanner_finds_forbidden_imports():
    src = ("import os\nimport jax.numpy as jnp\n"
           "from longreadmapper_tpu.formats import sam\n"
           "from longreadmapper_tpu_torch.ops import gact\n"
           "from . import cli\nfrom ..formats.sam import sam_record\n"
           "def f():\n    import longreadmapper_tpu\n")
    assert forbidden_imports(src) == [(2, "jax.numpy"),
                                      (3, "longreadmapper_tpu.formats"),
                                      (8, "longreadmapper_tpu")]


def test_port_sources_import_no_jax_package():
    files = _port_sources()
    assert len(files) > 30
    bad = {}
    for path in files:
        with open(path) as f:
            found = forbidden_imports(f.read(), path)
        if found:
            bad[os.path.relpath(path, REPO)] = found
    assert bad == {}


_BLOCKED_RUN = r"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("longreadmapper_tpu", "jax", "jaxlib"):
            raise ModuleNotFoundError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
from longreadmapper_tpu_torch import cli
assert cli.main(["index", sys.argv[1], "--hlen", "6", "--device", "cpu",
                 "--quiet"]) == 0
for layout in ([], ["--slim-index"]):
    assert cli.main(["map", sys.argv[1], sys.argv[2], "1000", "20", "300",
                     "--chunk-b", "8", "--rg-id", "0", "--device", "cpu",
                     "--quiet"] + layout) == 0
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("longreadmapper_tpu", "jax", "jaxlib")]
assert not loaded, loaded
"""


def test_cli_maps_with_jax_package_refused(tmp_path):
    rng = np.random.default_rng(41)
    genome = make_genome(rng, 20000, n_frac=0.005)
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    os.makedirs(port)
    os.makedirs(jax_dir)
    fa = str(port / "ref.fa")
    write_fasta(fa, [("c1", genome[:14000]), ("c2", genome[14000:])])
    clean = genome.replace("N", "A")
    fq = str(tmp_path / "reads.fq")
    write_fastq(fq, sample_reads(rng, clean[:14000], 4, 1000,
                                 error_rate=0.02)
                + sample_reads(rng, clean[14000:], 2, 1000, error_rate=0.0))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, fa, fq],
                       capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = r.stdout

    from longreadmapper_tpu import cli as jcli
    jfa = str(jax_dir / "ref.fa")
    write_fasta(jfa, [("c1", genome[:14000]), ("c2", genome[14000:])])
    assert jcli.main(["index", jfa, "--hlen", "6", "--host-only",
                      "--quiet"]) == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(["map", jfa, fq, "1000", "20", "300", "--chunk-b",
                          "8", "--rg-id", "0", "--quiet"]) == 0
    want = buf.getvalue()
    assert want.count("\n") == 6 + 4         # @SQ x2, @RG, @PG + records
    assert "\t1000M\t" in want
    assert got == want + want                # full, then slim


def test_sais_build_failure_raises_with_compiler_message(tmp_path,
                                                         monkeypatch):
    from longreadmapper_tpu_torch import native_build
    (tmp_path / "sais.cpp").write_text("int lrm_sais_u8( {\n")
    monkeypatch.setattr(native_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError,
                       match=r"(?s)sais\.cpp: g\+\+ exit 1.*error"):
        native_build.build(names=("sais",))
    assert not os.path.exists(native_build.lib_path("sais"))
