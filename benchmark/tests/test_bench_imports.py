"""Nothing the benchmark runs imports JAX or the JAX package, by the whole
top-level name (the port's name begins with the JAX package's), and the
yardstick (generator, reference, comparison, peaks, reduction) imports
nothing of the program either."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.run import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "longreadmapper_tpu"}
YARDSTICK = ("traffic.py", "reference.py", "judge.py", "peaks.py",
             "reduce.py", "devtrace.py", "control.py")


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_jax_by_top_level_name(path):
    assert not _top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "longreadmapper_tpu_torch" not in _top_imports(
        os.path.join(BENCH, name))


def test_top_level_name_is_compared_whole():
    assert "longreadmapper_tpu_torch".split(".")[0] not in FORBIDDEN


def test_loaded_modules_after_import():
    """The harness and the port it drives, imported as a run imports them,
    load no forbidden module."""
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run as r;"
            " import benchmark.control, benchmark.judge;"
            " r.build_mapper; import longreadmapper_tpu_torch.models.mapper,"
            " longreadmapper_tpu_torch.index.device;"
            " print(r.loaded_forbidden())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
