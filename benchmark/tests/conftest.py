"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of the repository (the repository's `pytest tests/` does not collect
them).  Tests that need the card carry the `cuda` marker and skip here."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


# a cell small enough for the CPU: two contigs with repeats of each
# placement (a family longer than the reads, so reads tie between its
# copies), reads in the 3072 bucket (so the first pass runs at half band
# and the reads past it take the full-band retry), eight reads a chunk,
# hlen 8, the cells' read model
TINY_CONFIG = {"genome": {
    "contigs": [["c1", 40000], ["c2", 30000]], "gc": 0.45,
    "repeats": [
        {"family": "tandem", "length": 3500, "copies": 2,
         "placement": "tandem", "contig": "c1", "at": 20000},
        {"family": "end", "length": 1200, "copies": 3,
         "placement": "telomeric"},
        {"family": "mobile", "length": 1300, "copies": 6,
         "placement": "scattered"}]},
    "mapper": {"seed_len": 20, "thres": 300, "chunk_b": 24, "hlen": 8}}
TINY_TRAFFIC = {"lengths": {"mean": 15000, "stdev": 13000, "min": 2049,
                            "max": 3072},
                "identity": {"mean": 0.95, "max": 0.99, "stdev": 0.025},
                "errors": {"sub": 1 / 3, "ins": 1 / 3, "dele": 1 / 3},
                "chunk_reads": 8, "reverse_share": 0.5, "pool_chunks": 3,
                "qual": "I", "check": {"reads": 16, "keep_share": 1.0}}


@pytest.fixture
def tiny_cell():
    import json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    return dict(workload={"name": "tiny", "chips": 1},
                config=json.loads(json.dumps(TINY_CONFIG)),
                traffic=json.loads(json.dumps(TINY_TRAFFIC)),
                end_to_end=spec["end_to_end"], per_layer=spec["per_layer"])
