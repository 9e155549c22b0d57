"""The control comes out wrong: the plain reference in the program's place
without the full-band retry tier (a read whose distance reaches its
bucket's first-pass half band reported unmapped) fails the comparison on
every seed.  On the card benchmark/control.py runs it at each cell's own
size."""

import pytest

from benchmark.control import control_counts


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
def test_control_fails_the_comparison(tiny_cell, seed):
    c = control_counts(tiny_cell, seed, "cpu")
    assert c["sampled_full_band"] >= 1
    assert c["records_wrong"] >= 1
    # what it gets wrong is the broken guarantee: mapped reads reported
    # unmapped, nothing else
    assert c["flag"] == c["records_wrong"] == c["ed"]
    assert c["pos"] == c["contig"] == c["seq"] == 0
