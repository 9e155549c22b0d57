"""longreadmapper_tpu_torch — the PyTorch/CUDA port of longreadmapper_tpu.

The `map` path of the JAX package for short and long reads (index build
and load, seed-vote, locate, banded DP, column and tiled gact walks, SAM)
rewritten as plain PyTorch functions on tensors with an explicit `device`,
plus hand-written CUDA kernels for Hopper in `csrc/`: the banded
edit-distance DP with direction words (`band_dp.cu`, wrapper
`ops/band_dp.py`) and with score rows (`band_scores.cu`, wrapper
`ops/band_scores.py`).  Module names mirror `longreadmapper_tpu` so each
module's counterpart is found by path.

The JAX package is the reference: the tests feed both packages the same
inputs and require equal outputs, bit for bit.  Import rule: no module of
this package, and not `chip_smoke.py`, imports `longreadmapper_tpu` (any of
it, JAX-free host modules included) or `jax`.  What the port needs of the
reference's host code it keeps as its own copies under the same names:
`formats/` (the index artifacts, FASTA/FASTQ, SAM), `utils/` (`Params`,
`auto_hlen`, `read_params`, `new_logger`) and `csrc/sais.cpp` (the in-RAM
suffix-array build, compiled with g++ at first use).  The files it writes
are byte-identical to the JAX package's, so both share one index.
`tests/test_torch_imports.py` holds the rule.
"""

__version__ = "0.1.0"
