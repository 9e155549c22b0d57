"""The whole mapping step of the port (mapping/pipeline.map_step) against
the JAX make_map_step: the same packed chunk goes in, `blob` (meta words +
eager CIGAR head) and `ops_tail` must be byte-equal.  Cases: a mixed
chunk with unmapped junk and indel-heavy reads (so the tail is non-empty),
the exact-slots retry configuration, and wide (LF-narrowed) seeds."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import sample_reads
from _torch_parity import e2e_fixture, repeat_fixture
from longreadmapper_tpu.mapping import pipeline as jpipe
from longreadmapper_tpu.utils.config import Params
from longreadmapper_tpu_torch.mapping import pipeline as tpipe
from longreadmapper_tpu_torch.models.mapper import TorchMapper

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    return e2e_fixture(tmp_path_factory.mktemp("torch_step"))


def _indel_read(rng, genome, L, n_ind):
    p = int(rng.integers(0, len(genome) - L - 40))
    s = list(genome[p:p + L + 20])
    for _ in range(n_ind):
        q = int(rng.integers(5, len(s) - 5))
        if rng.random() < 0.5:
            del s[q]
        else:
            s.insert(q, "ACGT"[int(rng.integers(0, 4))])
    return "".join(s[:L])


def _step_both(d, params, reads, B, L, **kw):
    jc = replace(jpipe.MapperConfig.from_params(params, d["meta"], B, L), **kw)
    tc = replace(tpipe.MapperConfig.from_params(params, d["tmeta"], B, L),
                 **kw)
    tm = TorchMapper(d["tidx"], d["tmeta"], d["mta"], params, chunk_b=B,
                     device="cpu")
    packed = tm._pack_reads(reads, L, B)
    want = jpipe.make_map_step(jc)(d["idx"],
                                   *(jnp.asarray(a) for a in packed))
    got = tpipe.map_step(tc, d["tidx"],
                         *(torch.from_numpy(a) for a in packed))
    for k in ("blob", "ops_tail"):
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == np.int8 and g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)
    return got


@pytest.mark.parametrize("exact", [False, True])
def test_step_bytes_match_jax(e2e, exact):
    params = Params(hlen=6, seed_len=20, thres=300)
    rng = np.random.default_rng(17)
    reads = sample_reads(rng, e2e["chrA"], 8, 230, error_rate=0.03) + \
        sample_reads(rng, e2e["chrB"], 3, 120, error_rate=0.01)
    reads = [(n, s, None) for n, s, *_ in reads]
    reads += [(f"ind{i}", _indel_read(rng, e2e["chrA"], 250, 8), None)
              for i in range(3)]
    reads.append(("junk", "".join("ACGT"[c] for c in
                                  rng.integers(0, 4, 200)), None))
    got = _step_both(e2e, params, reads, 16, 256, exact_slots=exact)
    meta = got["blob"][:, :32].contiguous().view(torch.int32)
    assert meta[:len(reads) - 1, 1].sum() >= 12          # mostly found
    if not exact:
        # indel-heavy reads overflow the 16-byte eager head into the tail
        assert (got["ops_tail"].numpy() & 3 != 3).any()


def test_step_bytes_match_jax_wide_seeds(tmp_path):
    d = repeat_fixture(tmp_path)
    _step_both(d, Params(hlen=6, thres=30), d["reads"], 8, 256)


def test_step_marks_stages_in_order_without_changing_bytes(e2e):
    params = Params(hlen=6, seed_len=20, thres=300)
    rng = np.random.default_rng(19)
    reads = [(n, s, None) for n, s, *_ in
             sample_reads(rng, e2e["chrA"], 8, 200, error_rate=0.03)]
    cfg = tpipe.MapperConfig.from_params(params, e2e["tmeta"], 8, 256)
    tm = TorchMapper(e2e["tidx"], e2e["tmeta"], e2e["mta"], params,
                     chunk_b=8, device="cpu")
    args = [torch.from_numpy(a) for a in tm._pack_reads(reads, 256, 8)]
    stages = []
    got = tpipe.map_step(cfg, e2e["tidx"], *args, mark=stages.append)
    want = tpipe.map_step(cfg, e2e["tidx"], *args)
    assert stages == ["seed_tables", "narrow", "vote_rows", "accept",
                      "locate_window", "band_dp", "walk", "pack"]
    for k in ("blob", "ops_tail"):
        assert torch.equal(got[k], want[k]), k
