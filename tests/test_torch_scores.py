"""Banded score rows of the port against the JAX package: the plain
ops/wavefront.banded_nw_scores / banded_nw_ed against JAX's (the XLA
contract that tests/test_ops.py holds the Pallas kernel
ops/wavefront_pallas.banded_nw_scores_pallas to; the Pallas kernel has no
interpret entry), and the ops/band_scores.py wrappers, which run the plain
versions on a CPU tensor and the CUDA kernel csrc/band_scores.cu on a CUDA
tensor.  Every comparison is exact.

The card tests import no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_scores.py
"""

import numpy as np
import pytest
import torch

from _torch_parity import mutate_rows

torch.set_num_threads(1)


def _inputs(seed, B, L, n_edits=6, pad=8):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = mutate_rows(rng, q, n_edits, pad=pad)
    return q, t


@pytest.mark.parametrize("B,L,W,band", [(4, 64, 16, 48), (3, 128, 24, 64),
                                        (2, 160, 40, 640),
                                        (2, 96, 300, 768)])
def test_plain_scores_match_jax(B, L, W, band):
    import jax.numpy as jnp
    from longreadmapper_tpu.ops.wavefront import banded_nw_scores
    from longreadmapper_tpu_torch.ops import wavefront as tw
    q, t = _inputs(B * L + band, B, L, n_edits=L // 16)
    want = np.asarray(banded_nw_scores(jnp.asarray(q), jnp.asarray(t), W,
                                       band))
    got = tw.banded_nw_scores(torch.from_numpy(q), torch.from_numpy(t), W,
                              band).numpy()
    assert got.dtype == np.int16 and got.shape == (L + 1, B, band)
    np.testing.assert_array_equal(got, want)
    assert (got == tw.INF).any() and (got < tw.INF).any()


def test_plain_ed_matches_jax_ragged():
    """Ragged lengths, a pad row and a band > 512: ed = H[len_b, b, W]."""
    import jax.numpy as jnp
    from longreadmapper_tpu.ops.wavefront import banded_nw_ed
    from longreadmapper_tpu_torch.ops import wavefront as tw
    B, L, W, band = 5, 192, 260, 640
    q, t = _inputs(3, B, L, n_edits=12, pad=24)
    lens = np.array([192, 150, 7, 0, 168], np.int32)
    for b in range(B):
        q[b, lens[b]:] = 4
    ed_w, H_w = banded_nw_ed(jnp.asarray(q), jnp.asarray(t),
                             jnp.asarray(lens), W, band)
    ed, H = tw.banded_nw_ed(torch.from_numpy(q), torch.from_numpy(t),
                            torch.from_numpy(lens), W, band)
    assert ed.dtype == torch.int32
    np.testing.assert_array_equal(ed.numpy(), np.asarray(ed_w))
    np.testing.assert_array_equal(H.numpy(), np.asarray(H_w))
    assert ed[3] == 0


def test_wrappers_run_plain_versions_on_cpu():
    from longreadmapper_tpu_torch.ops.band_scores import (band_checkpoints,
                                                          band_scores)
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_scores
    q, t = (torch.from_numpy(a) for a in _inputs(5, 3, 128, n_edits=5))
    before = band_scores.launches
    assert torch.equal(band_scores(q, t, 20, 128),
                       banded_nw_scores(q, t, 20, 128))
    for g, w in zip(band_checkpoints(q, t, 32, 20, 128),
                    gact_forward(q, t, 32, 20, 128)):
        assert torch.equal(g, w)
    assert band_scores.launches == before          # no kernel launch


def test_checkpoints_are_rows_of_the_score_matrix():
    """gact_forward's ckpt[k] is H row k*T and its wcol H[:, :, W]."""
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_scores
    B, L, T, W, band = 3, 256, 64, 30, 128
    q, t = (torch.from_numpy(a) for a in _inputs(8, B, L, n_edits=10))
    H = banded_nw_scores(q, t, W, band)
    ckpt, wcol = gact_forward(q, t, T, W, band)
    assert torch.equal(ckpt.to(torch.int16), H[::T])
    assert torch.equal(wcol, H[:, :, W])


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,band,T", [(128, 1024, 102, 256, 0),
                                          (16, 1024, 600, 1280, 0),
                                          (8, 2048, 2000, 4096, 512),
                                          (4, 512, 5017, 10112, 128)])
def test_kernel_matches_plain_on_card(B, L, W, band, T):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from longreadmapper_tpu_torch.ops.band_scores import (band_checkpoints,
                                                          band_scores)
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_scores
    q, t = _inputs(13, B, L, n_edits=L // 20, pad=L // 16)
    qd, td = torch.from_numpy(q).cuda(), torch.from_numpy(t).cuda()
    if T == 0:
        got, want = [band_scores(qd, td, W, band)], [
            banded_nw_scores(qd, td, W, band)]
    else:
        got = band_checkpoints(qd, td, T, W, band)
        want = gact_forward(qd, td, T, W, band)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
