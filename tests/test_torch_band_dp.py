"""Band DP of the port (ops/wavefront.py plain version, ops/band_dp.py
wrapper of the CUDA kernel) against the JAX package: the XLA scan
ops/wavefront.banded_nw_dirs_v(with_nm=True) and the Pallas kernel
ops/band_pallas.banded_nw_dirs_vt in interpret mode.  Every comparison is
exact.

The card test imports no JAX, so it also runs where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_band_dp.py
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


def _port(q, t, W, band):
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_dirs_v
    v, w, nm = banded_nw_dirs_v(torch.from_numpy(q), torch.from_numpy(t),
                                W, band)
    return v.numpy(), w.numpy(), nm.numpy()


@pytest.mark.parametrize("B,L,W,band", [(4, 64, 16, 48), (3, 128, 24, 64)])
def test_plain_dp_matches_xla_scan(B, L, W, band):
    import jax.numpy as jnp
    from longreadmapper_tpu.ops.wavefront import banded_nw_dirs_v
    q, t = _inputs(B * L, B, L)
    v, w, nm = banded_nw_dirs_v(jnp.asarray(q), jnp.asarray(t), W, band,
                                with_nm=True)
    pv, pw, pnm = _port(q, t, W, band)
    assert pv.dtype == np.int32 and pw.dtype == np.int16
    np.testing.assert_array_equal(pv, np.asarray(v))
    np.testing.assert_array_equal(pw, np.asarray(w))
    np.testing.assert_array_equal(pnm, np.asarray(nm).view(np.int32))


@pytest.mark.parametrize("B,L,W,band", [(4, 64, 16, 48), (3, 128, 24, 64)])
def test_plain_dp_matches_pallas_interpret(B, L, W, band):
    import jax.numpy as jnp
    from longreadmapper_tpu.ops.band_pallas import banded_nw_dirs_vt
    q, t = _inputs(B * L + 1, B, L)
    vT, w = banded_nw_dirs_vt(jnp.asarray(q), jnp.asarray(t), W, band,
                              interpret=True)
    pv, pw, _ = _port(q, t, W, band)
    np.testing.assert_array_equal(pv, np.asarray(vT).transpose(0, 2, 1))
    np.testing.assert_array_equal(pw, np.asarray(w))


def test_plain_dp_two_nm_words():
    """L = 528: G = 33 groups, so nm carries two words per (b, d) and the
    33rd group lands in bit 0 of the second."""
    import jax.numpy as jnp
    from longreadmapper_tpu.ops.wavefront import banded_nw_dirs_v
    B, L, W, band = 3, 528, 52, 128
    q, t = _inputs(7, B, L, n_edits=20, pad=16)
    v, w, nm = banded_nw_dirs_v(jnp.asarray(q), jnp.asarray(t), W, band,
                                with_nm=True)
    pv, pw, pnm = _port(q, t, W, band)
    assert pnm.shape == (2, B, band)
    np.testing.assert_array_equal(pv, np.asarray(v))
    np.testing.assert_array_equal(pw, np.asarray(w))
    np.testing.assert_array_equal(pnm, np.asarray(nm).view(np.int32))
    assert (pnm[1] & ~1).max() == 0 and pnm[1].any()


def test_wrapper_runs_plain_version_on_cpu():
    from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_dirs_v
    q, t = _inputs(3, 5, 128, n_edits=4)
    before = banded_nw_dirs.launches
    got = banded_nw_dirs(torch.from_numpy(q), torch.from_numpy(t), 12, 128)
    want = banded_nw_dirs_v(torch.from_numpy(q), torch.from_numpy(t), 12,
                            128)
    assert banded_nw_dirs.launches == before      # no kernel launch
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,band", [(2048, 1024, 102, 256),
                                        (37, 128, 12, 128),
                                        (64, 2048, 204, 512),
                                        (9, 512, 0, 128), (9, 512, 127, 128),
                                        (9, 768, 0, 256), (9, 768, 255, 256),
                                        (9, 1024, 0, 384),
                                        (9, 1024, 383, 384),
                                        (9, 1024, 0, 512),
                                        (9, 1024, 511, 512)])
def test_kernel_matches_plain_on_card(B, L, W, band):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from longreadmapper_tpu_torch.ops.band_dp import _band_dp
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_dirs_v
    q, t = _inputs(11, B, L, n_edits=30, pad=L // 16)
    qd = torch.from_numpy(q).cuda()
    td = torch.from_numpy(t).cuda()
    got = _band_dp(qd, td, W, band)        # the warp kernel at every band
    want = banded_nw_dirs_v(qd, td, W, band)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
