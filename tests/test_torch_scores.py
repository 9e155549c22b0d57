"""Banded score rows of the port against the JAX package: the plain
ops/wavefront.banded_nw_scores / banded_nw_ed against JAX's (the XLA
contract that tests/test_ops.py holds the Pallas kernel
ops/wavefront_pallas.banded_nw_scores_pallas to; the Pallas kernel has no
interpret entry), and the ops/band_scores.py wrappers, which run the plain
versions on a CPU tensor and the CUDA kernel csrc/band_scores.cu on a CUDA
tensor.  The kernel splits a read's row over a cluster of CTAs; a plain
model of that split (`_sliced_forward`) is held to both packages'
gact_forward, and the cluster chooser `cluster_ctas` to its rule.  Every
comparison is exact.

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


def _sliced_forward(q, t, T, W, band, widths):
    """gact_forward's contract computed as csrc/band_scores.cu splits each
    row over a cluster: the columns in consecutive ranges of `widths` (one
    a CTA; their sum >= band, padding columns only in the last range),
    each with its own slope scan, in which the range's last column leaves
    its up-neighbour out.  Each range publishes a slot (its total, its
    first column of the previous row); a range takes its carry from the
    slots of the ranges before it (each total with its left-out term: the
    next range's first column + 1 at its last column) and its own last
    column's up-neighbour from the next range's slot (INF past the last),
    as the kernel's slots pass them between CTAs."""
    from longreadmapper_tpu_torch.ops.wavefront import INF
    B, L = q.shape
    i32 = torch.int32
    big = torch.iinfo(i32).max
    cols = sum(widths)
    starts = np.cumsum([0] + list(widths[:-1])).tolist()
    assert starts[-1] < band <= cols and L % T == 0
    d = torch.arange(cols, dtype=i32)
    q32 = torch.from_numpy(q).to(i32)
    tpad = torch.full((B, L + W + 1 + cols), 5, dtype=i32)
    tpad[:, W + 1:W + 1 + L] = torch.from_numpy(t).to(i32)
    real = d < band
    h = torch.where(real & (d >= W) & (d - W <= L), d - W, INF).expand(
        B, cols).clone()
    inf_col = torch.full((B, 1), INF, dtype=i32)
    ckpt, wcol = [h[:, :band]], [h[:, W]]
    for i in range(1, L + 1):
        a = h + (q32[:, i - 1:i] != tpad[:, i:i + cols]).to(i32)
        scans, slots = [], []
        for c0, w in zip(starts, widths):
            up = torch.cat([h[:, c0 + 1:c0 + w], inf_col], dim=1)
            A = torch.cummin(torch.minimum(a[:, c0:c0 + w], up + 1)
                             - d[c0:c0 + w], dim=1).values
            scans.append(A)
            slots.append((A[:, -1], h[:, c0]))
        slots.append((None, torch.full((B,), INF, dtype=i32)))
        row = torch.empty_like(h)
        for r, (c0, w) in enumerate(zip(starts, widths)):
            carry = torch.full((B,), big, dtype=i32)
            for r2 in range(r):
                last = starts[r2] + widths[r2] - 1
                carry = torch.minimum(carry, torch.minimum(
                    slots[r2][0], slots[r2 + 1][1] + 1 - last))
            A = scans[r].clone()
            A[:, -1] = torch.minimum(A[:, -1],
                                     slots[r + 1][1] + 1 - (c0 + w - 1))
            row[:, c0:c0 + w] = (torch.minimum(A, carry[:, None])
                                 + d[c0:c0 + w])
        j = i + d - W
        h = torch.where(real & (j >= 0) & (j <= L), row.clamp(max=INF), INF)
        wcol.append(h[:, W])
        if i % T == 0:
            ckpt.append(h[:, :band])
    return torch.stack(ckpt), torch.stack(wcol).to(torch.int16)


@pytest.mark.parametrize("B,L,T,W,band,widths", [
    (3, 256, 64, 64, 128, [128]),                    # C 1
    (2, 256, 32, 127, 128, [64, 96]),                # C 2, W = band - 1
    (3, 320, 64, 128, 256, [96, 128, 64]),           # C 3, centre
    (2, 160, 32, 0, 384, [128, 64, 96, 128]),        # C 4, W 0
    (2, 192, 64, 637, 640, [256, 128, 320]),         # near band - 1
    (2, 128, 32, 320, 640, [160, 160, 160, 192]),    # C 4, centre
    (3, 576, 64, 0, 512, [256, 288]),                # C 2, W 0
    (2, 384, 16, 255, 256, [32, 32, 32, 192]),       # C 4, narrow ranges
])
def test_sliced_rows_match_gact_forward(B, L, T, W, band, widths):
    """The row split over C column ranges, uneven and padded only in the
    last, gives both packages' gact_forward exactly."""
    import jax.numpy as jnp
    from longreadmapper_tpu.ops.gact import gact_forward as jax_forward
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    q, t = _inputs(B * L + band + len(widths), B, L, n_edits=L // 12,
                   pad=L // 16)
    got = _sliced_forward(q, t, T, W, band, widths)
    port = gact_forward(torch.from_numpy(q), torch.from_numpy(t), T, W, band)
    want = jax_forward(jnp.asarray(q), jnp.asarray(t), T, W, band)
    for g, p, w in zip(got, port, want):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] < 0x3FFF).any() and (got[0] == 0x3FFF).any()


def _kernel_takes(band, C):
    """csrc/band_row.cuh cluster_fits at one of cluster_k's K: each CTA at
    most 1024 threads and only the last rank with padding columns."""
    for K in (8, 16, 4):
        threads = -(-(band // K) // (32 * C)) * 32
        if threads <= 1024 and (C - 1) * threads * K < band:
            return True
    return False


@pytest.mark.parametrize("B,band,resident,want", [
    (40, 5120, None, 2),       # a 50 kb pass: 40 clusters of 3 do not fit
    (40, 10112, None, 2),      # its full-band retry
    (39, 5120, None, 3),
    (39, 2176, None, 3),
    (66, 4096, None, 2),
    (67, 4096, None, 1),       # no C runs in one wave
    (200, 2176, None, 1),      # the 10 kb retry
    (8, 16384, None, 4),
    (30, 5120, None, 4),
    (31, 10112, None, 3),
    (3, 1280, None, 1),        # below CLUSTER_MIN_BAND
    (2048, 256, None, 1),      # the 1 kb bucket
    (40, 5120, {2: 57, 3: 38, 4: 28}, 2),      # another card's counts
    (28, 5120, {2: 57, 3: 38, 4: 28}, 4),
    (40, 5120, {2: 39, 3: 26, 4: 19}, 1),
])
def test_cluster_ctas(B, band, resident, want):
    from longreadmapper_tpu_torch.ops.band_scores import cluster_ctas
    if resident is None:
        assert cluster_ctas(B, band) == want
    else:
        assert cluster_ctas(B, band, resident) == want


def test_cluster_ctas_picks_shapes_the_kernel_takes():
    from longreadmapper_tpu_torch.ops.band_scores import (
        H100_RESIDENT, MAX_CTAS, cluster_ctas)
    for band in range(128, 16384 + 1, 128):
        for B in (1, 2, 8, 30, 33, 39, 40, 44, 66, 67, 200):
            C = cluster_ctas(B, band)
            assert 1 <= C <= MAX_CTAS
            assert C == 1 or (B <= H100_RESIDENT[C]
                              and _kernel_takes(band, C))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,band,T,ctas", [
    (8, 2048, 1024, 2176, 512, 2), (8, 2048, 1024, 2176, 512, 3),
    (8, 2048, 1024, 2176, 512, 4),
    (3, 1024, 600, 1280, 256, 3),       # uneven: the last rank half padding
    (3, 1024, 600, 1280, 0, 3),         # the full matrix in a cluster
    (2, 1024, 2508, 5120, 0, 2),
    (4, 2048, 5017, 10112, 512, 3),
    (4, 1024, 10035, 20096, 256, 4),     # the 100 kb retry's checkpoints
    (2, 512, 11000, 22016, 0, 3)])
def test_cluster_kernel_matches_plain_on_card(B, L, W, band, T, ctas):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from longreadmapper_tpu_torch.ops.band_scores import (band_checkpoints,
                                                          band_scores)
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_scores
    q, t = _inputs(17, B, L, n_edits=L // 20, pad=L // 16)
    qd, td = torch.from_numpy(q).cuda(), torch.from_numpy(t).cuda()
    before = band_scores.launches
    if T == 0:
        got = [band_scores(qd, td, W, band, ctas=ctas)]
        want = [banded_nw_scores(qd, td, W, band)]
    else:
        got = band_checkpoints(qd, td, T, W, band, ctas=ctas)
        want = gact_forward(qd, td, T, W, band)
    torch.cuda.synchronize()
    assert band_scores.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,band,T", [(128, 1024, 102, 256, 0),
                                          (16, 1024, 600, 1280, 0),
                                          (8, 2048, 2000, 4096, 512),
                                          (4, 512, 5017, 10112, 128),
                                          (2, 512, 8000, 16384, 128),
                                          # K = 32 at 640 and 1024 threads
                                          (2, 512, 10035, 20096, 128),
                                          (1, 512, 11000, 22016, 0)])
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
