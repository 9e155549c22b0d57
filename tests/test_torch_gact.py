"""The tiled long-read path of the port (ops/gact.py, and the tile entry of
the direction sweep) against the JAX ops/gact.py: the checkpointed forward
pass, the rematerialized column walk (substitutions + indels, the
substitutions-only one-iteration-per-tile case, the adversarial
run-buffer saturation weave of tests/test_gact.py, scale 4), and a tile's
direction words entered from a checkpoint row against JAX's vertical
_dp_row_step.  Every comparison is exact.

The card tests import no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_gact.py
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _pair(seed, B, L, err=0.05, indel=0.02):
    from test_gact import make_pair
    return [np.array(a) for a in
            make_pair(np.random.default_rng(seed), B, L, err, indel)]


def _weave(B=4, L=2048, T=128, C=24, seed=11):
    """tests/test_gact.py's saturation weave: C random bases inserted at
    every even tile start and C deleted at every odd one, so the optimal
    path pays ~C indel rows in every tile."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, 2 * L).astype(np.int8)
    parts, i = [], 0
    for k in range(L // T):
        if k % 2 == 0:
            parts.append(rng.integers(0, 4, C).astype(np.int8))
            parts.append(qs[i:i + T - C])
            i += T - C
        else:
            i += C
            parts.append(qs[i:i + T])
            i += T
    q = np.broadcast_to(qs[:L], (B, L)).copy()
    t = np.broadcast_to(np.concatenate(parts)[:L], (B, L)).copy()
    return q, t, np.full(B, L, np.int32)


def _both(q, t, lens, T, W, band, scale=1, group=1):
    """(JAX, port) outputs of gact_forward and gact_traceback_c; the port
    rematerializes `group` tiles at a time."""
    import jax.numpy as jnp
    from longreadmapper_tpu.ops import gact as jg
    from longreadmapper_tpu_torch.ops import gact as tg
    ck_w, wc_w = jg.gact_forward(jnp.asarray(q), jnp.asarray(t), T, W, band)
    runs_w, sat_w = jg.gact_traceback_c(jnp.asarray(q), jnp.asarray(t), ck_w,
                                        jnp.asarray(lens), T, W, band,
                                        scale=scale)
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    ck, wc = tg.gact_forward(tq, tt, T, W, band)
    runs, sat = tg.gact_traceback_c(tq, tt, ck, torch.from_numpy(lens), T, W,
                                    band, scale=scale, group=group)
    # the port's flag is a 0-dim bool tensor on the input's device
    assert sat.dtype == torch.bool and sat.shape == ()
    return ((np.asarray(ck_w), np.asarray(wc_w), np.asarray(runs_w),
             bool(sat_w)), (ck.numpy(), wc.numpy(), runs.numpy(), bool(sat)))


def _assert_equal(want, got):
    for name, w, g in zip(("ckpt", "wcol", "runs"), want[:3], got[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[3] == want[3]


@pytest.mark.parametrize("T", [64, 128])
def test_gact_forward_and_walk_match_jax(T):
    B, L, W, band = 6, 256, 24, 128
    q, t, lens = _pair(9, B, L)
    lens[2] = 0                                   # a dead lane
    want, got = _both(q, t, lens, T, W, band)
    _assert_equal(want, got)
    assert not got[3]
    # the walk took indels
    assert ((got[2] & 3 == 1) | (got[2] & 3 == 2)).any()


def test_gact_walk_subs_only_one_iteration_per_tile():
    B, L, T, W, band = 4, 512, 128, 32, 128
    q, t, lens = _pair(3, B, L, err=0.05, indel=0.0)
    want, got = _both(q, t, lens, T, W, band)
    _assert_equal(want, got)
    from longreadmapper_tpu_torch.ops import gact as tg
    syncs = tg.gact_traceback_c.host_syncs
    tg.gact_traceback_c(*(torch.from_numpy(a) for a in (q, t, got[0],
                                                         lens)), T, W, band)
    # one iteration per tile plus each tile's closing check, and the final
    # synthetic row-0 D-run iteration at most
    assert tg.gact_traceback_c.host_syncs - syncs <= 2 * (L // T) + 1
    for b in range(B):
        real = got[2][b][(got[2][b] & 3) != 3]
        assert ((real & 3) != 1).all() and (real & 3 == 0).sum() <= L // T
        assert sum(int(e) >> 2 for e in real[real & 3 == 0]) == lens[b]


@pytest.mark.parametrize("scale", [1, 4])
def test_gact_walk_saturation_weave_matches_jax(scale):
    B, L, T, W, band, C = 4, 2048, 128, 32, 128, 24
    q, t, lens = _weave(B, L, T, C)
    want, got = _both(q, t, lens, T, W, band, scale=scale)
    assert int(got[1][L, 0]) == (L // T) * C      # the DP took the weave
    _assert_equal(want, got)
    if scale == 1:
        assert got[3]                             # the flag, never silence


@pytest.mark.parametrize("group", [1, 3, 8])
def test_grouped_walk_matches_jax(group):
    """Tiles rematerialized a group at a time (1, a size that does not
    divide the 8 tiles, all of them): JAX's runs bit for bit."""
    from longreadmapper_tpu_torch.ops import gact as tg
    from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs_tiles
    B, L, T, W, band = 5, 512, 64, 30, 128
    q, t, lens = _pair(17, B, L)
    lens[3] = L - 40                              # a shorter read
    calls = []
    orig = tg.banded_nw_dirs_tiles
    tg.banded_nw_dirs_tiles = lambda *a: calls.append(a[-2:]) or orig(*a)
    try:
        want, got = _both(q, t, lens, T, W, band, group=group)
    finally:
        tg.banded_nw_dirs_tiles = orig
    assert orig is banded_nw_dirs_tiles
    _assert_equal(want, got)
    assert ((got[2] & 3 == 1) | (got[2] & 3 == 2)).any()
    # newest group first, each as large as allowed
    sizes = {1: [1] * 8, 3: [3, 3, 2], 8: [8]}[group]
    assert [n for _, n in calls] == sizes
    assert [k0 for k0, _ in calls] == [8 - sum(sizes[:m + 1])
                                       for m in range(len(sizes))]


def test_plain_tiles_equal_single_tile_loop():
    """The multi-tile entry's plain version (and the wrapper on the CPU,
    which launches nothing) equals the single-tile plain calls."""
    from longreadmapper_tpu_torch.ops.band_dp import (band_dp_tiles,
                                                      banded_nw_dirs,
                                                      banded_nw_dirs_tiles)
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_dirs_v
    B, L, T, W, band = 3, 1024, 128, 60, 128
    q, t, _ = (torch.from_numpy(a) for a in _pair(8, B, L))
    ckpt, _ = gact_forward(q, t, T, W, band)
    before = (banded_nw_dirs.launches, band_dp_tiles.launches)
    v, wc, nm = banded_nw_dirs_tiles(q, t, W, band, ckpt, T, 2, 5)
    assert (banded_nw_dirs.launches, band_dp_tiles.launches) == before
    assert v.shape == (5, T // 16, B, band) and wc.shape == (5, T + 1, B)
    assert nm.shape == (5, 1, B, band)
    for y in range(5):
        k = 2 + y
        want = banded_nw_dirs_v(q, t, W, band, h0=ckpt[k], i0=k * T, n=T)
        for g, w in zip((v[y], wc[y], nm[y]), want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("B,band,budget,want", [
    (40, 5120, 1 << 30, 39),          # the 50 kb first pass: 98 tiles
    (40, 10112, 1 << 30, 20),         # its full-band retry
    (200, 2176, 1 << 30, 18),         # the 10 kb retry: 20 tiles
    (40, 5120, 0, 1),                 # a budget below one tile
    (2, 128, 1 << 30, 98)])           # never more than all tiles
def test_gact_group_tiles(B, band, budget, want):
    from longreadmapper_tpu_torch.ops.gact import gact_group_tiles
    L, T = 50176, 512
    g = gact_group_tiles(B, L, T, band, budget)
    assert g == want
    tile = 4 * B * band * (T // 16 + 1) + 2 * B * (T + 1)
    assert g == 1 or g * tile <= budget


def test_tile_entry_dirs_match_jax_vertical_row_step():
    """A tile of T rows entered from checkpoint row k*T gives JAX's
    vertical _dp_row_step words, the rows' wcol and the group bitmap."""
    import jax.numpy as jnp
    from jax import lax
    from longreadmapper_tpu.ops.gact import _dp_row_step
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_dirs_v
    B, L, T, W, band = 5, 1024, 512, 40, 128
    q, t, lens = _pair(21, B, L)
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    ckpt, wcol = gact_forward(tq, tt, T, W, band)
    k = 1
    tpad = jnp.pad(jnp.asarray(t), ((0, 0), (W + 1, band)),
                   constant_values=5)
    step = _dp_row_step(jnp.asarray(q), tpad, L, W, band, with_dirs=True,
                        vertical=True)
    _, words = lax.scan(lambda h, g: step(h, k * T + 1 + g * 16),
                        jnp.asarray(ckpt[k].numpy()),
                        jnp.arange(T // 16, dtype=jnp.int32))
    v, wc, nm = banded_nw_dirs_v(tq, tt, W, band, h0=ckpt[k], i0=k * T, n=T)
    np.testing.assert_array_equal(v.numpy(), np.asarray(words))
    assert torch.equal(wc, wcol[k * T:(k + 1) * T + 1])
    nz = (v != 0).to(torch.int64) << torch.arange(T // 16)[:, None, None]
    assert torch.equal(nm[0].to(torch.int64) & 0xFFFFFFFF, nz.sum(dim=0))


def test_wrapper_tile_entry_runs_plain_version_on_cpu():
    """One tile through the multi-tile wrapper (and a whole pass at a wide
    band through banded_nw_dirs) on the CPU: the plain version, no launch."""
    from longreadmapper_tpu_torch.ops.band_dp import (band_dp_tiles,
                                                      banded_nw_dirs,
                                                      banded_nw_dirs_tiles)
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_dirs_v
    q, t, _ = (torch.from_numpy(a) for a in _pair(4, 3, 256))
    ckpt, _ = gact_forward(q, t, 64, 20, 128)
    before = (banded_nw_dirs.launches, band_dp_tiles.launches)
    got = banded_nw_dirs_tiles(q, t, 20, 128, ckpt, 64, 2, 1)
    want = banded_nw_dirs_v(q, t, 20, 128, h0=ckpt[2], i0=128, n=64)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w)
    for g, w in zip(banded_nw_dirs(q, t, 20, 640),
                    banded_nw_dirs_v(q, t, 20, 640)):
        assert torch.equal(g, w)
    assert (banded_nw_dirs.launches, band_dp_tiles.launches) == before


def test_walk_refuses_int16_count_overflow():
    """The reference's bound (JAX ops/gact.py:310): band - W <= 8191."""
    from longreadmapper_tpu_torch.ops.gact import gact_traceback_c
    q = torch.zeros((1, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="8191"):
        gact_traceback_c(q, q, torch.zeros((2, 1, 16384), dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), 32, 8000, 16384)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,band,T,k0,tiles", [
    (8, 8192, 2508, 5120, 512, 3, 13),     # the 50 kb first pass
    (4, 4096, 5017, 10112, 256, 0, 16),    # its retry band, every tile
    (16, 2048, 1024, 2176, 128, 5, 11)])
def test_tiles_kernel_matches_plain_on_card(B, L, W, band, T, k0, tiles):
    """The multi-tile entry: one launch of grid (B, tiles), entered from
    the plain forward pass's checkpoint rows in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from _torch_parity import mutate_rows
    from longreadmapper_tpu_torch.ops.band_dp import (
        band_dp_tiles, banded_nw_dirs_tiles, banded_nw_dirs_tiles_v)
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    rng = np.random.default_rng(B + L + tiles)
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = mutate_rows(rng, q, L // 20, pad=L // 16)
    qd, td = torch.from_numpy(q).cuda(), torch.from_numpy(t).cuda()
    ckpt, _ = gact_forward(qd, td, T, W, band)
    before = band_dp_tiles.launches
    got = banded_nw_dirs_tiles(qd, td, W, band, ckpt, T, k0, tiles)
    want = banded_nw_dirs_tiles_v(qd, td, W, band, ckpt, T, k0, tiles)
    torch.cuda.synchronize()
    assert band_dp_tiles.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,band,T", [(16, 2048, 1024, 2176, 0),
                                          (37, 4096, 409, 896, 0),
                                          (8, 4096, 2508, 5120, 512),
                                          (4, 1024, 5017, 10112, 256),
                                          (2, 1024, 8000, 16384, 256)])
def test_wide_kernel_matches_plain_on_card(B, L, W, band, T):
    """Resident mode (T == 0, the whole pass through banded_nw_dirs) and
    one tile (entered from the plain forward pass's checkpoint row at T),
    both launches of the multi-tile entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from _torch_parity import mutate_rows
    from longreadmapper_tpu_torch.ops.band_dp import (band_dp_tiles,
                                                      banded_nw_dirs)
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_dirs_v
    rng = np.random.default_rng(B + L)
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = mutate_rows(rng, q, L // 20, pad=L // 16)
    qd, td = torch.from_numpy(q).cuda(), torch.from_numpy(t).cuda()
    before = band_dp_tiles.launches
    if T:
        ckpt, _ = gact_forward(qd, td, T, W, band)
        got = [x[0] for x in band_dp_tiles(qd, td, W, band, ckpt, T, 1, 1)]
        want = banded_nw_dirs_v(qd, td, W, band, h0=ckpt[1], i0=T, n=T)
    else:
        got = banded_nw_dirs(qd, td, W, band)
        want = banded_nw_dirs_v(qd, td, W, band)
    torch.cuda.synchronize()
    assert band_dp_tiles.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
