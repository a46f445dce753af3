"""Port parity for kernel K3's plain twins (cbird_tpu_torch.ops.band_count)
against cbird_tpu: the band equals the XLA _band_chunk loop and the Pallas
band (interpret mode) for every block, the run tiles equal _run_tile, and
the count phase stays exact through oversized runs.  The kernel's
run-bounded loop (each warp of 32 sorted rows stops at its last row's run
end) is emulated here and held equal to the plain full-window band.  The
``cuda`` tests hold the kernels against their plain twins on a card and
skip without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cbird_tpu.ops import pallas_band
from cbird_tpu.ops import pigeonhole as jp
from cbird_tpu_torch.ops import band_count as bc
from cbird_tpu_torch.ops import pigeonhole as tp

from test_torch_pigeonhole import (_cluster, _golden, _jax_block,
                                   _jax_counts, _planted, _port)

torch.set_num_threads(1)


@pytest.mark.parametrize("t", [1, 5])
def test_band_plain_matches_xla_and_pallas(monkeypatch, t):
    """For every block: the port's plain band on the JAX sort equals the
    XLA _band_chunk loop (csort bit for bit) and the Pallas band kernel run
    as the JAX tests run it (interpret mode; row credits only)."""
    monkeypatch.setattr(pallas_band, "_INTERPRET", True)
    n, s = 2048, 256
    hashes, valid = _planted(60 + t, n, t, dead=200)
    masks = jp.block_masks(t)
    for b, mask_cur in enumerate(masks):
        (slo, shi, srow, svalid, _, _, _), port, block = _jax_block(
            hashes, valid, t, b, s)
        ref = jnp.zeros(n + s, jnp.int32)
        for p0 in range(0, n, 4 * s):
            ref = jp._band_chunk(ref, slo, shi, srow, svalid, jnp.int32(p0),
                                 mask_cur=mask_cur, mask_prev=masks[:b],
                                 s=s, g=4, t=t)
        marr = np.zeros((t, 2), np.uint32)
        marr[:b + 1] = [mask_cur, *masks[:b]]
        pallas = jp._band_epilogue(pallas_band.band_counts(
            slo, shi, srow, svalid, jnp.asarray(marr), jnp.int32(t), s=s,
            t_blocks=t), s=s)
        got = bc.band_counts(*port, block, t, s).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref), f"block {b}")
        np.testing.assert_array_equal(got, np.asarray(pallas), f"block {b}")


def test_run_tiles_plain_matches_reference():
    """The plain run tiles equal the JAX _run_tile steps on the oversized
    cluster's tile list."""
    t, s = 5, 256
    hashes, valid = _cluster(52)
    masks = jp.block_masks(t)
    seen = 0
    for b in range(t):
        out, port, block = _jax_block(hashes, valid, t, b, s)
        slo, shi, srow, svalid, os_start, os_end, _ = out
        tiles = set()
        ends = np.nonzero(np.asarray(os_end))[0] + s
        for st, en in zip(np.nonzero(np.asarray(os_start))[0], ends):
            for ta in range(st // s, en // s - 1):
                tiles.update((ta, tb) for tb in range(ta + 2, en // s + 1))
        tiles = sorted(tiles)
        seen += len(tiles)
        ref = jnp.zeros(len(hashes) + s, jnp.int32)
        for ta, tb in tiles:
            ref = jp._run_tile(ref, slo, shi, srow, svalid, jnp.int32(ta * s),
                               jnp.int32(tb * s), mask_cur=masks[b],
                               mask_prev=masks[:b], s=s, t=t)
        csort = torch.zeros(len(hashes) + s, dtype=torch.int32)
        got = bc.run_tiles(csort, *port, tiles, block, t, s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert seen > 0


def test_self_counts_oversized_run():
    """Runs longer than the band go through the dense run tiles."""
    hashes, valid = _cluster(50)
    want = _golden(hashes, valid, 5)
    stats: dict = {}
    hot, hot_counts = tp.self_counts_sparse(*_port(hashes, valid), 5,
                                            len(hashes), s=256, stats=stats)
    assert sum(stats["run_tiles"]) > 0 and stats["s"] == [256] * 5
    np.testing.assert_array_equal(hot, np.nonzero(want)[0])
    np.testing.assert_array_equal(hot_counts, want[hot])
    np.testing.assert_array_equal(_jax_counts(hashes, valid, 5, s=256), want)


def _k3_block(seed, n, s, t, b):
    """Block b of threshold t over an oversized cluster (one equal-key run
    across several tiles), 1% tombstones and a ragged 37-row invalid tail,
    sorted by the port's count phase code.
    @return (sh, srow, svalid, masks current first)"""
    hashes, valid = _cluster(seed, n)
    rng = np.random.default_rng(seed)
    valid[rng.choice(n, n // 100, replace=False)] = False
    valid[-37:] = False
    h, v = _port(hashes, valid)
    masks = [tp.mask64(m) for m in tp.block_masks(t)]
    _, srow = tp.sort_block(h, torch.nonzero(v).flatten(),
                            torch.nonzero(~v).flatten(), masks[b])
    return (*tp.pad_block(h, v, srow, s), masks[b::-1])


def _warp_limits(sh, m0, s):
    """The band kernel's column limit per group of 32 sorted rows (the
    warps that share its columns each stop there): the end of its last
    row's window (the tile after that row's), or before it the first
    position past that row whose key (bits under m0) differs."""
    n_tot = sh.numel()
    n_pad = n_tot - s
    key = sh & m0
    change = torch.ones(n_tot + 1, dtype=torch.bool)
    change[1:-1] = key[1:] != key[:-1]
    e = torch.where(change, torch.arange(n_tot + 1), n_tot)
    nxt = torch.flip(torch.cummin(torch.flip(e, [0]), 0).values, [0])
    last = torch.clamp(torch.arange(0, n_pad, 32) + 31, max=n_pad - 1)
    return torch.minimum(nxt[last + 1],
                         torch.clamp((last // s + 2) * s, max=n_tot))


def _warp_limits_loop(sh, m0, s):
    key = sh.numpy() & m0
    n_tot = len(key)
    n_pad = n_tot - s
    out = []
    for p0 in range(0, n_pad, 32):
        last = min(p0 + 31, n_pad - 1)
        q, end = last + 1, min((last // s + 2) * s, n_tot)
        while q < end and key[q] == key[last]:
            q += 1
        out.append(q)
    return np.array(out)


def _band_run_bounded(sh, srow, svalid, masks, t, s):
    """The band as the kernel walks it: row p against the columns from p + 1
    to its group's limit and its own window end; a column past them points
    at the last padding row, which is invalid, so it never counts."""
    n_tot = sh.numel()
    p = torch.arange(n_tot - s)
    hi = torch.minimum(_warp_limits(sh, masks[0], s).repeat_interleave(32)[
        :p.numel()], torch.clamp((p // s + 2) * s, max=n_tot))
    q = p[:, None] + 1 + torch.arange(int((hi - p - 1).max()))[None, :]
    q = torch.where(q < hi[:, None], q, n_tot - 1)
    out = torch.zeros(n_tot, dtype=torch.int32)
    bc._credit(out, sh, srow, svalid, p, q, masks, t, later=True)
    return out


@pytest.mark.parametrize("n,s,t", [(8192, 256, 5), (8000, 100, 3)])
def test_run_bounded_band_equals_full_window(n, s, t):
    """For every block: the warps' limits equal a plain walk, the run-bounded
    ranges credit exactly what the full window does (runs across tile
    edges, an over-long run capped at the window, tombstones, the invalid
    tail, warps across tiles when 32 does not divide s), and they test
    far fewer pairs."""
    capped = 0
    for b in range(t):
        sh, srow, svalid, masks = _k3_block(55, n, s, t, b)
        lim = _warp_limits(sh, masks[0], s)
        np.testing.assert_array_equal(
            lim.numpy(), _warp_limits_loop(sh, masks[0], s), f"block {b}")
        got = _band_run_bounded(sh, srow, svalid, masks, t, s)
        want = bc.band_counts_plain(sh, srow, svalid, masks, t, s)
        assert torch.equal(got, want), b
        assert want.sum() > 0
        first = torch.arange(0, n, 32)
        # pairs a warp tests (32 a column) against the window's ~1.5 s a
        # row; ~0.2-0.33 here, where 1500 of the rows share one key
        assert 32 * (lim - first - 1).clamp(min=0).sum() < 0.5 * n * 1.5 * s
        capped += int((lim == torch.clamp((torch.clamp(
            first + 31, max=n - 1) // s + 2) * s, max=n + s)).sum())
    assert capped > 0  # an over-long run reached the window end


def test_operand_checks():
    """What the kernel wrappers refuse before a launch."""
    n, s = 1024, 256
    sh = torch.zeros(n + s, dtype=torch.int64)
    srow = torch.zeros(n + s, dtype=torch.int32)
    ok = torch.ones(n + s, dtype=torch.bool)
    bc.check_operands(sh, srow, ok, [1, 2], s)
    bad = [(sh.int(), srow, ok, [1], s), (sh, srow.long(), ok, [1], s),
           (sh, srow, ok.int(), [1], s), (sh, srow[:-1], ok, [1], s),
           (sh, srow, ok, [], s), (sh, srow, ok, [1] * 9, s),
           (sh, srow, ok, [1], 300), (sh[:s], srow[:s], ok[:s], [1], s)]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            bc.check_operands(*args)
    bc.check_tiles(np.array([[0, 2], [1, 3]]), n + s, s)
    for tiles in ([[0, 1]], [[-1, 2]], [[0, 4]], [[0, 1, 2]]):
        with pytest.raises(ValueError):
            bc.check_tiles(np.array(tiles), n + s, s)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda):
    """K3's band and run tiles on the card equal their plain twins on the
    same sorted blocks, and the whole count phase equals the golden."""
    for hashes, valid, t in ((*_cluster(53), 5), (*_planted(54, 8192, 1),
                                                  1)):
        valid[-37:] = False  # a ragged invalid tail
        for b in range(t):
            _, port, block = _jax_block(hashes, valid, t, b, 256)
            dev = [a.to(cuda) for a in port]
            got = bc.band_counts(*dev, block, t, 256)
            want = bc.band_counts_plain(*dev, block, t, 256)
            assert torch.equal(got, want), b
            tiles = [(0, 2), (1, 5), (3, 30)]
            assert torch.equal(
                bc.run_tiles(got, *dev, tiles, block, t, 256),
                bc.run_tiles_plain(want, *dev, tiles, block, t, 256)), b
        counts = tp.self_counts(*(a.to(cuda) for a in _port(hashes, valid)),
                                t, int(valid.sum()))
        np.testing.assert_array_equal(counts, _golden(hashes, valid, t))


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,t", [(8192, 256, 5), (8000, 100, 3)])
def test_run_bounded_kernel_on_card(cuda, n, s, t):
    """The band kernel and the run tiles (column-split) against their plain
    twins on the blocks of the run-bounded emulation test, 32 not dividing
    s included."""
    for b in range(t):
        sh, srow, svalid, masks = (a.to(cuda) if torch.is_tensor(a) else a
                                   for a in _k3_block(55, n, s, t, b))
        got = bc.band_counts(sh, srow, svalid, masks, t, s)
        want = bc.band_counts_plain(sh, srow, svalid, masks, t, s)
        assert torch.equal(got, want), b
        tiles = [(0, 2), (1, n // s - 1)]
        assert torch.equal(
            bc.run_tiles(got, sh, srow, svalid, tiles, masks, t, s),
            bc.run_tiles_plain(want, sh, srow, svalid, tiles, masks, t, s)), b
