"""Port parity for kernel K3's plain twins (cbird_tpu_torch.ops.band_count)
against cbird_tpu: the band equals the XLA _band_chunk loop and the Pallas
band (interpret mode) for every block, the run tiles equal _run_tile, and
the count phase stays exact through oversized runs.  The ``cuda`` test
holds the kernel against its plain twin on a card and skips without one.
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
