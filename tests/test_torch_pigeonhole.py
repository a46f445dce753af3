"""Port parity: cbird_tpu_torch's pigeonhole count phase against
cbird_tpu's and a numpy golden, exact equality throughout: block masks,
counts with tombstones and where the phase declines.  The band kernel's
(K3) tests are in tests/test_torch_band.py and search_self through the
phase is in tests/test_torch_hamming.py; both use the helpers here.

Inputs are made with numpy from fixed seeds; the JAX side runs on one CPU
device.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cbird_tpu.ops import pigeonhole as jp
from cbird_tpu.ops.dct_hash import split_u64
from cbird_tpu_torch.ops import pigeonhole as tp

torch.set_num_threads(1)


def _golden(hashes, valid, t):
    """counts[i] = #{j > i : both valid, popcount(h_i ^ h_j) < t}."""
    n = len(hashes)
    out = np.zeros(n, np.int32)
    for i in range(0, n, 512):
        d = np.bitwise_count(hashes[i:i + 512, None] ^ hashes[None, :])
        hit = (d < t) & valid[i:i + 512, None] & valid[None, :]
        hit &= np.arange(n)[None, :] > np.arange(i, min(i + 512, n))[:, None]
        out[i:i + 512] = hit.sum(axis=1)
    return out


def _planted(seed, n, t, dead=0):
    """Random hashes with pairs at distances straddling t, an exact dup and
    ``dead`` tombstones (never a planted row)."""
    rng = np.random.default_rng(seed)
    hashes = rng.integers(1, 2**63, size=n, dtype=np.uint64)
    for src, dst in [(5, n - 1196), (n - 1146, 10), (100, 101), (0, n - 1)]:
        h = int(hashes[src])
        for b in rng.choice(64, size=int(rng.integers(0, t)), replace=False):
            h ^= 1 << int(b)
        hashes[dst] = np.uint64(h)
    hashes[7] = hashes[8]
    valid = np.ones(n, bool)
    valid[rng.choice(np.arange(200, n - 1200), size=dead, replace=False)] = 0
    return hashes, valid


def _cluster(seed, n=8192, size=1500):
    """A 1500-member cluster at distance <= 2 of one base: in the t=5 block
    sorts most of it lands in one equal-key run longer than s=256."""
    rng = np.random.default_rng(seed)
    hashes = rng.integers(1, 2**63, size=n, dtype=np.uint64)
    base = int(hashes[0])
    for i in rng.choice(n, size=size, replace=False):
        h = base
        for b in rng.choice(64, size=int(rng.integers(0, 3)), replace=False):
            h ^= 1 << int(b)
        hashes[i] = np.uint64(h)
    return hashes, np.ones(n, bool)


def _port(hashes, valid):
    return (torch.from_numpy(hashes.view(np.int64).copy()),
            torch.from_numpy(valid.copy()))


def _jax_counts(hashes, valid, t, **kw):
    return jp.self_counts(jnp.asarray(split_u64(hashes)), jnp.asarray(valid),
                          t, int(valid.sum()), **kw)


def _jax_block(hashes, valid, t, b, s):
    """One block of the JAX count phase: its sorted arrays (numpy) and the
    port's operands made from them, so both bands see one order."""
    masks = jp.block_masks(t)
    out = jp._prep_block(jnp.asarray(split_u64(hashes)), jnp.asarray(valid),
                         masks[b], -(-64 // t), s=s)
    slo, shi, srow, svalid = (np.asarray(a) for a in out[:4])
    sh = (shi.astype(np.uint64) << np.uint64(32) | slo).view(np.int64)
    port = (torch.from_numpy(sh), torch.from_numpy(srow.astype(np.int32)),
            torch.from_numpy(svalid.copy()))
    block = [tp.mask64(m) for m in masks[b::-1]]
    return out, port, block


def test_block_masks_equal_reference():
    for t in range(1, 9):
        assert tp.block_masks(t) == jp.block_masks(t)
        assert len({tp.mask64(m) for m in tp.block_masks(t)}) == t


@pytest.mark.parametrize("t", [1, 3, 5, 8])
def test_self_counts_match_reference_and_golden(t):
    hashes, valid = _planted(40 + t, 4096, t, dead=300)
    want = _golden(hashes, valid, t)
    assert want.sum() >= 3
    ref = _jax_counts(hashes, valid, t, s=256)
    got = tp.self_counts(*_port(hashes, valid), t, int(valid.sum()), s=256)
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_none_exactly_where_reference_declines():
    """The run budget (one giant equal-key run) and the gates: store too
    small, threshold out of range."""
    same = np.full(8192, 0x1234_5678_9ABC_DEF0, np.uint64)
    cases = [(same, 5, 256)]
    small = np.zeros(2048, np.uint64)
    big = np.zeros(4096, np.uint64)
    cases += [(small, 5, 0), (big, 9, 0), (big, 0, 0)]
    for hashes, t, s in cases:
        valid = np.ones(len(hashes), bool)
        assert _jax_counts(hashes, valid, t, s=s) is None
        port = _port(hashes, valid)
        assert tp.self_counts(*port, t, len(hashes), s=s) is None
        assert tp.self_counts_sparse(*port, t, len(hashes), s=s) is None


def test_cluster_runs_over_three_tiles_equal_triangle():
    """A store with a near-duplicate cluster (every member within 2 bits of
    one base), whose equal-key run spans three tiles or more in every
    block: the count phase, its run tiles listed on the store's device,
    gives the classic triangle's counts (``_classic_self_counts``), the
    numpy golden's and the JAX count phase's."""
    from cbird_tpu_torch.ops.hamming import PackedHashStore
    t, s = 5, 256
    hashes, valid = _cluster(56, n=8192, size=2500)
    valid[np.random.default_rng(56).choice(8192, 80, replace=False)] = False
    store = PackedHashStore(hashes, np.arange(1, 8193, dtype=np.uint32),
                            device="cpu")
    hd, vd = _port(hashes, valid)
    stats: dict = {}
    hot, hot_counts = tp.self_counts_sparse(hd, vd, t, int(valid.sum()),
                                            s=s, stats=stats)
    assert all(n >= 1 for n in stats["run_tiles"]), stats
    got = np.zeros(len(hashes), np.int32)
    got[hot] = hot_counts
    want = store._classic_self_counts(hd, vd, t, len(hashes), 1024, 4096)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_golden(hashes, valid, t), want)
    np.testing.assert_array_equal(_jax_counts(hashes, valid, t, s=s), want)
    assert want.sum() > 2500 * 2499 // 2 // 2

