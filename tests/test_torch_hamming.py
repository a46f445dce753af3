"""Port parity: cbird_tpu_torch's PackedHashStore against cbird_tpu's.

Same stores (numpy hashes with planted clusters and tombstones) through
both packages: ``search`` lists and ``search_self`` lists must be equal
(``_assert_self_parity`` of tests/test_hamming.py).  The JAX side runs
its single-device classic triangle with pigeonhole off, except in the
test of the pigeonhole route, where both packages take it; its CPU top-k
is exact, so lists compare exactly.
"""

import numpy as np
import pytest
import torch

from cbird_tpu.ops import hamming as jh
from cbird_tpu.ops import pigeonhole
from cbird_tpu.ops.dct_hash import split_u64
from cbird_tpu_torch.ops import hamming as th
from cbird_tpu_torch.ops import pigeonhole as tp
from cbird_tpu_torch.ops.hamming_topk import BAD_DIST

from test_torch_pigeonhole import _planted as _planted_t

torch.set_num_threads(1)


@pytest.fixture
def single_device(monkeypatch):
    """conftest creates 8 virtual cpu devices, which would send cbird_tpu
    down its sharded path; pigeonhole off selects the classic triangle in
    both packages."""
    monkeypatch.setattr(jh, "_MESH", None)
    monkeypatch.setattr(pigeonhole, "enabled", lambda: False)
    monkeypatch.setattr(tp, "enabled", lambda: False)


def _stores(hashes, kill=()):
    ids = np.arange(1, len(hashes) + 1, dtype=np.uint32)
    ref = jh.PackedHashStore(hashes, ids)
    port = th.PackedHashStore(hashes, ids, device="cpu")
    for s in (ref, port):
        s.remove(kill)
    return ref, port


def _assert_equal_lists(a, b):
    assert len(a) == len(b)
    for row, ((ai, ad), (bi, bd)) in enumerate(zip(a, b)):
        assert np.array_equal(ai, bi), row
        assert np.array_equal(ad, bd), row
        assert bi.dtype == np.uint32 and bd.dtype == np.int32


def _assert_self_parity(ref, tri):
    """As in tests/test_hamming.py: needles whose only hit is themselves
    may be gated to empty."""
    assert len(ref) == len(tri)
    for row, ((ri, rd), (ti, td)) in enumerate(zip(ref, tri)):
        if len(ri) <= 1:
            assert len(ti) == 0 or np.array_equal(ri, ti), row
        else:
            assert np.array_equal(ri, ti), row
            assert np.array_equal(rd, td), row


def _planted(rng, n):
    hashes = rng.integers(1, 2**63, size=n, dtype=np.uint64)
    for src, dst in [(5, n - 100), (n - 50, 10), (100, 101), (0, n - 1)]:
        hashes[dst] = hashes[src] ^ np.uint64(1 << int(rng.integers(0, 64)))
    return hashes


def test_search_matches_reference(single_device):
    """Below the count gate (n <= 4096): top-k only."""
    rng = np.random.default_rng(21)
    hashes = _planted(rng, 3000)
    ref, port = _stores(hashes, kill=[102])
    needles = np.concatenate([hashes[:300], hashes[2900:] ^ np.uint64(3)])
    for t, k in [(5, 64), (12, 8)]:
        _assert_equal_lists(ref.search(needles, t, k=k),
                            port.search(needles, t, k=k))


def test_search_count_gate_matches_reference(single_device):
    """Above the gate (n > 4096, Q > 64): count phase (K1) then top-k."""
    rng = np.random.default_rng(22)
    n = 6000
    hashes = _planted(rng, n)
    hashes[5000] = hashes[17] ^ np.uint64(1 << 3)
    ref, port = _stores(hashes, kill=[3])
    got = port.search(hashes, 5, k=16, min_hits=2)
    _assert_equal_lists(ref.search(hashes, 5, k=16, min_hits=2), got)
    assert set(got[17][0]) == {18, 5001}


def test_search_self_matches_reference(single_device):
    rng = np.random.default_rng(23)
    n = 3000
    hashes = _planted(rng, n)
    ref, port = _stores(hashes)
    want = ref.search_self(5, k=64, rows=512, cols=1024, min_n=0)
    got = port.search_self(5, k=64, rows=512, cols=1024, min_n=0)
    _assert_equal_lists(want, got)
    _assert_self_parity(port.search(hashes, 5, k=64, min_hits=2), got)
    assert 6 in got[n - 100][0] and n - 99 in got[5][0]
    assert port.rescanned == 0


def test_search_self_tombstones(single_device):
    rng = np.random.default_rng(24)
    n = 2048
    hashes = rng.integers(1, 2**63, size=n, dtype=np.uint64)
    hashes[7] = hashes[1000]
    hashes[500] = hashes[1500]
    ref, port = _stores(hashes, kill=[501, 1501])
    want = ref.search_self(5, k=16, rows=256, cols=512, min_n=0)
    got = port.search_self(5, k=16, rows=256, cols=512, min_n=0)
    _assert_equal_lists(want, got)
    assert 1001 in got[7][0] and 8 in got[1000][0]
    assert len(got[500][0]) == 0 and len(got[1500][0]) == 0


def test_search_self_recall_miss_repair(single_device, monkeypatch):
    """A hit dropped by the top-k (simulated) is caught by the exact
    count-phase invariant and restored by the verify rescan; without it a
    mirrored-only needle would lose its only match."""
    rng = np.random.default_rng(25)
    n = 2048
    hashes = rng.integers(1, 2**63, size=n, dtype=np.uint64)
    hashes[1900] = hashes[3] ^ np.uint64(1)
    _, port = _stores(hashes)
    real = th.PackedHashStore._topk_call

    def flaky(needles, hashes_dev, valid_dev, k, threshold, rescan=False):
        d, i = real(needles, hashes_dev, valid_dev, k, threshold, rescan)
        if not rescan:  # first scans drop row 1900; the rescan keeps it
            d = torch.where(i == 1900, BAD_DIST, d)
        return d, i

    monkeypatch.setattr(th.PackedHashStore, "_topk_call", staticmethod(flaky))
    tri = port.search_self(5, k=16, rows=256, cols=512, min_n=0)
    assert 1901 in tri[3][0], "invariant rescan failed to restore the hit"
    assert 4 in tri[1900][0], "mirror lost the repaired pair"
    assert port.rescanned == 1


def test_search_self_big_cluster_matches_reference(single_device):
    """A duplicate cluster larger than k: saturation escalation (k x4)."""
    rng = np.random.default_rng(26)
    n, k = 2048, 8
    hashes = rng.integers(1, 2**63, size=n, dtype=np.uint64)
    base = int(hashes[100])
    for r in range(101, 131):
        hashes[r] = np.uint64(base ^ (1 << int(rng.integers(0, 64))))
    ref, port = _stores(hashes)
    want = ref.search_self(5, k=k, rows=256, cols=512, min_n=0)
    got = port.search_self(5, k=k, rows=256, cols=512, min_n=0)
    _assert_equal_lists(want, got)
    assert len(got[130][0]) == k


def test_search_self_sparse_small_store():
    """Small stores (n <= min_n) take the plain search path."""
    rng = np.random.default_rng(27)
    hashes = _planted(rng, 1500)
    _, port = _stores(hashes)
    sparse = port.search_self(5, k=64, sparse=True)
    dense = port.search(hashes, 5, k=64, min_hits=2)
    want = {r: v for r, v in enumerate(dense) if len(v[0])}
    assert sorted(sparse) == sorted(want)
    _assert_equal_lists([sparse[r] for r in want], list(want.values()))
    assert set(sparse) >= {5, 1400, 100, 101, 0, 1499}


def test_packed_layout_roundtrip():
    """State carried across: the JAX store's device layout converts to the
    port's int64 + bool tensors and back unchanged."""
    rng = np.random.default_rng(28)
    hashes = rng.integers(0, 2**64, size=1000, dtype=np.uint64)
    hashes[:3] = [0, 2**63, 2**64 - 1]
    pairs, valid = split_u64(hashes), rng.random(1000) > 0.3
    h, v = th.from_packed(pairs, valid, device="cpu")
    assert h.dtype == torch.int64 and v.dtype == torch.bool
    assert np.array_equal(h.numpy().view(np.uint64), hashes)
    p2, v2 = th.to_packed(h, v)
    assert np.array_equal(p2, pairs) and np.array_equal(v2, valid)


def test_store_bookkeeping():
    rng = np.random.default_rng(29)
    hashes = rng.integers(1, 2**63, size=60, dtype=np.uint64)
    ids = np.arange(1, 61, dtype=np.uint32)
    ref = jh.PackedHashStore(hashes, ids)
    port = th.PackedHashStore(hashes, ids, device="cpu")
    assert port.fingerprint() == ref.fingerprint()
    for s in (ref, port):
        s.remove([2, 3])
        s.add(hashes[1:3], ids[1:3])
    assert port.fingerprint() == ref.fingerprint()
    assert np.array_equal(port.slice({10, 11}).ids, ref.slice({10, 11}).ids)
    for n in (1, 1000, 1025, 3 << 20):
        assert th._bucket(n) == jh._bucket(n)


def test_search_self_takes_pigeonhole(monkeypatch):
    """The port's search_self routes through self_counts_sparse and returns
    the JAX store's lists with pigeonhole on."""
    monkeypatch.setattr(jh, "_MESH", None)
    for mod in (pigeonhole, tp):
        monkeypatch.setattr(mod, "MIN_STORE", 1024)
    calls = []
    real = tp.self_counts_sparse

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(tp, "self_counts_sparse", spy)
    hashes, _ = _planted_t(70, 3000, 3)
    ids = np.arange(1, 3001, dtype=np.uint32)
    ref = jh.PackedHashStore(hashes, ids)
    port = th.PackedHashStore(hashes, ids, device="cpu")
    for s in (ref, port):
        s.remove([300, 301, 3000 - 1196])
    want = ref.search_self(3, k=64, min_n=0)
    got = port.search_self(3, k=64, min_n=0)
    assert calls == [True], "pigeonhole path was not taken"
    assert port.pigeonhole is not None and port.rescanned == 0
    assert len(want) == len(got)
    for row, ((wi, wd), (gi, gd)) in enumerate(zip(want, got)):
        assert np.array_equal(wi, gi) and np.array_equal(wd, gd), row
    assert 9 in got[7][0] and 102 in got[100][0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_store_on_card_matches_cpu(cuda):
    """The store through the CUDA kernels equals the store through their
    plain twins: count gate, triangle tiles, saturation escalation (a
    300-member cluster against k=8) and tombstones."""
    rng = np.random.default_rng(30)
    n = 6000
    hashes = _planted(rng, n)
    base = int(hashes[200])
    for r in range(201, 501):
        hashes[r] = np.uint64(base ^ (1 << int(rng.integers(0, 64))))
    ids = np.arange(1, n + 1, dtype=np.uint32)
    stores = [th.PackedHashStore(hashes, ids, device=d) for d in ("cpu", cuda)]
    for s in stores:
        s.remove([3, 250, 5999])
    for call in (lambda s: s.search(hashes, 5, k=16, min_hits=2),
                 lambda s: s.search_self(5, k=8, rows=512, cols=1024,
                                         min_n=0)):
        want, got = (call(s) for s in stores)
        _assert_equal_lists(want, got)
    assert len(got[500][0]) == 8 and stores[1].rescanned == 0
