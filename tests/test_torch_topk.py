"""Port parity: the exact top-k kernel (K4) of cbird_tpu_torch against the
JAX package's Pallas top-k (interpret mode) and a numpy reference.

The port's contract is exact: the k smallest (distance, store row) keys
among valid rows below the bound, so lists compare exactly, ties
included.  ``hamming_topk_pallas`` is exact as well but asserts k <= 64;
larger k (the self-search saturation escalation asks up to 65536) is held
to numpy.  On the CPU the wrapper runs its plain twin; the CUDA kernel is
compared with that twin on the card (``-m cuda`` here, and chip_smoke.py).
The steps around the kernel (``topk_passes``: capacity, overflow, cut,
segmented sort) run here on ``topk_scan_plain``, the kernel's outputs in
plain PyTorch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cbird_tpu.ops.dct_hash import split_u64
from cbird_tpu.ops.pallas_hamming import hamming_topk_pallas
from cbird_tpu_torch.ops import hamming_topk as tk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    n, q = 2048, 128
    haystack = rng.integers(1, 2**63, size=n, dtype=np.uint64)
    # ties at the boundary: exact copies and one-bit variants of row 9
    haystack[300:340] = haystack[9]
    haystack[340:380] = haystack[9] ^ np.uint64(1 << 5)
    needles = np.concatenate([haystack[:8],
                              rng.integers(1, 2**63, q - 8, np.uint64)])
    needles[20] = haystack[9]
    valid = np.ones(n, bool)
    valid[50:60] = False
    valid[310:315] = False
    return haystack, needles, valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def _port(needles, haystack, valid, k, bound=tk.BINS):
    d, i = tk.hamming_topk(_t(needles), _t(haystack),
                           torch.from_numpy(valid.copy()), k, bound)
    return d.numpy(), i.numpy()


def _passes(needles, haystack, valid, k, bound=tk.BINS,
            max_keys=tk.MAX_KEYS):
    """The wrapper's passes on the plain scan.
    @return (dists, rows, needles that took the second pass)"""
    nd, h = _t(needles), _t(haystack)
    v = torch.from_numpy(valid.copy())

    def scan(sub, *rest):
        tk.topk_scan_plain(sub, h, v, bound, *rest)
    keys, second = tk.topk_passes(scan, nd, len(haystack), k, max_keys)
    d, i = tk._finish(keys, k)
    return d.numpy(), i.numpy(), second


def _numpy_topk(needles, haystack, valid, k, bound=65):
    dist = np.bitwise_count(needles[:, None] ^ haystack[None, :]).astype(np.int64)
    d_out = np.full((len(needles), k), 0x7FFF, np.int32)
    i_out = np.full((len(needles), k), -1, np.int32)
    for q in range(len(needles)):
        rows = np.nonzero(valid & (dist[q] < bound))[0]
        o = np.lexsort((rows, dist[q, rows]))[:k]
        d_out[q, :len(o)] = dist[q, rows[o]]
        i_out[q, :len(o)] = rows[o]
    return d_out, i_out


@pytest.mark.parametrize("k", [1, 8, 64])
def test_matches_pallas(data, k):
    haystack, needles, valid = data
    d_ref, i_ref = hamming_topk_pallas(
        jnp.asarray(split_u64(needles)), jnp.asarray(split_u64(haystack)),
        jnp.asarray(valid.astype(np.int32)), k=k, tq=64, tn=512,
        interpret=True)
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    d, i = _port(needles, haystack, valid, k)
    assert np.array_equal(d, d_ref)
    assert np.array_equal(i, i_ref)
    # the kernel's passes: every needle has > capacity hits at bound 65
    d, i, second = _passes(needles, haystack, valid, k)
    assert second == len(needles)
    assert np.array_equal(d, d_ref) and np.array_equal(i, i_ref)


def test_one_pass_matches_pallas(data):
    """A sparse haystack: every needle's hits fit its slots, one pass."""
    haystack, needles, valid = data
    sparse = valid & (np.arange(len(valid)) % 97 == 0)  # 22 valid rows
    d_ref, i_ref = hamming_topk_pallas(
        jnp.asarray(split_u64(needles)), jnp.asarray(split_u64(haystack)),
        jnp.asarray(sparse.astype(np.int32)), k=32, tq=64, tn=512,
        interpret=True)
    d, i, second = _passes(needles, haystack, sparse, 32)
    assert second == 0
    assert np.array_equal(d, np.asarray(d_ref))
    assert np.array_equal(i, np.asarray(i_ref))


@pytest.mark.parametrize("k,bound,max_keys,second", [
    (8, 65, tk.MAX_KEYS, "all"),     # capacity 32 < hits: all overflow
    (64, 5, tk.MAX_KEYS, "some"),    # rare hits; needle 20 has 76
    (16, 22, 40, "some"),            # mixed, one needle a launch
    (4096, 65, tk.MAX_KEYS, "none"),  # k > N: capacity N
    (300, 22, 1000, "none")])
def test_passes_match_numpy_and_plain(data, k, bound, max_keys, second):
    """topk_passes on the plain scan equals the plain twin and numpy, for
    each way through it: the one pass, the overflow pass, both, and a key
    budget that splits the needles over launches."""
    haystack, needles, valid = data
    d, i, n2 = _passes(needles, haystack, valid, k, bound, max_keys)
    d_ref, i_ref = _numpy_topk(needles, haystack, valid, k, bound)
    d_plain, i_plain = _port(needles, haystack, valid, k, bound)
    assert np.array_equal(d, d_ref) and np.array_equal(i, i_ref)
    assert np.array_equal(d, d_plain) and np.array_equal(i, i_plain)
    assert n2 == {"all": len(needles), "none": 0}.get(second, n2)
    if second == "some":
        assert 0 < n2 < len(needles)


def test_passes_all_invalid_and_empty(data):
    haystack, needles, valid = data
    d, i, second = _passes(needles, haystack, np.zeros_like(valid), 64)
    assert second == 0 and (d == tk.BAD_DIST).all() and (i == -1).all()
    d, i, second = _passes(needles, haystack[:0], valid[:0], 8)
    assert d.shape == (len(needles), 8) and (i == -1).all()


def test_capacity_and_cut():
    assert [tk.capacity(k, 2048) for k in (1, 32, 33, 64, 4096)] == [
        32, 32, 64, 64, 2048]
    assert tk.capacity(100, 40) == 64
    hist = np.zeros((3, tk.BINS), dtype=np.int32)
    hist[0, 2], hist[0, 5] = 3, 10  # k = 4: cut 5, 13 collected
    hist[1, 0] = 4                  # exactly k at distance 0
    hist[2, 7] = 2                  # fewer than k: take all
    cut, size = tk.cut_sizes(hist, 4)
    assert cut.tolist() == [5, 0, 64] and size.tolist() == [13, 4, 2]


@pytest.mark.parametrize("k,bound", [(100, 65), (1000, 65), (4096, 65),
                                     (64, 5), (300, 22)])
def test_matches_numpy(data, k, bound):
    """k beyond the Pallas kernel's 64 (k > N included), and the distance
    bound the search passes (rows at >= bound never enter a list)."""
    haystack, needles, valid = data
    d, i = _port(needles, haystack, valid, k, bound)
    d_ref, i_ref = _numpy_topk(needles, haystack, valid, k, bound)
    assert np.array_equal(d, d_ref)
    assert np.array_equal(i, i_ref)
    # the tie block: needle 20 equals rows 9 and 300..339 (5 tombstoned)
    if k >= 36:
        assert list(i[20, :36]) == [9] + [r for r in range(300, 340)
                                          if not 310 <= r < 315]


def test_empty_inputs():
    d, i = tk.hamming_topk(torch.zeros(3, dtype=torch.int64),
                           torch.zeros(0, dtype=torch.int64),
                           torch.zeros(0, dtype=torch.bool), 4)
    assert d.shape == (3, 4) and (d == tk.BAD_DIST).all() and (i == -1).all()


def test_groups_respect_budget(data):
    """Each scan launch holds at most the key budget, or one needle's slots,
    in both passes; the result does not depend on the budget."""
    haystack, needles, valid = data
    nd, h = _t(needles), _t(haystack)
    v = torch.from_numpy(valid.copy())
    seen = []

    def scan(sub, rows, hist, cut, c_all, cursor, keys):
        seen.append((cursor.numel(), c_all, keys.numel(), cut is None))
        tk.topk_scan_plain(sub, h, v, 65, rows, hist, cut, c_all, cursor,
                           keys)
    got, second = tk.topk_passes(scan, nd, len(haystack), 40, max_keys=200)
    launches = seen[:]
    want, _ = tk.topk_passes(scan, nd, len(haystack), 40)
    assert torch.equal(got, want) and second == len(needles)
    first = [x[0] for x in launches if x[3]]
    assert first == [3] * 42 + [2]  # 200 // 64 needles a launch
    assert len(launches) > len(first)  # the cut pass ran, split too
    for q, c_all, slots, _ in launches:
        assert slots == q * c_all and (slots <= 200 or q == 1)


def test_wrapper_has_no_fallback(monkeypatch):
    """A non-CPU tensor takes the kernel path: when the kernel cannot be
    built or loaded the call raises instead of returning the plain result."""
    def broken():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(tk, "_load", broken)
    h = torch.empty(16, dtype=torch.int64, device="meta")
    v = torch.empty(16, dtype=torch.bool, device="meta")
    before = tk.hamming_topk.launches
    for k in (1, 64, 4096):
        with pytest.raises(RuntimeError, match="unavailable"):
            tk.hamming_topk(h[:4], h, v, k)
    assert tk.hamming_topk.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,bound", [(1, 65), (64, 5), (4096, 65)])
def test_kernel_matches_plain_on_card(data, cuda, k, bound):
    haystack, needles, valid = data
    args = (_t(needles).to(cuda), _t(haystack).to(cuda),
            torch.from_numpy(valid.copy()).to(cuda))
    before = tk.hamming_topk.launches
    d, i = tk.hamming_topk(*args, k, bound)
    torch.cuda.synchronize()
    dp, ip = tk.hamming_topk_plain(*args, k, bound)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert tk.hamming_topk.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("k,bound", [(16, 22), (64, 5), (8, 65)])
def test_scan_kernel_matches_plain_on_card(data, cuda, k, bound):
    """One topk_scan pass of the kernel against topk_scan_plain, in both
    modes: the histogram and cursors equal, each needle's written keys
    equal as sets (the order of its slots is free)."""
    haystack, needles, valid = data
    nd, h = _t(needles).to(cuda), _t(haystack).to(cuda)
    v = torch.from_numpy(valid.copy()).to(cuda)
    lib = tk._load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    c, q = tk.capacity(k, len(haystack)), len(needles)

    def run(kernel, hist, cut, c_all):
        cursor = torch.full((q,), 7, dtype=torch.int32, device=cuda)
        keys = torch.full((q * c_all,), -1, dtype=torch.int64, device=cuda)
        if kernel:
            assert lib.cbird_topk_scan(
                nd.data_ptr(), None, q, h.data_ptr(), v.data_ptr(),
                len(haystack), bound, tk._ptr(hist), tk._ptr(cut), c_all,
                cursor.data_ptr(), keys.data_ptr(), stream) == 0
            torch.cuda.synchronize()
        else:
            tk.topk_scan_plain(nd, h, v, bound, None, hist, cut, c_all,
                               cursor, keys)
        return cursor, keys.view(q, c_all)

    def same_rows(a, b, done):
        """Each complete needle's slots (hits, then empty) equal as sets."""
        for i in range(q):
            if done[i]:
                assert torch.equal(a[i].sort().values, b[i].sort().values), i

    hists = [torch.ones((q, tk.BINS), dtype=torch.int32, device=cuda)
             for _ in range(2)]  # the scan zeroes its outputs first
    (cur_k, keys_k), (cur_p, keys_p) = (run(kern, hists[kern], None, c)
                                        for kern in (1, 0))
    assert torch.equal(hists[0], hists[1]) and torch.equal(cur_k, cur_p)
    same_rows(keys_k, keys_p, (cur_k <= c).tolist())
    cut, size = tk.cut_sizes(hists[0].cpu().numpy(), k)
    width = tk.capacity(int(size.max()), len(haystack))
    cut = torch.from_numpy(cut).to(cuda)
    (cur_k, keys_k), (cur_p, keys_p) = (run(kern, None, cut, width)
                                        for kern in (1, 0))
    assert cur_k.tolist() == size.tolist() == cur_p.tolist()
    same_rows(keys_k, keys_p, [True] * q)
