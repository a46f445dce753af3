"""Port parity: the exact top-k kernel (K4) of cbird_tpu_torch against the
JAX package's Pallas top-k (interpret mode) and a numpy reference.

The port's contract is exact: the k smallest (distance, store row) keys
among valid rows below the bound, so lists compare exactly, ties
included.  ``hamming_topk_pallas`` is exact as well but asserts k <= 64;
larger k (the self-search saturation escalation asks up to 65536) is held
to numpy.  On the CPU the wrapper runs its plain twin; the CUDA kernel is
compared with that twin on the card (``-m cuda`` here, and chip_smoke.py).
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


def test_groups_respect_budget():
    sizes = np.array([5, 5, 5, 20, 1, 1])
    assert list(tk._groups(sizes, 10)) == [(0, 2), (2, 3), (3, 4), (4, 6)]
    # the needle cap keeps the needle index of the sort key below 2^23
    assert list(tk._groups(np.zeros(5, int), 10, max_needles=2)) == [
        (0, 2), (2, 4), (4, 5)]


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
