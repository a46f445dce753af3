"""Port parity of the 256-bit k-nearest search (K5):
``cbird_tpu_torch.ops.hamming_lanes`` against ``cbird_tpu.ops.hamming``
``hamming_lanes_topk`` on the JAX CPU backend.

The JAX function returns, in an empty slot (fewer valid rows than k),
BAD_DIST and the index of some invalid row; the port returns BAD_DIST and
row -1 there.  Up to 16384 rows it takes one exact top-k, whose ties go to
the lower row, as the port's do.  Above that it scans 16384-row chunks
with ``approx_min_k``: on the CPU backend that is exact in its distances
(checked here against numpy), but among equal distances it returns any of
the tied rows, so there the port's rows are checked as the lowest rows of
each distance and the JAX rows as rows of that distance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cbird_tpu.ops.hamming import BAD_DIST, hamming_lanes_topk as jax_topk
from cbird_tpu_torch.ops import hamming_lanes as hl

torch.set_num_threads(1)


def data(t: int, q: int, seed: int):
    """[t, 8] uint32 rows with planted ties and 10% invalid rows; q needles
    near stored rows (and one far from all)."""
    rng = np.random.default_rng(seed)
    hay = rng.integers(0, 2**32, size=(t, 8), dtype=np.uint32)
    if t > 50:
        hay[t // 3:t // 3 + 20] = hay[7]  # 21 rows at one distance
        hay[t // 2:t // 2 + 5, 0] = hay[7, 0] ^ 1
    valid = rng.random(t) > 0.1
    nd = hay[rng.integers(0, t, q)].copy()
    nd[:, 0] ^= np.uint32(3)
    nd[0] = hay[min(7, t - 1)]
    return nd, hay, valid


def torch_args(nd, hay, valid):
    return (torch.from_numpy(np.ascontiguousarray(nd).view(np.int64)),
            torch.from_numpy(np.ascontiguousarray(hay).view(np.int64)),
            torch.from_numpy(valid))


def brute(nd, hay, valid):
    """[q, t] distances by numpy (invalid rows: BAD_DIST)."""
    x = np.bitwise_xor(nd[:, None, :], hay[None, :, :])
    d = np.bitwise_count(x).sum(axis=2).astype(np.int64)
    return np.where(valid[None, :], d, BAD_DIST)


@pytest.mark.parametrize("t", [1, 100, 16384, 20000])
@pytest.mark.parametrize("q", [1, 64, 513])
def test_plain_matches_jax(t, q):
    nd, hay, valid = data(t, q, seed=t + q)
    dist = brute(nd, hay, valid)
    for k in (1, 10):
        dj, ij = [np.asarray(a) for a in jax_topk(
            jnp.asarray(nd), jnp.asarray(hay), jnp.asarray(valid), k=k)]
        kk = dj.shape[1]  # the JAX function caps k at the row count
        assert kk == min(k, t)
        dp, ip = [a.numpy() for a in hl.hamming_lanes_topk(
            *torch_args(nd, hay, valid), kk)]
        want = np.sort(dist, axis=1)[:, :kk]
        assert np.array_equal(dj, want) and np.array_equal(dp, want)
        empty = dj == BAD_DIST
        assert (ip[empty] == -1).all()
        # the port: each distance's lowest rows
        order = np.lexsort((np.broadcast_to(np.arange(t), dist.shape), dist),
                           axis=1)[:, :kk]
        assert np.array_equal(ip[~empty], order[~empty])
        if t <= 1 << 14:  # one exact top-k: the JAX rows are the same
            assert np.array_equal(ij[~empty], ip[~empty])
        else:  # approx_min_k: some rows at each distance
            rows = ij[~empty]
            assert (dist[np.nonzero(~empty)[0], rows] == dj[~empty]).all()
        if t > 50:
            assert (dj[0, :kk] == 0).all()  # needle 0 and its ties


@pytest.mark.parametrize("bound", [0, 25, 130, 257])
def test_bound_is_a_filter(bound):
    """The bounded call equals the unbounded call filtered to d < bound."""
    nd, hay, valid = data(3000, 70, seed=5)
    args = torch_args(nd, hay, valid)
    d0, i0 = hl.hamming_lanes_topk(*args, 10)
    d1, i1 = hl.hamming_lanes_topk(*args, 10, bound)
    keep = d0 < bound
    assert torch.equal(d1, torch.where(keep, d0, hl.BAD_DIST))
    assert torch.equal(i1, torch.where(keep, i0, -1))


def test_wrapper_has_no_fallback(monkeypatch):
    """A CPU tensor runs the plain twin; any other device launches the
    kernel or raises (here: no CUDA, so the build raises)."""
    calls = []
    monkeypatch.setattr(hl, "hamming_lanes_topk_plain",
                        lambda *a: calls.append(a) or (None, None))
    nd, hay, valid = torch_args(*data(10, 2, seed=1))
    hl.hamming_lanes_topk(nd, hay, valid, 3)
    assert len(calls) == 1
    with pytest.raises(Exception):
        hl.hamming_lanes_topk(nd.to("meta"), hay.to("meta"),
                              valid.to("meta"), 3)
    assert len(calls) == 1 and hl.hamming_lanes_topk.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 10])
def test_kernel_matches_plain_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for t, q in ((1, 1), (257, 65), (20000, 513)):
        nd, hay, valid = data(t, q, seed=t)
        valid[:t // 4] = False  # an all-invalid range
        args = torch_args(nd, hay, valid)
        for bound in (25, 257):
            want = hl.hamming_lanes_topk_plain(*args, k, bound)
            got = hl.hamming_lanes_topk(*(a.cuda() for a in args), k, bound)
            torch.cuda.synchronize()
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])
