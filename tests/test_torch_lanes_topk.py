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
    d = np.zeros((len(nd), len(hay)), np.int64)
    for lane in range(nd.shape[1]):
        d += np.bitwise_count(nd[:, None, lane] ^ hay[None, :, lane])
    return np.where(valid[None, :], d, BAD_DIST)


@pytest.mark.parametrize("t", [1, 100, 16384, 20000])
@pytest.mark.parametrize("q", [1, 64, 513])
def test_plain_matches_jax(t, q):
    nd, hay, valid = data(t, q, seed=t + q)
    dist = brute(nd, hay, valid)
    # the port: each distance's lowest rows
    order = np.argsort(dist, axis=1, kind="stable")[:, :10]
    want10 = np.take_along_axis(dist, order, axis=1)
    for k in (1, 10):
        dj, ij = [np.asarray(a) for a in jax_topk(
            jnp.asarray(nd), jnp.asarray(hay), jnp.asarray(valid), k=k)]
        kk = dj.shape[1]  # the JAX function caps k at the row count
        assert kk == min(k, t)
        dp, ip = [a.numpy() for a in hl.hamming_lanes_topk(
            *torch_args(nd, hay, valid), kk)]
        want = want10[:, :kk]
        assert np.array_equal(dj, want) and np.array_equal(dp, want)
        empty = dj == BAD_DIST
        assert (ip[empty] == -1).all()
        assert np.array_equal(ip[~empty], order[:, :kk][~empty])
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
    tensor-core kernel or raises (here: no CUDA, so the build raises),
    without falling back to the popcount form or the plain twin."""
    calls = []
    monkeypatch.setattr(hl, "hamming_lanes_topk_plain",
                        lambda *a: calls.append(a) or (None, None))
    monkeypatch.setattr(hl, "hamming_lanes_topk_popc",
                        lambda *a: calls.append(("popc",)) or (None, None))
    nd, hay, valid = torch_args(*data(10, 2, seed=1))
    hl.hamming_lanes_topk(nd, hay, valid, 3)
    assert len(calls) == 1
    with pytest.raises(Exception):
        hl.hamming_lanes_topk(nd.to("meta"), hay.to("meta"),
                              valid.to("meta"), 3)
    assert len(calls) == 1 and hl.hamming_lanes_topk.launches == 0


def test_launch_error_raises(monkeypatch):
    """A launch the kernel refuses raises with CUDA's message; nothing
    else runs in its place."""
    class Lib:
        def cbird_lanes_topk(self, *a):
            return 98  # cudaErrorInvalidDeviceFunction

        def cbird_error_string(self, err):
            return b"invalid device function"
    calls = []
    monkeypatch.setattr(hl, "_load", Lib)
    monkeypatch.setattr(hl, "check_operands", lambda *a: None)
    monkeypatch.setattr(hl, "hamming_lanes_topk_plain",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(hl, "hamming_lanes_topk_popc",
                        lambda *a: calls.append(a))

    class Card:  # the operands' device type and shapes, as CUDA tensors
        def __init__(self, shape):
            self.shape = shape
            self.device = torch.device("meta")

        def data_ptr(self):
            return 0
    monkeypatch.setattr(hl.torch, "empty", lambda *a, **kw: Card(a[0]))
    monkeypatch.setattr(hl.torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132}))
    monkeypatch.setattr(hl.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    nd, hay, valid = Card((5, 4)), Card((3000, 4)), Card((3000,))
    for t in (nd, hay, valid):
        t.device = type("D", (), {"type": "cuda"})()
    with pytest.raises(RuntimeError, match="invalid device function"):
        hl.hamming_lanes_topk(nd, hay, valid, 10, 25)
    assert calls == [] and hl.hamming_lanes_topk.launches == 0


# ---- the tensor-core kernel's order of work, modelled on the CPU ----------
EMPTY32 = 0xFFFFFFFF
OFF_BITS = 23


def tc_model(nd, hay, valid, k: int, bound: int, sms: int, stats=None):
    """Test-only model of csrc/hamming_lanes_topk.cu's lanes_wgmma and
    lanes_merge, in their order of work: the column chunks of
    ``hl.tc_plan``; units of 192 needles x a chunk; steps of 256 columns
    (one n-tile) in ascending order; a sorted list of list_size(k) keys a
    row (d << 23 | the column's offset in the chunk: the candidate slots);
    a column is admitted only below its row's limit (the bound, or the
    list's last distance once it is full), updated between steps, and then
    only if valid and its key is below the list's last; at a unit's end
    each row's list goes out as (d << 32 | row) keys, one list a chunk, and
    lanes_merge takes each needle's first k over its chunks.  ``stats`` (a
    dict) counts the warp-steps (16 rows), those whose vote takes the rare
    case, and the columns admitted at each step of a unit."""
    q, t = len(nd), len(hay)
    kt = hl.list_size(k)
    dist = brute(nd, hay, np.ones(t, bool))
    xc, chunk = hl.tc_plan(q, t, sms)
    parts = []
    for x in range(xc):
        cs, cend = x * chunk, min(t, (x + 1) * chunk)
        part = np.empty((q, kt), np.int64)
        for y0 in range(0, q, 192):
            rows = np.arange(y0, min(q, y0 + 192))  # rows past q admit none
            lists = np.full((len(rows), kt), EMPTY32, np.int64)
            lim = np.full(len(rows), bound)
            for step, c0 in enumerate(range(cs, cend, 256)):
                cols = np.arange(c0, min(cend, c0 + 256))
                d = dist[rows][:, cols]
                below = d < lim[:, None]
                ok = below & valid[cols][None, :]
                if stats is not None:
                    warps = np.add.reduceat(below.any(axis=1),
                                            np.arange(0, len(rows), 16))
                    stats["steps"] = stats.get("steps", 0) + len(warps)
                    stats["rare"] = stats.get("rare", 0) + int(
                        (warps > 0).sum())
                    at = stats.setdefault("admitted", {})
                    at[step] = at.get(step, 0) + int(ok.sum())
                key = np.where(ok, (d << OFF_BITS) | (cols - cs), EMPTY32)
                lists = np.sort(np.concatenate([lists, key], axis=1),
                                axis=1)[:, :kt]
                lim = np.minimum(lim, lists[:, kt - 1] >> OFF_BITS)
            part[rows] = np.where(
                lists == EMPTY32, hl._NONE,
                ((lists >> OFF_BITS) << 32)
                | (cs + (lists & (2**OFF_BITS - 1))))
        parts.append(part)
    keys = np.full((q, k), hl._NONE, np.int64)
    if parts:
        keys = np.sort(np.concatenate(parts + [keys], axis=1), axis=1)[:, :k]
    return (keys >> 32).astype(np.int32), keys.astype(np.int32)


def planted(t: int = 3000, q: int = 200, seed: int = 9):
    """Rows with ties across the tile edge at 256 and the tile and chunk
    edge at 1024 (the chunks of tc_plan(200, 3000, 3)), 15 rows at distance
    0 from one needle (more than k), an all-invalid range that holds more
    copies, and 10% invalid rows elsewhere."""
    rng = np.random.default_rng(seed)
    hay = rng.integers(0, 2**32, size=(t, 8), dtype=np.uint32)
    hay[250:262] = hay[6]  # across the tile edge at 256
    hay[2040:2056] = hay[6] ^ np.uint32(1)  # across 2048, one bit away
    hay[1018:1032] = hay[5]  # across 1024: 15 rows at 0 from needle 1
    hay[1600:1610] = hay[5]  # inside the invalid range
    valid = rng.random(t) > 0.1
    valid[[5, 6, 250, 255, 256, 1018, 1023, 1024, 1031, 2047, 2048]] = True
    valid[1500:1800] = False  # an all-invalid range
    nd = hay[rng.integers(0, t, q)].copy()
    nd[:, 3] ^= np.uint32(0x10001)
    nd[0], nd[1], nd[2] = hay[6], hay[5], hay[6] ^ np.uint32(3 << 8)
    return nd, hay, valid


@pytest.fixture(scope="module")
def planted_case():
    nd, hay, valid = planted()
    want = {(k, b): [a.numpy() for a in hl.hamming_lanes_topk_plain(
        *torch_args(nd, hay, valid), k, b)]
        for k in (1, 10) for b in (0, 1, 25, 256, 257)}
    return nd, hay, valid, want


def test_plain_matches_jax_on_planted_ties(planted_case):
    """The planted rows through the JAX function (one exact top-k below
    16384 rows) equal the plain twin unbounded, which the model is held
    to below."""
    nd, hay, valid, want = planted_case
    dj, ij = [np.asarray(a) for a in jax_topk(
        jnp.asarray(nd), jnp.asarray(hay), jnp.asarray(valid), k=10)]
    dp, ip = want[10, 257]
    assert np.array_equal(dj, dp)
    assert np.array_equal(ij[dj != BAD_DIST], ip[dp != BAD_DIST])
    assert (dp[1] == 0).all() and (ip[1] == [5, *range(1018, 1027)]).all()
    assert (dp[0, :6] == 0).all() and (ip[0, :6] == [6, *range(250, 255)]).all()


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("bound", [0, 1, 25, 256, 257])
def test_tile_order_model_matches_plain(planted_case, bound, sms):
    """The kernel's order of work gives the plain twin's lists: one chunk
    (sms 1), chunks of 1024 columns (3), a chunk a step (132)."""
    nd, hay, valid, want = planted_case
    xc, chunk = hl.tc_plan(len(nd), len(hay), sms)
    assert (xc, chunk) == {1: (1, 3072), 3: (3, 1024), 132: (12, 256)}[sms]
    for k in (1, 10):
        got = tc_model(nd, hay, valid, k, bound, sms)
        assert np.array_equal(got[0], want[k, bound][0]), (k, bound)
        assert np.array_equal(got[1], want[k, bound][1]), (k, bound)


def test_tile_order_model_rare_case_dies_out():
    """Unbounded, the first step of a unit admits every valid column; as
    the lists fill, the limit tightens and the admitted columns die out,
    though most warp-steps still take the rare case for some row."""
    nd, hay, valid = data(1 << 14, 64, seed=3)
    stats = {}
    got = tc_model(nd, hay, valid, 10, 257, 1, stats)
    want = hl.hamming_lanes_topk_plain(*torch_args(nd, hay, valid), 10)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())
    per_step = [stats["admitted"][s] for s in range(64)]
    assert per_step[0] > 0.8 * 64 * 256
    assert sum(per_step[48:]) < 0.01 * 16 * per_step[0]


def test_tc_plan_chunks_cover_the_rows():
    """Every chunk is whole steps of at most 2^23 columns, the chunks cover
    the rows, and few needles split the columns over the card."""
    for q, n in ((1, 1), (1, 1 << 20), (63, 257), (193, 1025),
                 (6400, 1 << 20), (8192, 1 << 20), (1, (1 << 31) - 1)):
        xc, chunk = hl.tc_plan(q, n, 132)
        assert chunk % hl.SUB == 0 and 0 < chunk <= hl.MAX_CHUNK
        assert (xc - 1) * chunk < n <= xc * chunk
    assert hl.tc_plan(1, 1 << 20, 132)[0] >= 64
    assert hl.tc_plan(5, 0, 132) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 10])
def test_kernel_matches_plain_on_card(k):
    """Both forms against the plain twin at the tensor-core form's edges:
    needle counts around an m64 tile and a unit of 192, row counts around
    a step of 256 and past the chunks' edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for t in (1, 255, 256, 257, 1023, 1025, 20000):
        for q in (1, 63, 64, 65, 191, 192, 193, 513):
            nd, hay, valid = data(t, q, seed=t + q)
            valid[:t // 4] = False  # an all-invalid range
            args = torch_args(nd, hay, valid)
            for bound in (25, 257):
                want = hl.hamming_lanes_topk_plain(*args, k, bound)
                for form in (hl.hamming_lanes_topk, hl.hamming_lanes_topk_popc):
                    got = form(*(a.cuda() for a in args), k, bound)
                    torch.cuda.synchronize()
                    assert torch.equal(got[0].cpu(), want[0]), (t, q, bound)
                    assert torch.equal(got[1].cpu(), want[1]), (t, q, bound)
