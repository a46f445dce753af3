"""Port parity: the tensor-core count kernels (K1-mma and its masked form
K2-mma) of cbird_tpu_torch against the JAX package's Pallas +-1 product
kernels (``mxu_count_below`` and ``mxu_count_triangle``, interpret mode:
the K1 variants of ``experiments/`` share their contract and have no
interpret mode), a numpy golden and the popcount K1 / K2; and the routes
of the image gate and the self-search triangle through them.

Counts are integers and must be equal exactly.  On the CPU the wrapper
runs its plain PyTorch twin; the CUDA kernel itself, in both its operand
types (e4m3 and bf16, one wgmma kernel template), is compared with that
twin on the card (``-m cuda`` here, and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cbird_tpu.ops import mxu_count as mc
from cbird_tpu.ops.dct_hash import split_u64
from cbird_tpu_torch.ops import count_below as cb
from cbird_tpu_torch.ops import count_below_mma as cm

torch.set_num_threads(1)

N, Q = 4096, 256
THRESHOLDS = [0, 1, 5, 33, 63]


def _flip(h, bits):
    """h with ``bits`` distinct random bits flipped (seeded per call site)."""
    rng = np.random.default_rng(int(bits) * 7919 + int(h % 1000))
    mask = sum(1 << int(b) for b in rng.choice(64, size=bits, replace=False))
    return np.uint64(int(h) ^ mask)


@pytest.fixture(scope="module")
def data():
    """Random store with 3% tombstones; needles planted at distance t - 1
    and t from valid rows for every tested t (the edge the compare must
    get right), the rest near-random."""
    rng = np.random.default_rng(11)
    hashes = rng.integers(0, 2**64, size=N, dtype=np.uint64)
    valid = rng.random(N) > 0.03
    needles = hashes[rng.integers(0, N, Q)] ^ (
        np.uint64(1) << rng.integers(0, 64, Q).astype(np.uint64))
    rows = np.nonzero(valid)[0]
    j = 0
    for t in THRESHOLDS:
        for bits in (t - 1, t):
            if 0 <= bits <= 64:
                needles[j] = _flip(hashes[rows[j]], bits)
                j += 1
    needles[j] = hashes[np.nonzero(~valid)[0][0]]  # only a tombstone's twin
    return hashes, valid, needles


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def _golden(hashes, valid, needles, t):
    d = np.bitwise_count(needles[:, None] ^ hashes[None, :])
    return ((d < t) & valid[None, :]).sum(axis=1).astype(np.int32)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(mc, "_INTERPRET", True)


@pytest.mark.parametrize("t,bf16", [(t, False) for t in THRESHOLDS]
                         + [(5, True)],
                         ids=[str(t) for t in THRESHOLDS] + ["bf16-5"])
def test_count_matches_mxu_and_golden(data, interpret, t, bf16):
    """The port on a ragged needle batch (251 of 256) against the Pallas
    kernel on the whole tile and the numpy golden; the bf16 route too."""
    hashes, valid, needles = data
    want = np.asarray(mc.mxu_count_below(
        jnp.asarray(split_u64(needles)), jnp.asarray(split_u64(hashes)),
        jnp.asarray(valid.astype(np.int32)), jnp.int32(t),
        bq=mc.BQ, bc=mc.BC))
    assert np.array_equal(want, _golden(hashes, valid, needles, t))
    q = Q - 5
    got = cm.count_below_mma(_t(needles[:q]), _t(hashes),
                             torch.from_numpy(valid.copy()), t,
                             bf16=bf16).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want[:q])


def test_planted_edges_counted(data):
    """Needle 2i sits at distance t - 1 from a valid row (counts), needle
    2i + 1 at distance t (does not), for each tested t."""
    hashes, valid, needles = data
    hs, vs = _t(hashes), torch.from_numpy(valid.copy())
    j = 0
    for t in THRESHOLDS:
        for bits in (t - 1, t):
            if bits < 0:
                continue
            got = cm.count_below_mma(_t(needles[j:j + 1]), hs, vs, t)
            d = np.bitwise_count(needles[j] ^ hashes)
            assert int(got[0]) == int(((d < t) & valid).sum()), (t, bits)
            j += 1
    lone = cm.count_below_mma(_t(needles[j:j + 1]), hs, vs, 1)
    assert int(lone[0]) == int(((np.bitwise_count(needles[j] ^ hashes) < 1)
                                & valid).sum())


def test_count_gate_and_threshold_range(data):
    """count_gate is the +-1 form at every threshold: at t = 64 every
    valid row but a needle's complement counts, at 65 and above every
    valid row, as popcount < t gives; a negative threshold raises."""
    hashes, valid, needles = data
    hs, vs, nd = _t(hashes), torch.from_numpy(valid.copy()), _t(needles)
    nd[3] = ~hs[10]  # a complement: distance 64 to a valid row
    assert valid[10]
    assert torch.equal(cm.count_gate(nd, hs, vs, 5),
                       cb.count_below(nd, hs, vs, 5))
    everything = torch.full((Q,), int(valid.sum()), dtype=torch.int32)
    for t in (65, 100):
        assert torch.equal(cm.count_gate(nd, hs, vs, t), everything)
    got64 = cm.count_gate(nd, hs, vs, 64)
    assert int(got64[3]) == int(valid.sum()) - 1
    assert torch.equal(got64, cb.count_below(nd, hs, vs, 64))
    with pytest.raises(ValueError, match=">= 0"):
        cm.count_below_mma(nd, hs, vs, -1)


# (row_base, col_base, t) of a 256 x 1024 tile: the diagonal inside it,
# starting at its corner (an edge), and past it (every column above every
# row, so the mask drops nothing); then row_base - col_base at +-64 and
# +-257, beside the wgmma kernel's m64 and n-tile edges
MASK_CASES = [(512, 256, 5), (1024, 1024, 33), (0, 2048, 63),
              (320, 256, 5), (256, 320, 33), (769, 512, 63), (512, 769, 5)]


def _golden_masked(hashes, valid, needles, t, rb, c0):
    d = np.bitwise_count(needles[:, None] ^ hashes[None, :])
    rows = rb + np.arange(len(needles))[:, None]
    cols = c0 + np.arange(len(hashes))[None, :]
    return ((d < t) & valid[None, :] & (cols > rows)).sum(axis=1).astype(
        np.int32)


def c0popcount(*args, **kw):
    """The popcount K1 / K2 (count_below) as numpy."""
    return cb.count_below(*args, **kw).numpy()


@pytest.mark.parametrize(
    "rb,c0,t,bf16", [(*c, False) for c in MASK_CASES] + [(512, 256, 33, True)],
    ids=[f"{rb}-{c0}-{t}" for rb, c0, t in MASK_CASES] + ["bf16-512-256-33"])
def test_masked_matches_triangle_and_golden(data, interpret, rb, c0, t, bf16):
    """The masked form (K2-mma) on the CPU against the Pallas diagonal-tile
    kernel, the numpy golden and the popcount K2; the bf16 route too."""
    hashes, valid, _ = data
    rows, cols = mc.BQ, mc.BC_MASKED
    nd = hashes[rb:rb + rows]
    hs, vs = hashes[c0:c0 + cols], valid[c0:c0 + cols]
    want = np.asarray(mc.mxu_count_triangle(
        jnp.asarray(split_u64(nd)), jnp.asarray(split_u64(hs)),
        jnp.asarray(vs.astype(np.int32)), jnp.int32(t), jnp.int32(rb),
        jnp.int32(c0), bq=mc.BQ, bc=mc.BC_MASKED))
    assert np.array_equal(want, _golden_masked(hs, vs, nd, t, rb, c0))
    args = (_t(nd), _t(hs), torch.from_numpy(vs.copy()), t)
    kw = dict(masked=True, row_base=rb, col_base=c0)
    got = cm.count_below_mma(*args, bf16=bf16, **kw).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, c0popcount(*args, **kw))
    if c0 >= rb + rows:
        assert np.array_equal(got, cm.count_below_mma(*args).numpy())


@pytest.mark.parametrize("t", [64, 65, 100])
def test_high_thresholds_equal_popcount(data, t):
    """Above 63 (where the Pallas kernels' callers never go) the gate and
    the masked form equal the numpy golden and the popcount K1 / K2."""
    hashes, valid, needles = data
    needles = needles.copy()
    needles[3] = ~hashes[10]  # distance 64 to a valid row
    hs, vs, nd = _t(hashes), torch.from_numpy(valid.copy()), _t(needles)
    got = cm.count_gate(nd, hs, vs, t).numpy()
    assert np.array_equal(got, _golden(hashes, valid, needles, t))
    assert np.array_equal(got, c0popcount(nd, hs, vs, t))
    rb = 100
    kw = dict(masked=True, row_base=rb, col_base=0)
    got = cm.count_below_mma(_t(hashes[rb:rb + Q]), hs, vs, t, **kw).numpy()
    assert np.array_equal(got, _golden_masked(hashes, valid,
                                              hashes[rb:rb + Q], t, rb, 0))
    assert np.array_equal(got, c0popcount(_t(hashes[rb:rb + Q]), hs, vs, t,
                                           **kw))


def test_search_and_triangle_take_count_mma(monkeypatch):
    """PackedHashStore.search's count gate and search_self's triangle tiles
    (unmasked and, on the diagonal tiles, masked) go through
    count_below_mma, never the popcount K1/K2."""
    from cbird_tpu_torch.ops import hamming as th
    from cbird_tpu_torch.ops import pigeonhole as tp
    monkeypatch.setattr(tp, "enabled", lambda: False)
    calls = []
    real = cm.count_below_mma

    def spy(*a, **kw):
        calls.append(kw.get("masked", False))
        return real(*a, **kw)

    def popcount(*a, **kw):
        raise AssertionError("the popcount K1/K2 ran")
    monkeypatch.setattr(cm, "count_below_mma", spy)
    monkeypatch.setattr(cb, "count_below", popcount)
    rng = np.random.default_rng(12)
    hashes = rng.integers(1, 2**63, size=4200, dtype=np.uint64)
    hashes[4000] = hashes[7] ^ np.uint64(1 << 5)
    store = th.PackedHashStore(hashes, np.arange(1, 4201, dtype=np.uint32),
                               device="cpu")
    res = store.search(hashes[:100], 5, k=8, min_hits=2)
    assert calls == [False] and 4001 in res[7][0]
    calls.clear()
    res = store.search_self(5, k=8, rows=1024, cols=2048, min_n=0)
    assert store.pigeonhole is None and True in calls and False in calls
    assert 4001 in res[7][0] and 8 in res[4000][0]


def test_unpack_dot_identity(data):
    """dot(+-1(a), +-1(b)) = 64 - 2 * ham(a, b), in both operand types."""
    hashes, _, needles = data
    a, b = _t(needles[:64]), _t(hashes[:64])
    ham = np.bitwise_count(needles[:64, None] ^ hashes[None, :64]).astype(int)
    for dtype in (torch.float32, torch.bfloat16):
        dot = (cm.unpack_pm1(a, dtype).float()
               @ cm.unpack_pm1(b, dtype).float().T).numpy()
        assert np.array_equal(dot, 64 - 2 * ham)


def _counters():
    f = cm.count_below_mma
    return f.launches, f.masked_launches, f.bf16_launches


def test_wrapper_has_no_fallback(monkeypatch):
    """A non-CPU tensor takes the kernel path: when the kernel cannot be
    built or loaded the call raises instead of returning the plain result."""
    def broken():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(cm, "_load", broken)
    h = torch.empty(16, dtype=torch.int64, device="meta")
    v = torch.empty(16, dtype=torch.bool, device="meta")
    before = _counters()
    for bf16 in (False, True):
        for masked in (False, True):
            with pytest.raises(RuntimeError, match="unavailable"):
                cm.count_below_mma(h[:4], h, v, 5, bf16=bf16, masked=masked)
    assert _counters() == before


# the wgmma kernel's tile edges (csrc/count_below_mma.cu: units of 192
# rows, three consumers of one m64 tile each; e4m3: n-tiles of 256
# columns, steps of 1024 columns, a ring of 2 steps and one of 4 packed
# steps; bf16: n-tiles of 128, steps of 512, rings of 3 and 2): needle
# counts around an m64 tile and a unit's rows (one and two units), column
# counts around a tile, a step, one past each ring's wrap, and the
# diagonal's offset (row_base - col_base) on and beside the m64, n-tile
# and step edges and past the tile
EDGE_Q = (1, 63, 65, 127, 129, 191, 193, 255, 257, 383, 385)
EDGE_N = (1, 127, 129, 255, 257, 511, 513, 1023, 1025, 1537, 2049,
          4097)
EDGE_T = (0, 5, 33, 63, 64, 65)
EDGE_D = (0, 1, -1, 63, -63, 64, -64, 127, -127, 128, -128, 255, -255, 256,
          -256, 257, -257, 511, -511, 512, -512, 513, -513, 1023, -1023, 1024,
          -1024, 1025, -1025, 1500, -1500)


def _edge_store(n=6144, seed=13):
    """Hashes whose rows are often near copies (0-4 bits) of a row 1-300
    before them, so near pairs lie on both sides of any diagonal; 1%
    tombstones and an all-invalid slot of 256 columns."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    for i in np.nonzero(rng.random(n) < 0.3)[0]:
        if i >= 300:
            h[i] = _flip(h[i - rng.integers(1, 301)], int(rng.integers(0, 5)))
    valid = rng.random(n) > 0.01
    valid[1024:1280] = False
    return h, valid


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain_on_card(data, cuda, bf16):
    """Both forms on a ragged Q and N, every tested t plus 8 and 32, bit for
    bit against the plain twin and the popcount K1."""
    hashes, valid, needles = data
    hs, vs = _t(hashes).to(cuda), torch.from_numpy(valid.copy()).to(cuda)
    nd = _t(needles).to(cuda)
    counter = "bf16_launches" if bf16 else "launches"
    before = getattr(cm.count_below_mma, counter)
    for t in THRESHOLDS + [8, 32]:
        got = cm.count_below_mma(nd[:251], hs[:4001], vs[:4001], t, bf16=bf16)
        torch.cuda.synchronize()
        want = cm.count_below_mma_plain(nd[:251], hs[:4001], vs[:4001], t)
        assert torch.equal(got, want), t
        assert torch.equal(got, cb.count_below(nd[:251], hs[:4001],
                                               vs[:4001], t)), t
    assert getattr(cm.count_below_mma, counter) == before + 7


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_masked_kernel_matches_plain_on_card(data, cuda, bf16):
    """The masked form on a ragged Q and N, bit for bit against the plain
    twin and the popcount K2: the diagonal inside a 256-column step, on a
    step edge, past the tile and below it, at t in {0, 5, 33, 63, 64, 65}."""
    hashes, valid, _ = data
    hs, vs = _t(hashes).to(cuda), torch.from_numpy(valid.copy()).to(cuda)
    before = _counters()
    calls = 0
    for rb, c0 in ((300, 100), (512, 256), (0, 2048), (2048, 0)):
        nd = hs[rb:rb + 251]
        for t in (0, 5, 33, 63, 64, 65):
            args = (nd, hs[c0:c0 + 2001], vs[c0:c0 + 2001], t)
            kw = dict(masked=True, row_base=rb, col_base=c0)
            got = cm.count_below_mma(*args, bf16=bf16, **kw)
            torch.cuda.synchronize()
            calls += 1
            assert torch.equal(got, cm.count_below_mma_plain(*args, **kw)), \
                (rb, c0, t)
            assert torch.equal(got, cb.count_below(*args, **kw)), (rb, c0, t)
    want = list(before)
    want[2 if bf16 else 1] += calls
    assert _counters() == tuple(want)


def _launches(bf16: bool, masked: bool) -> int:
    f = cm.count_below_mma
    return (f.bf16_launches if bf16 else f.masked_launches if masked
            else f.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_tile_edges_on_card(cuda, bf16):
    """Each form at its tile edges, bit for bit against the plain twin
    and the popcount K1: every Q in EDGE_Q x N in EDGE_N x t in EDGE_T,
    from a column on a 16-byte boundary (its second slot all invalid) and
    from one off it; then a launch whose blocks walk more than one unit
    (Q = 34048: 178 units of 192 rows)."""
    h, valid = _edge_store()
    hs, vs = _t(h).to(cuda), torch.from_numpy(valid).to(cuda)
    nd = _t(h[3000:3000 + max(EDGE_Q)] ^ np.uint64(0x11)).to(cuda)
    before = _launches(bf16, False)
    calls = 0
    for c0 in (768, 901):
        for q in EDGE_Q:
            for n in EDGE_N:
                for t in EDGE_T:
                    args = (nd[:q], hs[c0:c0 + n], vs[c0:c0 + n], t)
                    got = cm.count_below_mma(*args, bf16=bf16)
                    torch.cuda.synchronize()
                    calls += 1
                    what = (c0, q, n, t)
                    assert torch.equal(got, cm.count_below_mma_plain(*args)), \
                        what
                    assert torch.equal(got, cb.count_below(*args)), what
    many = _t(np.resize(h, 266 * 128) ^ np.uint64(3)).to(cuda)
    for t in (5, 65):
        got = cm.count_below_mma(many, hs[:1000], vs[:1000], t, bf16=bf16)
        calls += 1
        assert torch.equal(got, cb.count_below(many, hs[:1000], vs[:1000],
                                               t)), t
    assert _launches(bf16, False) == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_masked_kernel_tile_edges_on_card(cuda, bf16):
    """Each masked form (K2-mma) with the diagonal at each offset of
    EDGE_D, at Q in {65, 257} x N in {257, 513, 1025}, t in EDGE_T, at
    32-bit and 64-bit ids, bit for bit against the plain twin and the
    popcount K2."""
    h, valid = _edge_store()
    hs, vs = _t(h).to(cuda), torch.from_numpy(valid).to(cuda)
    before = _launches(bf16, True)
    calls, hits = 0, 0
    s = 2500
    for d in EDGE_D:
        for q in (65, 257):
            for n in (257, 513, 1025):
                for base in (0, 1 << 33):
                    for t in EDGE_T:
                        args = (hs[s + d:s + d + q], hs[s:s + n],
                                vs[s:s + n], t)
                        kw = dict(masked=True, row_base=base + s + d,
                                  col_base=base + s)
                        got = cm.count_below_mma(*args, bf16=bf16, **kw)
                        torch.cuda.synchronize()
                        calls += 1
                        what = (d, q, n, base, t)
                        assert torch.equal(got, cm.count_below_mma_plain(
                            *args, **kw)), what
                        assert torch.equal(got, cb.count_below(*args, **kw)), \
                            what
                        hits += int(got.sum()) if t == 5 else 0
    assert hits > 0
    assert _launches(bf16, True) == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_whole_haystack_chunk_is_exact_on_card(cuda, bf16):
    """So many needles (over 16 units an SM at two chunks) that each unit
    takes the whole haystack as its chunk, over 2^26 + 2^24 + 12345
    columns with 1% invalid: at t = 65 every valid column counts, so each
    row counts them all.  Each lane of a row's quad sums a quarter of
    them, past the 2^24 that a float sum holds exactly."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    q, n = 8 * sms * 192 + 1, (1 << 26) + (1 << 24) + 12345
    gen = torch.Generator(device=cuda).manual_seed(17)
    hay = torch.randint(-2**62, 2**62, (n,), device=cuda, generator=gen)
    valid = torch.rand(n, device=cuda, generator=gen) > 0.01
    nd = torch.randint(-2**62, 2**62, (q,), device=cuda, generator=gen)
    before = _launches(bf16, False)
    got = cm.count_below_mma(nd, hay, valid, 65, bf16=bf16)
    assert _launches(bf16, False) == before + 1
    assert torch.equal(got, torch.full_like(got, int(valid.sum())))
