"""Port parity: the count kernel (K1/K2) of cbird_tpu_torch against the JAX
package's Pallas count kernels (interpret mode) and XLA popcount scans.

The same numpy inputs go through both; counts must be equal exactly
(integer sums).  On the CPU the port's wrapper runs its plain PyTorch
twin; the CUDA kernel itself is compared with that twin on the card
(``-m cuda`` here, and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cbird_tpu.ops import mxu_count as mc
from cbird_tpu.ops.dct_hash import split_u64
from cbird_tpu.ops.hamming import _self_count_tile, hamming_count_below
from cbird_tpu_torch.ops import count_below as cbm
from cbird_tpu_torch.ops import count_below_mma as cm

torch.set_num_threads(1)

N, Q = 8192, 256


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    hashes = rng.integers(0, 2**64, size=N, dtype=np.uint64)
    hashes[100:140] = hashes[5] ^ (np.uint64(1) << rng.integers(
        0, 64, 40).astype(np.uint64))  # a cluster the diagonal tiles see
    valid = rng.random(N) > 0.05
    needles = hashes[rng.integers(0, N, Q)] ^ (
        np.uint64(1) << rng.integers(0, 64, Q).astype(np.uint64))
    return hashes, valid, needles


@pytest.fixture
def interpret(monkeypatch):
    """Pallas interpreter on the CPU backend, scoped to the test (a module
    global would leak into other files on the same xdist worker)."""
    monkeypatch.setattr(mc, "_INTERPRET", True)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def _port(hashes, valid):
    return _t(hashes), torch.from_numpy(valid.copy())


@pytest.mark.parametrize("t", [1, 7, 63])
def test_count_below_matches_mxu(data, interpret, t):
    hashes, valid, needles = data
    want = np.asarray(mc.mxu_count_below(
        jnp.asarray(split_u64(needles)), jnp.asarray(split_u64(hashes)),
        jnp.asarray(valid.astype(np.int32)), jnp.int32(t),
        bq=mc.BQ, bc=mc.BC))
    got = cbm.count_below(_t(needles), *_port(hashes, valid), t).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_triangle_matches_mxu(data, interpret):
    """K2: the diagonal tile's strict column > row mask, in global ids;
    needle-row validity is not masked (as in mxu_count_triangle)."""
    hashes, valid, _ = data
    pairs = jnp.asarray(split_u64(hashes))
    v32 = jnp.asarray(valid.astype(np.int32))
    hs, vs = _port(hashes, valid)
    rows, cols = mc.BQ, 2048
    for rb, cb in [(0, 0), (1024, 0), (1792, 1024)]:
        want = np.asarray(mc.mxu_count_triangle(
            pairs[rb:rb + rows], pairs[cb:cb + cols], v32[cb:cb + cols],
            jnp.int32(7), jnp.int32(rb), jnp.int32(cb), bq=mc.BQ,
            bc=mc.BC_MASKED))
        got = cbm.count_below(hs[rb:rb + rows], hs[cb:cb + cols],
                              vs[cb:cb + cols], 7, masked=True,
                              row_base=rb, col_base=cb).numpy()
        assert np.array_equal(got, want), (rb, cb)


@pytest.mark.parametrize("rb,cb,masked", [(0, 0, True), (512, 4096, False),
                                          (4096, 4096, True)])
def test_self_tile_matches_reference(data, interpret, rb, cb, masked):
    """Tile slicing + row-validity zeroing (mxu_self_tile, ported on the
    tensor-core count), against the Pallas tile and the XLA scan
    tile."""
    hashes, valid, _ = data
    pairs = jnp.asarray(split_u64(hashes))
    rows, cols = 512, 4096
    acc = jnp.zeros(rows, jnp.int32)
    want_mxu = np.asarray(mc.mxu_self_tile(
        acc, jnp.int32(rb), jnp.int32(cb), pairs,
        jnp.asarray(valid.astype(np.int32)), jnp.int32(7), rows=rows,
        cols=cols, masked=masked))
    want_xla = np.asarray(_self_count_tile(
        acc, jnp.int32(rb), jnp.int32(cb), pairs, jnp.asarray(valid),
        jnp.int32(7), rows=rows, cols=cols, masked=masked))
    hs, vs = _port(hashes, valid)
    got = cm.self_tile(torch.zeros(rows, dtype=torch.int32), hs, vs, 7,
                       rb, cb, rows, cols, masked).numpy()
    assert np.array_equal(want_mxu, want_xla)
    assert np.array_equal(got, want_mxu)


def test_count_matches_xla_scan_ragged(data):
    """hamming_count_below pads its chunks; the port's kernel masks the
    ragged edge itself: Q and N divide no block size here."""
    hashes, valid, needles = data
    n, q = 5000, 37
    want = np.asarray(hamming_count_below(
        jnp.asarray(split_u64(needles[:q])), jnp.asarray(split_u64(hashes[:n])),
        jnp.asarray(valid[:n]), jnp.int32(30), chunk=1024))
    got = cbm.count_below(_t(needles[:q]), *_port(hashes[:n], valid[:n]),
                          30).numpy()
    assert np.array_equal(got, want)


def test_popcount_matches_numpy(data):
    hashes, _, _ = data
    got = cbm.popcount64(_t(hashes)).numpy()
    assert np.array_equal(got, np.bitwise_count(hashes).astype(np.int64))


def test_wrapper_has_no_fallback(monkeypatch):
    """A non-CPU tensor takes the kernel path: when the kernel cannot be
    built or loaded the call raises instead of returning the plain result."""
    def broken():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(cbm, "_load", broken)
    h = torch.empty(16, dtype=torch.int64, device="meta")
    v = torch.empty(16, dtype=torch.bool, device="meta")
    before = cbm.count_below.launches, cbm.count_below.masked_launches
    for masked in (False, True):
        with pytest.raises(RuntimeError, match="unavailable"):
            cbm.count_below(h[:4], h, v, 5, masked=masked)
    assert (cbm.count_below.launches,
            cbm.count_below.masked_launches) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain_on_card(data, cuda, masked):
    hashes, valid, needles = data
    hs, vs = _port(hashes, valid)
    hs, vs, nd = hs.to(cuda), vs.to(cuda), _t(needles).to(cuda)
    counter = "masked_launches" if masked else "launches"
    before = getattr(cbm.count_below, counter)
    got = cbm.count_below(nd, hs[:7777], vs[:7777], 9, masked=masked,
                          row_base=300, col_base=0)
    torch.cuda.synchronize()
    want = cbm.count_below_plain(nd, hs[:7777], vs[:7777], 9, masked=masked,
                                 row_base=300, col_base=0)
    assert torch.equal(got, want)
    assert getattr(cbm.count_below, counter) == before + 1
