"""Port parity: the tensor-core count kernel (K1-mma) of cbird_tpu_torch
against the JAX package's Pallas +-1 product kernel (``mxu_count_below``,
interpret mode: the K1 variants of ``experiments/`` share its contract and
have no interpret mode) and a numpy golden.

Counts are integers and must be equal exactly.  On the CPU the wrapper
runs its plain PyTorch twin; the CUDA kernel itself, in both its int8 and
bf16 forms, is compared with that twin on the card (``-m cuda`` here, and
chip_smoke.py).
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


@pytest.mark.parametrize("t", THRESHOLDS)
def test_count_matches_mxu_and_golden(data, interpret, t):
    """The port on a ragged needle batch (251 of 256) against the Pallas
    kernel on the whole tile and the numpy golden."""
    hashes, valid, needles = data
    want = np.asarray(mc.mxu_count_below(
        jnp.asarray(split_u64(needles)), jnp.asarray(split_u64(hashes)),
        jnp.asarray(valid.astype(np.int32)), jnp.int32(t),
        bq=mc.BQ, bc=mc.BC))
    assert np.array_equal(want, _golden(hashes, valid, needles, t))
    q = Q - 5
    got = cm.count_below_mma(_t(needles[:q]), _t(hashes),
                             torch.from_numpy(valid.copy()), t).numpy()
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
    """count_gate takes the popcount K1 at t = 64 (every valid row
    counts); the +-1 form refuses thresholds outside 0..63."""
    hashes, valid, needles = data
    hs, vs, nd = _t(hashes), torch.from_numpy(valid.copy()), _t(needles)
    assert torch.equal(cm.count_gate(nd, hs, vs, 64),
                       torch.full((Q,), int(valid.sum()), dtype=torch.int32))
    assert torch.equal(cm.count_gate(nd, hs, vs, 5),
                       cb.count_below(nd, hs, vs, 5))
    for t in (-1, 64):
        with pytest.raises(ValueError, match="0..63"):
            cm.count_below_mma(nd, hs, vs, t)


def test_unpack_dot_identity(data):
    """dot(+-1(a), +-1(b)) = 64 - 2 * ham(a, b), in both operand types."""
    hashes, _, needles = data
    a, b = _t(needles[:64]), _t(hashes[:64])
    ham = np.bitwise_count(needles[:64, None] ^ hashes[None, :64]).astype(int)
    for dtype in (torch.float32, torch.bfloat16):
        dot = (cm.unpack_pm1(a, dtype).float()
               @ cm.unpack_pm1(b, dtype).float().T).numpy()
        assert np.array_equal(dot, 64 - 2 * ham)


def test_wrapper_has_no_fallback(monkeypatch):
    """A non-CPU tensor takes the kernel path: when the kernel cannot be
    built or loaded the call raises instead of returning the plain result."""
    def broken():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(cm, "_load", broken)
    h = torch.empty(16, dtype=torch.int64, device="meta")
    v = torch.empty(16, dtype=torch.bool, device="meta")
    before = cm.count_below_mma.launches, cm.count_below_mma.bf16_launches
    for bf16 in (False, True):
        with pytest.raises(RuntimeError, match="unavailable"):
            cm.count_below_mma(h[:4], h, v, 5, bf16=bf16)
    assert (cm.count_below_mma.launches,
            cm.count_below_mma.bf16_launches) == before


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
