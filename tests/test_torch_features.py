"""Port parity of the two feature indexes: the same seeded keypoint hashes
and descriptors, with planted near copies, go into ``cbird_tpu``'s and
``cbird_tpu_torch``'s ``DctFeaturesIndex`` (fdct) and ``CvFeaturesIndex``
(orb); their match lists must be equal (``find_batch``, ``find_all``, the
maxThresh escalation, the ``-p.ovg`` gate, remove and re-add), and each
package reads the SQL rows and the sidecar cache the other wrote.
"""

import os
import sqlite3

import numpy as np
import pytest
import torch

from cbird_tpu.index.cv_features_index import CvFeaturesIndex as JaxCv
from cbird_tpu.index.dct_features_index import DctFeaturesIndex as JaxDct
from cbird_tpu.ops import hamming as jh
from cbird_tpu.params import SearchParams as JaxParams
from cbird_tpu.store.media import Media as JaxMedia
from cbird_tpu_torch.index.cv_features_index import CvFeaturesIndex
from cbird_tpu_torch.index.dct_features_index import DctFeaturesIndex
from cbird_tpu_torch.params import SearchParams
from cbird_tpu_torch.store.media import Media

torch.set_num_threads(1)

IMAGES, GROUP = 30, 3  # 10 groups of three near copies


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CBIRD_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(jh, "_MESH", None)  # single-device reference


def flip(x: np.ndarray, bits: int, rng) -> np.ndarray:
    """Each row of a uint8 [.., n] array with ``bits`` random bits flipped."""
    out = x.copy()
    flat = out.reshape(len(out), -1)
    for r in range(len(flat)):
        for b in rng.choice(flat.shape[1] * 8, size=bits, replace=False):
            flat[r, b // 8] ^= np.uint8(1 << (b % 8))
    return out


def feature_sets(seed: int = 11):
    """Per image id: (keypoint hashes [K] uint64, descriptors [K, 32]
    uint8).  Within a group, each copy shares a random half of the first
    image's keypoints with 0-2 bits flipped (hashes) or 0-20 (descriptors);
    every image has its own random keypoints besides."""
    rng = np.random.default_rng(seed)
    out = {}
    for g in range(IMAGES // GROUP):
        base_h = rng.integers(1, 2**63, size=20, dtype=np.int64) \
            .astype(np.uint64)
        base_d = rng.integers(0, 256, size=(20, 32), dtype=np.uint8)
        for c in range(GROUP):
            mid = g * GROUP + c + 1
            own_h = rng.integers(1, 2**63, size=15, dtype=np.int64) \
                .astype(np.uint64)
            own_d = rng.integers(0, 256, size=(15, 32), dtype=np.uint8)
            if c == 0:
                h, d = base_h, base_d
            else:
                pick = rng.choice(20, size=10, replace=False)
                h = flip(base_h[pick].view(np.uint8).reshape(10, 8),
                         int(rng.integers(0, 3)), rng).view(np.uint64)[:, 0]
                d = flip(base_d[pick], int(rng.integers(0, 21)), rng)
            out[mid] = (np.concatenate([h, own_h]), np.concatenate([d, own_d]))
    return out


def media(cls, mid, feats, hashes=True, descs=True):
    m = cls(f"/img/{mid}.png", id=mid)
    if hashes:
        m.keyPointHashes = feats[mid][0]
    if descs:
        m.keyPointDescriptors = feats[mid][1]
    return m


def matches(lists):
    return [[(m.mediaId, m.score) for m in ms] for ms in lists]


def build(feats, jax_cls, port_cls):
    j, p = jax_cls(), port_cls("cpu")
    j.add([media(JaxMedia, i, feats) for i in feats])
    p.add([media(Media, i, feats) for i in feats])
    return j, p


def params(cls, **kw):
    out = cls()
    for k, v in kw.items():
        setattr(out, k, v)
    return out


@pytest.mark.parametrize("kind", ["fdct", "orb"])
def test_find_batch_equal(kind):
    feats = feature_sets()
    jc, pc = (JaxDct, DctFeaturesIndex) if kind == "fdct" else \
        (JaxCv, CvFeaturesIndex)
    j, p = build(feats, jc, pc)
    ids = sorted(feats)
    for kw in ({}, {"dctThresh": 3, "cvThresh": 40}, {"cvGate": 0},
               {"cvGate": 2}):
        jp, pp = params(JaxParams, **kw), params(SearchParams, **kw)
        want = matches(j.find_batch([media(JaxMedia, i, feats)
                                     for i in ids], jp))
        got = matches(p.find_batch([media(Media, i, feats) for i in ids], pp))
        assert got == want, kw
        # stored needles by id alone (their features read from the store)
        assert matches(p.find_batch([Media(id=i) for i in ids], pp)) == want
    found = sum(any(i != m[0] and (m[0] - 1) // GROUP == (i - 1) // GROUP
                    for m in ms) for i, ms in zip(ids, want))
    assert found >= IMAGES * 2 // 3


def test_fdct_find_all_and_escalation():
    feats = feature_sets()
    j, p = build(feats, JaxDct, DctFeaturesIndex)
    for kw in ({}, {"maxThresh": 8, "minMatches": 2}):
        jp, pp = params(JaxParams, **kw), params(SearchParams, **kw)
        wi, wl = j.find_all(jp)
        gi, gl = p.find_all(pp)
        assert np.array_equal(wi, gi)
        assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(wl, gl)) and len(wl) == len(gl)


@pytest.mark.parametrize("kind", ["fdct", "orb"])
def test_remove_and_readd(kind):
    """Remove a third of the images, search, add them back, search: each
    result equals the JAX package's at the same step."""
    feats = feature_sets(seed=12)
    jc, pc = (JaxDct, DctFeaturesIndex) if kind == "fdct" else \
        (JaxCv, CvFeaturesIndex)
    j, p = build(feats, jc, pc)
    ids = sorted(feats)
    gone = ids[::3]
    j.remove(gone)
    p.remove(gone)
    jp, pp = JaxParams(), SearchParams()
    for step in range(2):
        want = matches(j.find_batch([media(JaxMedia, i, feats)
                                     for i in ids], jp))
        assert matches(p.find_batch([media(Media, i, feats)
                                     for i in ids], pp)) == want
        j.add([media(JaxMedia, i, feats) for i in gone])
        p.add([media(Media, i, feats) for i in gone])
    assert p.count() == j.count() == IMAGES


@pytest.mark.parametrize("kind", ["fdct", "orb"])
def test_sql_and_cache_cross_read(kind, tmp_path):
    """Rows one package writes load in the other, from SQL and from the
    sidecar cache, and search the same."""
    feats = feature_sets(seed=13)
    jc, pc = (JaxDct, DctFeaturesIndex) if kind == "fdct" else \
        (JaxCv, CvFeaturesIndex)
    ids = sorted(feats)
    for writer, reader in ((jc(), pc("cpu")), (pc("cpu"), jc())):
        db = str(tmp_path / f"{type(writer).__module__}.db")
        cache = str(tmp_path / f"cache-{type(writer).__module__}")
        os.makedirs(cache)
        conn = sqlite3.connect(db)
        mcls = JaxMedia if isinstance(writer, (JaxDct, JaxCv)) else Media
        writer.create_tables(conn)
        writer.add_records(conn, [media(mcls, i, feats) for i in ids])
        conn.commit()
        results = []
        for first in (True, False):  # from SQL (writes the cache), cache
            idx = type(reader)() if isinstance(reader, (JaxDct, JaxCv)) \
                else type(reader)("cpu")
            idx.load(conn, cache, "")
            assert idx.count() == IMAGES
            rcls = JaxMedia if isinstance(idx, (JaxDct, JaxCv)) else Media
            pcls = JaxParams if isinstance(idx, (JaxDct, JaxCv)) \
                else SearchParams
            results.append(matches(idx.find_batch(
                [rcls(id=i) for i in ids], pcls())))
            if first:
                assert os.listdir(cache)
        assert results[0] == results[1]
        writer.load(conn, cache, "")  # the cache the reader wrote
        wcls = JaxParams if mcls is JaxMedia else SearchParams
        assert matches(writer.find_batch([mcls(id=i) for i in ids],
                                         wcls())) == results[0]
        conn.close()


def test_self_search_mirrors_by_row():
    """A feature store repeats a media id on every keypoint row of its
    image.  The self-search's mirror (the path of stores over 65536 rows,
    forced here with min_n=0) completes each row's list by store row, so
    every row with a hit besides itself gets the list of a brute force
    over (distance, row), as the JAX package's plain search gives it; the
    JAX package's own mirror maps a hit's id back to one row of that id
    and loses or misplaces such hits (ROADMAP queue 3)."""
    from cbird_tpu_torch.ops.hamming import PackedHashStore
    feats = feature_sets(seed=14)
    hashes = np.concatenate([feats[i][0] for i in sorted(feats)])
    ids = np.concatenate([np.full(len(feats[i][0]), i, np.uint32)
                          for i in sorted(feats)])
    got = PackedHashStore(hashes, ids, device="cpu").search_self(
        5, k=30, sparse=True, min_n=0)
    d = np.bitwise_count(hashes[:, None] ^ hashes[None, :]).astype(np.int32)
    want = {}
    for r in range(len(hashes)):
        hits = np.nonzero(d[r] < 5)[0]  # ascending rows
        if len(hits) > 1:
            o = np.argsort(d[r, hits], kind="stable")[:30]
            want[r] = (ids[hits[o]], d[r, hits[o]])
    assert len(want) > 50 and set(got) == set(want)
    jax_plain = jh.PackedHashStore(hashes, ids).search(hashes, 5, k=30,
                                                       min_hits=2)
    for r, (w_ids, w_d) in want.items():
        assert np.array_equal(got[r][0], w_ids), r
        assert np.array_equal(got[r][1], w_d), r
        assert np.array_equal(jax_plain[r][0], w_ids), r
        assert np.array_equal(jax_plain[r][1], w_d), r
