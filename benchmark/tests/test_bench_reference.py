"""The plain references against a brute force and against the port at
small sizes on the CPU, and their controls coming out wrong."""

import numpy as np
import pytest
import torch

from benchlib import data
from benchlib.manifest import part

dct = part("reference", "dct")
color = part("reference", "color")

CPU = torch.device("cpu")


def _store(n, pairs, seed):
    g = data.generator(seed, CPU)
    h = data.random_words(n, g, CPU)
    perm = torch.randperm(n, generator=g)
    h[perm[pairs:2 * pairs]] = h[perm[:pairs]] ^ data.flip_masks(
        pairs, 1, 4, g, CPU)
    valid = torch.ones(n, dtype=torch.bool)
    valid[perm[2 * pairs:2 * pairs + n // 100]] = False
    needles = h[perm[:pairs]] ^ data.flip_masks(pairs, 0, 4, g, CPU)
    return h, valid, needles


def _brute(h, valid, needles, t, k):
    hs = [int(x) & ((1 << 64) - 1) for x in h]
    out = []
    for q in needles.tolist():
        q &= (1 << 64) - 1
        hits = sorted((bin(q ^ x).count("1"), r) for r, x in enumerate(hs)
                      if valid[r] and bin(q ^ x).count("1") < t)[:k]
        if q == 0:
            hits = []
        out.append((np.array([r for _, r in hits], np.int64),
                    np.array([d for d, _ in hits], np.int64)))
    return out


def test_flip_masks_flip_the_asked_bits():
    g = data.generator(5, CPU)
    m = data.flip_masks(4000, 1, 4, g, CPU)
    counts = [bin(x & ((1 << 64) - 1)).count("1") for x in m.tolist()]
    assert set(counts) == {1, 2, 3, 4}


def test_near_rows_equals_a_brute_force():
    h, valid, needles = _store(3000, 60, 11)
    needles[3] = 0  # a media without a hash has no answer
    for t, k in ((5, 64), (3, 2), (9, 5)):
        got = dct.near_rows(dct.pm1_store(h), valid, needles, t, k, block=16)
        assert dct.wrong_lists(got, _brute(h, valid, needles, t, k)) == 0


def test_near_rows_equals_the_port():
    from cbird_tpu_torch.ops.hamming import PackedHashStore
    h, valid, needles = _store(20000, 300, 12)
    ids = np.arange(1, len(h) + 1, dtype=np.uint32)
    ids[~valid.numpy()] = 0
    store = PackedHashStore(h.numpy().view(np.uint64), ids, device="cpu")
    got = [(np.asarray(i, np.int64) - 1, np.asarray(d, np.int64))
           for i, d in store.search(needles.numpy().view(np.uint64), 5, 64)]
    want = dct.near_rows(dct.pm1_store(h), valid, needles, 5, 64)
    assert dct.wrong_lists(got, want) == 0
    assert sum(len(w[0]) > 0 for w in want) >= 250


def test_similar_rows_equals_the_port():
    from cbird_tpu_torch.ops.hamming import PackedHashStore
    h, valid, _ = _store(6000, 200, 13)
    ids = np.arange(1, len(h) + 1, dtype=np.uint32)
    ids[~valid.numpy()] = 0
    h[~valid] = 0
    store = PackedHashStore(h.numpy().view(np.uint64), ids, device="cpu")
    raw = store.search_self(5, k=64, sparse=True)
    got = {r: (np.asarray(i, np.int64) - 1, np.asarray(d, np.int64))
           for r, (i, d) in raw.items()}
    want = dct.similar_rows(dct.pm1_store(h), h, valid, np.arange(len(h)),
                            5, 64)
    assert sorted(got) == sorted(want)
    assert dct.wrong_lists([got[r] for r in want],
                           [want[r] for r in want]) == 0


def test_dct_control_loses_matches():
    h, valid, needles = _store(20000, 2000, 14)
    want = dct.near_rows(dct.pm1_store(h), valid, needles, 5, 64)
    assert dct.wrong_lists(dct.control(needles, h, want), want) > 0


def _color_store(n, q, seed):
    g = data.generator(seed, CPU)
    codes = torch.randint(0, 65536, (n, 32, 3), generator=g,
                          dtype=torch.int32)
    counts = torch.tensor([31, 30, 29, 28, 27])[torch.multinomial(
        torch.tensor([90.0, 4, 3, 2, 1]), n, replacement=True, generator=g)]
    src = torch.randint(0, n, (q,), generator=g)
    jit = torch.randint(-2, 3, (q, 32, 3), generator=g, dtype=torch.int32)
    return codes, counts, torch.clamp(codes[src] + jit, 0, 65535), \
        counts[src]


def test_color_reference_equals_the_port():
    from cbird_tpu_torch.ops.color import PackedColorStore
    codes, counts, ncodes, ncounts = _color_store(3000, 6, 21)

    def descs(c, n):
        d = np.zeros((len(c), 33, 4), np.uint16)
        d[:, :32, :3] = c.numpy()
        d[:, 32, 0] = n.numpy()
        return d

    store = PackedColorStore("cpu")
    store.add(descs(codes, counts), np.arange(1, 3001, dtype=np.uint32))
    res = store.search(list(descs(ncodes, ncounts)), k=64)
    got = [(np.asarray(i, np.int64) - 1, np.asarray(s).astype(np.int64))
           for i, s in res]
    sc = color.scores(color.dequantize(ncodes), ncounts,
                      color.dequantize(codes), counts,
                      torch.ones(3000, dtype=torch.bool))
    g = color.gaps(sc, got, 64)
    assert g["rank_gap"] < 1e-3 and g["score_err"] < 1e-3


def test_color_control_ranks_rows_out_of_order():
    codes, counts, ncodes, ncounts = _color_store(3000, 6, 22)
    args = (color.dequantize(ncodes), ncounts, color.dequantize(codes),
            counts, torch.ones(3000, dtype=torch.bool))
    sc = color.scores(*args)
    low = color.scores(*args, dtype=torch.bfloat16)
    got = [(r, np.floor(s).astype(np.int64)) for r, s in color.best(low, 64)]
    assert color.gaps(sc, got, 64)["rank_gap"] > 0.1


def test_color_gaps_catch_a_missing_and_an_altered_answer():
    codes, counts, ncodes, ncounts = _color_store(2000, 3, 23)
    sc = color.scores(color.dequantize(ncodes), ncounts,
                      color.dequantize(codes), counts,
                      torch.ones(2000, dtype=torch.bool))
    good = [(r, np.floor(s).astype(np.int64)) for r, s in color.best(sc, 64)]
    assert color.gaps(sc, good, 64) == {"rank_gap": 0.0, "score_err": 0.0}
    short = [(r[:-1], s[:-1]) for r, s in good]
    assert color.gaps(sc, short, 64)["rank_gap"] == float("inf")
    bumped = [(r, s + (np.arange(len(s)) == 5)) for r, s in good]
    assert color.gaps(sc, bumped, 64)["score_err"] > 0


@pytest.mark.parametrize("bad", ["wrong_row", "wrong_distance", "missing"])
def test_wrong_lists_counts_each_differing_answer(bad):
    want = [(np.array([3, 9]), np.array([0, 2])), (np.array([4]),
                                                   np.array([1]))]
    got = [(w[0].copy(), w[1].copy()) for w in want]
    if bad == "wrong_row":
        got[0][0][1] = 8
    elif bad == "wrong_distance":
        got[1][1][0] = 2
    else:
        got[0] = (got[0][0][:1], got[0][1][:1])
    assert dct.wrong_lists(got, want) == 1
