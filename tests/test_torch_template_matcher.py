"""Port parity of the template matcher (`-p.tm`) and the numpy hashes:
``cbird_tpu_torch.host.template_matcher`` on the CPU against
``cbird_tpu.host.template_matcher`` on the JAX CPU backend, on the same
seeded images.

The JAX ORB runs at FEW_LEVELS pyramid levels (patched into both
packages' ``N_LEVELS``, as tests/test_torch_orb.py does) and every JAX
ORB call is padded to a batch of JAX_BATCH images, so that one worker
compiles the two level programs once a feature count; the tests keep
every group at JAX_BATCH candidates or fewer.  Padding changes no
result: the pyramid runs each image of a batch on its own.

Tolerances, and why:
- the RANSAC and similarity helpers, the mutual match, keypoint
  coordinates and descriptors, survivors, integer scores and hashes:
  exact (the same numpy code on the same inputs; ORB's keypoints and
  descriptors are exact at these levels, tests/test_torch_orb.py);
- ``roi`` and ``transform``: 1e-6 relative (a least-squares solve and
  the scale factor in float64 on the same pairs; the CLI prints the ROI
  rounded to 0.1 px).
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from cbird_tpu.cli import main as jax_cli
from cbird_tpu.host import template_matcher as jtm
from cbird_tpu.ops import hamming as jh
from cbird_tpu.ops import orb as jo
from cbird_tpu.ops import ref_numpy as jref
from cbird_tpu.params import SearchParams as JaxParams
from cbird_tpu.store.ioutil import full_md5_file
from cbird_tpu.store.media import Media as JaxMedia
from cbird_tpu_torch.cli import main as port_cli
from cbird_tpu_torch.host import template_matcher as ptm
from cbird_tpu_torch.ops import dct_hash as pdh
from cbird_tpu_torch.ops import orb as po
from cbird_tpu_torch.ops import ref_numpy as pref
from cbird_tpu_torch.params import SearchParams as PortParams
from cbird_tpu_torch.store.media import Media as PortMedia

torch.set_num_threads(1)

FEW_LEVELS = 2
JAX_BATCH = 4
NFEAT = 400


def textured(rng, h, w, n=40):
    """Blocks of random grey on a flat ground (tests/test_features.py)."""
    img = np.full((h, w), 60, np.uint8)
    for _ in range(n):
        y, x = rng.integers(0, h - 20), rng.integers(0, w - 20)
        hh, ww = rng.integers(8, 50), rng.integers(8, 50)
        img[y:y + hh, x:x + ww] = rng.integers(0, 255)
    return img


_JAX_ORB = jo._orb_kernel


def _padded_orb(canvas, sizes, nfeatures):
    """The JAX ORB at a batch of JAX_BATCH (the level programs' one shape)."""
    b = canvas.shape[0]
    assert b <= JAX_BATCH, b
    c = jnp.zeros((JAX_BATCH,) + canvas.shape[1:], canvas.dtype)
    s = jnp.ones((JAX_BATCH, 2), sizes.dtype)
    res = _JAX_ORB(c.at[:b].set(canvas), s.at[:b].set(sizes), nfeatures)
    return {k: v[:b] for k, v in res.items()}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("CBIRD_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(jh, "_MESH", None)  # single-device reference
    monkeypatch.setattr(jo, "N_LEVELS", FEW_LEVELS)
    monkeypatch.setattr(po, "N_LEVELS", FEW_LEVELS)
    monkeypatch.setattr(jo, "_orb_kernel", _padded_orb)


# ---------------------------------------------------------------------------
# the numpy helpers
# ---------------------------------------------------------------------------

def _ransac_case(kind):
    """Point sets of tests/test_template_matcher.py's RANSAC models."""
    if kind == "translation":
        rng = np.random.default_rng(0)
        p = rng.uniform(0, 300, size=(20, 2))
        return p, p + np.array([13.0, -7.0])
    if kind == "outliers":
        rng = np.random.default_rng(1)
        p = rng.uniform(0, 300, size=(30, 2))
        th = 0.1
        rot = np.array([[np.cos(th), -np.sin(th)],
                        [np.sin(th), np.cos(th)]]) * 1.2
        q = p @ rot.T + np.array([5.0, 9.0])
        q[::4] += rng.uniform(40, 90, size=(len(q[::4]), 2))
        return p, q
    rng = np.random.default_rng(2)
    return (rng.uniform(0, 300, size=(20, 2)),
            rng.uniform(0, 300, size=(20, 2)))


@pytest.mark.parametrize("kind", ["translation", "outliers", "garbage"])
def test_ransac_helpers_equal(kind):
    p, q = _ransac_case(kind)
    want = jtm.estimate_similarity_ransac(p, q)
    got = ptm.estimate_similarity_ransac(p, q)
    assert (want is None) == (got is None)
    if want is not None:
        assert np.array_equal(got, want)
        assert np.array_equal(ptm._apply(got, p), jtm._apply(want, p))
    assert np.array_equal(ptm._similarity_from_2pts(p[:2], q[:2]),
                          jtm._similarity_from_2pts(p[:2], q[:2]))
    assert np.array_equal(ptm._ls_similarity(p, q), jtm._ls_similarity(p, q))


def _flip(row, n, rng):
    """A copy of one [32] uint8 descriptor with exactly min(n, 256) bits
    flipped."""
    bits = np.unpackbits(row)
    at = rng.choice(256, size=min(n, 256), replace=False)
    bits[at] ^= 1
    return np.packbits(bits)


def _planted(radius, rng):
    """A template's descriptors and three candidates' around them: rows at
    radius - 1, radius and radius + 1 of a template row, two candidate
    rows tied at one distance from a template row, two template rows tied
    at one distance from a candidate row, random rows, an empty
    candidate."""
    a = rng.integers(0, 256, size=(12, 32), dtype=np.uint8)
    a[11] = _flip(a[10], 6, rng)  # a[10], a[11] tie on c0's row 7 below
    c0 = [_flip(a[0], max(radius - 1, 0), rng), _flip(a[1], radius, rng),
          _flip(a[2], radius + 1, rng), _flip(a[3], 3, rng),
          _flip(a[3], 3, rng),  # tied rows 3, 4: the lower wins
          *rng.integers(0, 256, size=(2, 32), dtype=np.uint8)]
    # a row at 3 bits from both a[10] and a[11] (which differ in 6)
    bits10, bits11 = np.unpackbits(a[10]), np.unpackbits(a[11])
    diff = np.nonzero(bits10 != bits11)[0]
    mid = bits10.copy()
    mid[diff[:3]] ^= 1
    c0.append(np.packbits(mid))
    c1 = np.concatenate([a[5:9], rng.integers(0, 256, size=(6, 32),
                                               dtype=np.uint8)])
    c2 = np.zeros((0, 32), np.uint8)
    return a, [np.stack(c0), c1, c2]


def _lanes(d: np.ndarray) -> torch.Tensor:
    """[K, 32] uint8 -> the port's [K, 4] int64 (the same bytes)."""
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int64).copy())


@pytest.mark.parametrize("radius", [0, 1, 4, 25, 64, 256])
def test_mutual_match_equal(radius):
    """K5's plain twin at k = 1, bounded at the radius, in both directions
    gives the JAX package's pair lists on planted ties and radius edges."""
    rng = np.random.default_rng(100 + radius)
    a, cands = _planted(radius, rng)
    got = ptm.mutual_matches(_lanes(a), [_lanes(c) for c in cands], radius)
    for c, pairs in zip(cands, got):
        want = jtm._mutual_radius_match(a, c, radius)
        assert pairs == want
        assert ptm._mutual_radius_match(a, c, radius) == want
    if radius == 25:
        assert (0, 0) in got[0] and (1, 1) not in got[0]
        assert (3, 3) in got[0] and (3, 4) not in got[0]
        assert (10, 7) in got[0] and (11, 7) not in got[0]
        assert got[2] == []
    assert ptm.mutual_matches(_lanes(a[:0]), [_lanes(cands[0])], radius) \
        == [[]]


@pytest.fixture(scope="module")
def grays():
    rng = np.random.default_rng(77)
    return [textured(rng, 320, 400), textured(rng, 600, 480),
            textured(rng, 300, 300)]


def test_features_batch_equal(grays):
    """The same BOX prescale, canvas and sizes: equal keypoints (divided
    by the prescale) and descriptor bytes; the port's stay on its device
    as [K, 4] int64."""
    want = jtm.TemplateMatcher(decode=lambda p: None)._features_batch(
        grays, NFEAT)
    got = ptm.TemplateMatcher(decode=lambda p: None,
                              device="cpu")._features_batch(grays, NFEAT)
    for (wx, wy, wd), (gx, gy, gd) in zip(want, got):
        assert gd.dtype == torch.int64 and gd.shape == (len(wd), 4)
        assert len(wd) > 50
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
        assert np.array_equal(gd.numpy().view(np.uint8).reshape(-1, 32), wd)


# ---------------------------------------------------------------------------
# TemplateMatcher.match
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tm_root(tmp_path_factory):
    """tests/test_template_matcher.py's images, a crop of orig.png and its
    2x rescale (big.png) for -p.tscale."""
    rng = np.random.default_rng(42)
    root = str(tmp_path_factory.mktemp("tm"))
    img = textured(rng, 320, 400)
    other = textured(rng, 320, 400)
    Image.fromarray(img).save(os.path.join(root, "orig.png"))
    canvas = np.full((400, 480), 30, np.uint8)
    canvas[50:370, 60:460] = img
    Image.fromarray(canvas).save(os.path.join(root, "shifted.png"))
    Image.fromarray(other).save(os.path.join(root, "other.png"))
    small = img[60:220, 80:280]
    Image.fromarray(small).save(os.path.join(root, "small.png"))
    Image.fromarray(small).resize((400, 320), Image.BILINEAR).save(
        os.path.join(root, "big.png"))
    return root


def _media(cls, root, name):
    p = os.path.join(root, name)
    with Image.open(p) as im:
        w, h = im.size
    return cls(p, cls.TypeImage, w, h, full_md5_file(p), 0)


def _params(cls, **kw):
    p = cls()
    p.needleFeatures = NFEAT
    p.haystackFeatures = NFEAT
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _close(a, b):
    if a is None or b is None:  # a cached verdict carries no roi
        return a is None and b is None
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.allclose(a, b, rtol=1e-6, atol=1e-9)


def _run_case(matcher, cls, params, root, tmpl, names, repeat=1):
    """match() of the template against a group of ``names``, ``repeat``
    times on one matcher.  @return per run: [(name, score, roi,
    transform)] of the survivors, and every candidate's score"""
    runs = []
    for _ in range(repeat):
        group = [_media(cls, root, n) for n in names]
        cands = list(group)
        matcher.match(_media(cls, root, tmpl), group, params)
        runs.append(([(os.path.basename(m.path), m.score, m.roi, m.transform)
                      for m in group], [m.score for m in cands]))
    return runs


CASES = {
    "shifted": ("orig.png", ["shifted.png", "other.png"], {}, 1),
    "batched": ("orig.png", ["shifted.png", "other.png", "shifted.png"], {},
                1),
    "cache": ("orig.png", ["shifted.png"], {}, 2),
    # -p.tscale 100 shrinks both candidates to the crop's size: the 2x
    # rescale verifies; at 200, orig.png keeps the crop's scale and verifies
    "tscale100": ("small.png", ["orig.png", "big.png"], {"tmScalePct": 100},
                  1),
    "tscale200": ("small.png", ["orig.png", "big.png"], {"tmScalePct": 200},
                  1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_match_equal(case, tm_root):
    """Equal survivors and integer scores; roi and transform within 1e-6
    relative.  In the batched case the group goes through one feature
    pass; in the cache case the second run decodes nothing."""
    tmpl, names, kw, repeat = CASES[case]
    jm = jtm.TemplateMatcher()
    pm = ptm.TemplateMatcher(device="cpu")
    calls = []
    feats = pm._features_batch

    def counting(grays, nf):
        calls.append(len(grays))
        return feats(grays, nf)
    pm._features_batch = counting
    want = _run_case(jm, JaxMedia, _params(JaxParams, **kw), tm_root, tmpl,
                     names, repeat)
    got = _run_case(pm, PortMedia, _params(PortParams, **kw), tm_root,
                    tmpl, names, repeat)
    assert calls == [1, len(names)]  # a template pass, one group pass
    for (ws, wscores), (gs, gscores) in zip(want, got):
        assert gscores == wscores
        assert [(n, s) for n, s, _, _ in gs] == [(n, s) for n, s, _, _ in ws]
        for (_, _, wr, wt), (_, _, gr, gt) in zip(ws, gs):
            assert _close(gr, wr) and _close(gt, wt)
    survivors = [n for n, *_ in got[0][0]]
    if case in ("shifted", "batched", "cache"):
        assert set(survivors) == {"shifted.png"}
    if case.startswith("tscale"):
        want_s = ["big.png"] if case == "tscale100" else ["orig.png"]
        assert survivors == want_s
        side = 2 * kw["tmScalePct"]  # the crop's 200 px x the knob
        assert pm._tscale(np.zeros((160, 200), np.uint8),
                          np.zeros((640, 800), np.uint8),
                          _params(PortParams, **kw)).shape[1] == side


# ---------------------------------------------------------------------------
# -p.tm 1 -similar through both CLIs
# ---------------------------------------------------------------------------

def _run(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(args))
    assert rc == 0, args
    return buf.getvalue()


def _tm_groups(out):
    """-json -> [(needle, [(match, score, roi, transform)])] by file name."""
    name = lambda m: os.path.basename(m["path"])
    return [(name(g["needle"]),
             [(name(m), m["score"], m.get("roi"), m.get("transform"))
              for m in g["matches"]]) for g in json.loads(out)]


def test_cli_tm_similar_equal(tmp_path):
    """Two textured sources with a 0.75 rescale each and a distractor; a
    dct threshold wide enough that unrelated pairs are candidates too:
    -p.tm 1 -similar keeps the rescales only, with the JAX CLI's groups,
    scores, ROIs and transforms."""
    rng = np.random.default_rng(5)
    src = tmp_path / "port"
    src.mkdir()
    for s in range(2):
        im = Image.fromarray(textured(rng, 320, 400, n=60))
        im.save(src / f"s{s}_src.png")
        im.resize((300, 240), Image.BOX).save(src / f"s{s}_s75.png")
    Image.fromarray(textured(rng, 320, 400, n=60)).save(src / "x_other.png")
    jd = str(tmp_path / "jax")
    shutil.copytree(src, jd)
    pd = str(src)
    args = ["-p.dht", "40", "-p.tm", "1", "-p.tnf", str(NFEAT),
            "-p.thf", str(NFEAT), "-similar", "-json"]
    _run(port_cli.main, "-use", pd, "-i.algos", "dct", "-create", "-update")
    _run(port_cli.main, "-use", jd, "-i.algos", "dct", "-create", "-update")
    got = _tm_groups(_run(port_cli.main, "-use", pd, *args))
    want = _tm_groups(_run(jax_cli.main, "-use", jd, *args))
    assert [(n, [(m, s, r) for m, s, r, _ in ms]) for n, ms in got] \
        == [(n, [(m, s, r) for m, s, r, _ in ms]) for n, ms in want]
    for (_, gm), (_, wm) in zip(got, want):
        for g, w in zip(gm, wm):
            assert _close(g[3], w[3])
    joined = {frozenset([n] + [m for m, *_ in ms]) for n, ms in got}
    assert joined == {frozenset({"s0_src.png", "s0_s75.png"}),
                      frozenset({"s1_src.png", "s1_s75.png"})}
    plain = _tm_groups(_run(port_cli.main, "-use", pd, "-p.dht", "40",
                            "-similar", "-json"))
    assert sum(len(ms) for _, ms in plain) > sum(len(ms) for _, ms in got)


# ---------------------------------------------------------------------------
# the numpy hashes and average_hash_batch
# ---------------------------------------------------------------------------

def test_hashes_equal(images):
    """dct_hash64 and average_hash64 (the copies) and average_hash_batch
    (float64, plain PyTorch) give the JAX package's golden bits."""
    rng = np.random.default_rng(9)
    imgs = list(images) + [textured(rng, int(rng.integers(40, 300)),
                                    int(rng.integers(40, 300)))
                           for _ in range(8)]
    canvas, sizes = pdh.pack_canvas(imgs, 512, 512)
    batch = pdh.average_hash_batch(torch.from_numpy(canvas),
                                   torch.from_numpy(sizes))
    batch = batch.numpy().view(np.uint64)
    for img, ah in zip(imgs, batch):
        assert pref.dct_hash64(img) == jref.dct_hash64(img)
        want = jref.average_hash64(img)
        assert pref.average_hash64(img) == want
        assert int(ah) == want


def test_match_groups_equal_sequential(tm_root):
    """match_groups gives each group the verdicts of one match a group in
    the same order (the md5-pair cache in either order, a template that
    cannot be decoded, a group without md5s), with two ORB passes a
    window of groups."""
    names = ["orig.png", "shifted.png", "other.png", "small.png", "big.png"]

    def groups():
        m = {n: _media(PortMedia, tm_root, n) for n in names}
        gone = PortMedia(os.path.join(tm_root, "gone.png"), PortMedia.TypeImage,
                         10, 10, "00", 0)
        nomd5 = _media(PortMedia, tm_root, "shifted.png")
        nomd5.md5 = ""
        return [(m["orig.png"], [m["shifted.png"], m["other.png"]]),
                (_media(PortMedia, tm_root, "shifted.png"),
                 [_media(PortMedia, tm_root, "orig.png"),
                  _media(PortMedia, tm_root, "big.png")]),
                (gone, [_media(PortMedia, tm_root, "orig.png")]),
                (m["small.png"], [_media(PortMedia, tm_root, "orig.png"),
                                  m["big.png"]]),
                (_media(PortMedia, tm_root, "orig.png"), [nomd5])]

    def verdicts(pairs):
        return [[(os.path.basename(m.path), m.score, m.roi, m.transform)
                 for m in g] for _, g in pairs]

    def decode(path):
        from cbird_tpu_torch.host.scanner import Scanner
        return Scanner(device="cpu").decode_image(path)
    params = _params(PortParams)
    one = ptm.TemplateMatcher(decode=decode, device="cpu")
    want = groups()
    for tmpl, g in want:
        one.match(tmpl, g, params)
    many = ptm.TemplateMatcher(decode=decode, device="cpu")
    calls = []
    feats = many._features_batch

    def counting(grays, nf):
        calls.append(len(grays))
        return feats(grays, nf)
    many._features_batch = counting
    got = groups()
    many.match_groups(got, params)
    assert verdicts(got) == verdicts(want)
    assert many._cache == one._cache
    assert len(calls) == 2 and not many._feats
