"""Port parity of the last verbs: ``-verify``, ``-qualityscore``,
``-select-grid``, ``-serve`` (and ``-similar-to`` routed to it by
``CBIRD_SERVER``) and ``-browse``, through ``cbird_tpu_torch`` on the CPU
against ``cbird_tpu`` on the JAX CPU backend, and the copied numpy
modules (``ops/quality.py``, ``store/jpeg_quality.py``,
``ops/demosaic.py``) on seeded images.

One index (dct, built by the port) is copied for each package, so media
ids agree; paths are compared relative to each copy.  The browser's
template overlay runs the JAX ORB at FEW_LEVELS pyramid levels (patched
into both packages' ``N_LEVELS``).  Everything compared is exact but the
overlay's ROI, 1e-6 relative (a least-squares fit in float64 on the same
pairs, tests/test_torch_template_matcher.py).
"""

import contextlib
import copy
import io
import json
import os
import re
import shutil
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from cbird_tpu.cli import browser as jb
from cbird_tpu.cli import main as jax_cli
from cbird_tpu.cli import serve as js
from cbird_tpu.host.engine import Engine as JaxEngine
from cbird_tpu.ops import demosaic as jdm
from cbird_tpu.ops import hamming as jh
from cbird_tpu.ops import orb as jo
from cbird_tpu.ops import quality as jq
from cbird_tpu.params import IndexParams as JaxIndexParams
from cbird_tpu.params import SearchParams as JaxParams
from cbird_tpu.store import jpeg_quality as jjq
from cbird_tpu_torch.cli import browser as pb
from cbird_tpu_torch.cli import main as port_cli
from cbird_tpu_torch.cli import serve as ps
from cbird_tpu_torch.host.engine import Engine as PortEngine
from cbird_tpu_torch.ops import demosaic as pdm
from cbird_tpu_torch.ops import orb as po
from cbird_tpu_torch.ops import quality as pq
from cbird_tpu_torch.params import IndexParams as PortIndexParams
from cbird_tpu_torch.params import SearchParams as PortParams
from cbird_tpu_torch.store import jpeg_quality as pjq

from fixtures import synth_image

torch.set_num_threads(1)

FEW_LEVELS = 2


def textured(rng, h, w, n=60):
    """Blocks of random grey on a flat ground (tests/test_features.py)."""
    img = np.full((h, w), 60, np.uint8)
    for _ in range(n):
        y, x = rng.integers(0, h - 20), rng.integers(0, w - 20)
        hh, ww = rng.integers(8, 50), rng.integers(8, 50)
        img[y:y + hh, x:x + ww] = rng.integers(0, 255)
    return img


@pytest.fixture(scope="module", autouse=True)
def _setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBIRD_TORCH_DEVICE", "cpu")
        mp.setattr(jh, "_MESH", None)  # single-device reference
        mp.setattr(jo, "N_LEVELS", FEW_LEVELS)
        mp.setattr(po, "N_LEVELS", FEW_LEVELS)
        yield


def _cli(main, *args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(args))
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    """Two textured sources, each with a 0.75 rescale and a jpeg copy, and
    a photo-like image: a dct index built by the port, copied for each
    package.  @return (port dir, jax dir)"""
    top = tmp_path_factory.mktemp("verbs")
    d = str(top / "port")
    os.makedirs(d)
    rng = np.random.default_rng(8)
    for s in range(2):
        im = Image.fromarray(textured(rng, 320, 400))
        im.save(os.path.join(d, f"s{s}_src.png"))
        im.resize((300, 240), Image.BOX).save(os.path.join(d, f"s{s}_s75.png"))
        im.save(os.path.join(d, f"s{s}_q70.jpg"), quality=70)
    Image.fromarray(synth_image(rng, 200, 260)).save(
        os.path.join(d, "photo.png"))
    rc, _, err = _cli(port_cli.main, "-use", d, "-i.algos", "dct", "-create",
                      "-update")
    assert rc == 0, err
    j = str(top / "jax")
    shutil.copytree(d, j)
    return d, j


def _rel(text, root):
    return text.replace(root + os.sep, "")


# ---------------------------------------------------------------------------
# -verify, -qualityscore, -select-grid
# ---------------------------------------------------------------------------

def test_verify_equal(indexed, tmp_path):
    """A clean index, then one file changed and one gone: the same
    problems reported, the same exit code."""
    outs = []
    for root, main in zip(indexed, (port_cli.main, jax_cli.main)):
        d = str(tmp_path / os.path.basename(root))
        shutil.copytree(root, d)
        clean = _cli(main, "-use", d, "-verify")
        with open(os.path.join(d, "s0_src.png"), "ab") as f:
            f.write(b"junk")
        os.remove(os.path.join(d, "photo.png"))
        broken = _cli(main, "-use", d, "-verify")
        outs.append([(rc, _rel(o, d), _rel(e, d)) for rc, o, e in
                     (clean, broken)])
    assert outs[0] == outs[1]
    assert "verify: 0 problems in 7 items" in outs[0][0][2]
    assert "verify: 2 problems in 7 items" in outs[0][1][2]


def test_qualityscore_equal(indexed):
    """-select-all -qualityscore: the same scores and jpeg qualities."""
    got = [_cli(main, "-use", root, "-select-all", "-qualityscore")
           for root, main in zip(indexed, (port_cli.main, jax_cli.main))]
    assert got[0][0] == got[1][0] == 0
    assert _rel(got[0][1], indexed[0]) == _rel(got[1][1], indexed[1])
    assert len(got[0][1].splitlines()) == 7
    assert got[0][1].count("jpeg-quality=") == 2


def _collage(rng, gap):
    """A 2 x 3 sheet of synth cells with white gutters, or touching cells
    of alternating brightness (tests/test_demosaic.py)."""
    rows, cols, (ch, cw) = 2, 3, (120, 150)
    h, w = rows * ch + (rows + 1) * gap, cols * cw + (cols + 1) * gap
    img = np.full((h, w), 255, np.uint8)
    for r in range(rows):
        for c in range(cols):
            tile = synth_image(rng, ch, cw)
            if not gap:
                tile = np.clip(tile.astype(np.int16) // 2
                               + (140 if (r + c) % 2 else 10), 0, 255)
            y, x = gap + r * (ch + gap), gap + c * (cw + gap)
            img[y:y + ch, x:x + cw] = tile
    return img


@pytest.mark.parametrize("kind", ["gutters", "gapless", "photo"])
def test_select_grid_equal(kind, tmp_path):
    """-select-grid writes the same cells (bytes) and result."""
    rng = np.random.default_rng(3)
    img = (synth_image(rng, 240, 300) if kind == "photo"
           else _collage(rng, 12 if kind == "gutters" else 0))
    outs = []
    for name, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        p = str(d / "sheet.png")
        Image.fromarray(img).save(p)
        rc, out, err = _cli(main, "-select-grid", p, "-count")
        cells = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))
                 if "cell" in f}
        outs.append((rc, out, _rel(err, str(d)), cells))
    assert outs[0] == outs[1]
    assert len(outs[0][3]) == (0 if kind == "photo" else 6)


def _detailed(rng, h=240, w=300):
    """Photo-like: smooth structure and fine texture (tests/test_quality.py)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 120 + 60 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
    img += rng.normal(0, 18, size=(h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quality_and_demosaic_copies_equal(seed):
    """The copied numpy modules give the JAX package's results on seeded
    images: quality scores (gray, RGB, blurred, tiny), the DQT tables and
    jpeg quality estimates, and the demosaic steps."""
    rng = np.random.default_rng(seed)
    img = _detailed(rng)
    blurred = np.asarray(Image.fromarray(img).filter(
        ImageFilter.GaussianBlur(1 + seed)))
    rgb = np.stack([img, blurred, img[::-1]], axis=2)
    for x in (img, blurred, rgb, np.zeros((40, 40), np.uint8)):
        assert pq.quality_score(x) == jq.quality_score(x)
    for q in (30 + 20 * seed, 90):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=q)
        data = buf.getvalue()
        assert pjq.estimate_jpeg_quality(data) == \
            jjq.estimate_jpeg_quality(data)
        want = jjq.parse_dqt_tables(data)
        got = pjq.parse_dqt_tables(data)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)
    assert pjq.estimate_jpeg_quality(b"\x89PNG\r\n") is None
    for sheet in (_collage(rng, 12), _collage(rng, 0), img):
        assert pdm.gray_level(sheet, 1.0) == jdm.gray_level(sheet, 1.0)
        stretched = pdm.brightness_contrast_auto(sheet)
        assert np.array_equal(stretched, jdm.brightness_contrast_auto(sheet))
        assert pdm.find_solid_lines(sheet) == jdm.find_solid_lines(sheet)
        assert pdm.find_edge_lines(sheet) == jdm.find_edge_lines(sheet)
        assert pdm.demosaic_rects(stretched) == jdm.demosaic_rects(stretched)


# ---------------------------------------------------------------------------
# -serve and CBIRD_SERVER
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers(indexed):
    """The port's QueryServer and the JAX package's, each over its copy
    of the index, warmed up and serving in a background thread."""
    out = []
    for root, eng_cls, params, mod in (
            (indexed[0], PortEngine, PortIndexParams, ps),
            (indexed[1], JaxEngine, JaxIndexParams, js)):
        eng = eng_cls(root, params())
        srv = mod.QueryServer(eng)
        srv.warmup()
        srv.start_background()
        out.append((root, srv, mod))
    yield out
    for _, srv, _ in out:
        srv.close()
        srv.engine.db.close()


REQUESTS = [
    {"cmd": "ping"},
    {"cmd": "query", "path": "s0_src.png", "params": {"dht": "8"}},
    {"cmd": "query", "path": "s1_s75.png", "params": {}},
    {"cmd": "query", "path": "photo.png", "params": {"dht": "30"}},
    {"cmd": "query", "path": "s0_q70.jpg",
     "params": {"dht": "20", "refl": "0"}},
    {"cmd": "query", "path": ""},
    {"cmd": "nope"},
]


def _ask(root, srv, mod, req):
    c = mod.QueryClient(f"{srv.address[0]}:{srv.address[1]}")
    try:
        req = dict(req)
        if req.get("path"):
            req["path"] = os.path.join(root, req["path"])
        return json.loads(_rel(json.dumps(c.call(req)), root))
    finally:
        c.close()


def test_serve_answers_equal(servers):
    """Both servers answer every request alike: queries' groups (paths,
    scores, ids, md5s, sizes), errors, ping, and status counts."""
    for req in REQUESTS:
        got, want = [_ask(root, srv, mod, req) for root, srv, mod in servers]
        assert got == want, req
    got, want = [_ask(root, srv, mod, {"cmd": "status"})
                 for root, srv, mod in servers]
    assert (got["ok"], got["items"], got["queries"]) == \
        (want["ok"], want["items"], want["queries"]) == (True, 7, 4)


def test_serve_cli_routing_equal(servers, monkeypatch):
    """-similar-to under CBIRD_SERVER, from either package's CLI to the
    port's server, prints the in-process -similar-to's groups."""
    root, srv, _ = servers[0]
    needle = os.path.join(root, "s1_src.png")
    args = ["-use", root, "-p.dht", "8", "-similar-to", needle, "-dump"]
    rc, local, _ = _cli(port_cli.main, *args)
    assert rc == 0 and "s1_s75.png" in local
    monkeypatch.setenv("CBIRD_SERVER", f"{srv.address[0]}:{srv.address[1]}")
    before = srv._queries
    for main in (port_cli.main, jax_cli.main):
        rc, out, _ = _cli(main, *args)
        assert rc == 0 and out == local
    assert srv._queries == before + 2


# ---------------------------------------------------------------------------
# -browse
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


@pytest.fixture(scope="module")
def browsers(indexed):
    """Each package's browser over its own engine's -similar groups."""
    out = []
    for root, eng_cls, iparams, sparams, mod in (
            (indexed[0], PortEngine, PortIndexParams, PortParams, pb),
            (indexed[1], JaxEngine, JaxIndexParams, JaxParams, jb)):
        eng = eng_cls(root, iparams())
        groups = eng.db.similar(sparams())
        server, thread, url = mod.serve_browser(
            eng.db, groups, title="t", max_per_page=1, block=False,
            engine=eng)
        out.append((root, url, server.RequestHandlerClass.state))
    yield out
    for _, url, state in out:
        urllib.request.urlopen(urllib.request.Request(
            url + "api/quit", data=b"{}", method="POST",
            headers={"X-Cbird-Token": _token(url)}), timeout=10).read()
        state.engine.db.close()


def _token(url):
    _, body = _get(url)
    return re.search(rb'TOKEN="([0-9a-f]+)"', body).group(1).decode()


def test_browser_pages_equal(browsers):
    """The app page (but its session token), every page of groups, the
    thumbnails and the diff image are the JAX package's."""
    (proot, purl, _), (jroot, jurl, _) = browsers
    pages = []
    for root, url, _ in browsers:
        _, app = _get(url)
        app = re.sub(rb'TOKEN="[0-9a-f]+"', b"", app)
        _, first = _get(url + "api/groups?page=0")
        n = json.loads(first)["pages"]
        groups = [json.loads(_rel(_get(url + f"api/groups?page={p}")[1]
                                  .decode(), root)) for p in range(n)]
        ids = [m["id"] for g in groups for gg in g["groups"]
               for m in gg["items"]]
        thumbs = [_get(url + f"thumb/{i}")[1] for i in ids]
        diff = _get(url + f"diff?a={ids[0]}&b={ids[1]}")[1]
        pages.append((app, groups, thumbs, diff))
    assert pages[0] == pages[1]
    assert len(pages[0][1]) >= 2


def test_browser_overlay_equal(browsers):
    """/tmatch of a source and its rescale: the same JPEG from either
    package, and the matcher's ROI on the pair within 1e-6 relative; an
    unknown pair is a 404 in both."""
    out = []
    for root, url, state in browsers:
        media = {os.path.basename(m.path): m for g in state.groups
                 for m in g}
        a, b = media["s0_src.png"], media["s0_s75.png"]
        status, body = _get(url + f"tmatch?a={a.id}&b={b.id}")
        assert status == 200 and body[:2] == b"\xff\xd8"
        cand = copy.copy(b)
        group = [cand]
        params = (PortParams if state.__class__ is pb.BrowserState
                  else JaxParams)()
        state._tmatcher._cache.clear()  # the overlay's verdict is cached
        state._tmatcher.match(a, group, params)
        out.append((body, group and cand.roi, cand.score))
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url + "tmatch?a=999&b=1000")
        assert e.value.code == 404
    (pbody, proi, pscore), (jbody, jroi, jscore) = out
    assert pscore == jscore and pbody == jbody
    assert proi and np.allclose(proi, jroi, rtol=1e-6, atol=1e-9)
    assert isinstance(out[0][0], bytes)
    assert out[0][1] is not None
    assert type(browsers[0][2]._tmatcher).__module__ == \
        "cbird_tpu_torch.host.template_matcher"
    assert browsers[0][2]._tmatcher.device.type == "cpu"
