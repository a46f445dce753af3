"""Port parity for the video slice (``-p.alg video``): cbird_tpu_torch on the
CPU (``CBIRD_TORCH_DEVICE=cpu``) against the JAX package on the same inputs.

- host: window compression, ``make_video_index`` on ``.fseq`` frames,
  parallel ingest, the longest-job-first queue;
- store: ``PackedVideoStore`` counts, hits, dense minima and per-video
  minima on one numpy store;
- index: ``DctVideoIndex.find_batch`` on the all-pairs path and on the
  flat count gate, as JAX's ``Match`` lists;
- the slice: the CLI ``-create -update -p.alg video -similar -json`` on a
  small ``.fseq`` corpus gives the same groups and the same ``.vdx`` bytes
  in both packages, each ``_index/`` opens in the other, and the video
  verbs run in a subprocess with neither ``jax`` nor ``cbird_tpu`` loaded.

Counts, minima, ``.vdx`` contents and matches are exact: the CPU hashes of
the two packages agree bit for bit.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from cbird_tpu.cli import main as jax_cli
from cbird_tpu.host import video as jv
from cbird_tpu.index.dct_video_index import DctVideoIndex as JaxVideoIndex
from cbird_tpu.ops import hamming as jh
from cbird_tpu_torch.cli import main as port_cli
from cbird_tpu_torch.host import video as pv
from cbird_tpu_torch.host.scanner import Scanner
from cbird_tpu_torch.index.dct_video_index import DctVideoIndex
from cbird_tpu_torch.ops import video_search as vs
from cbird_tpu_torch.params import IndexParams, SearchParams, TYPE_VIDEO
from cbird_tpu_torch.store.media import Media, VideoIndexData

from test_video import make_frames

torch.set_num_threads(1)

# short clips: trim, minimum frames matched and adjacency suited to them
VIDEO_ARGS = ["-p.alg", "video", "-p.vtrim", "5", "-p.vfm", "10",
              "-p.vfn", "40", "-i.algos", "video"]


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBIRD_TORCH_DEVICE", "cpu")
        mp.setattr(jh, "_MESH", None)  # single-device reference
        yield


def _save(path, frames):
    pv.FseqBackend.save(path, frames, 25.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three sources, each with a copy: a re-cut clip, a 2x upscale, a
    brightness shift."""
    root = tmp_path_factory.mktemp("video")
    src = root / "src"
    src.mkdir()
    a = make_frames(90, seed=7)
    b = make_frames(90, seed=8, phase=3.3)
    c = make_frames(90, seed=9, phase=1.1)
    _save(str(src / "a.fseq"), a)
    _save(str(src / "a_clip.fseq"), a[20:80].copy())
    _save(str(src / "b.fseq"), b)
    _save(str(src / "b_2x.fseq"), b.repeat(2, axis=1).repeat(2, axis=2))
    _save(str(src / "c.fseq"), c)
    _save(str(src / "c_bright.fseq"),
          np.clip(c.astype(int) + 25, 0, 255).astype(np.uint8))
    return str(root), str(src), c


def _copy(corpus, name):
    root, src, _ = corpus
    dst = os.path.join(root, name)
    if not os.path.exists(dst):
        shutil.copytree(src, dst)
    return dst


def _run(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(args))
    assert rc == 0, args
    return buf.getvalue()


def _groups(out: str, root: str):
    """-json output -> {(needle, ((match, score, range), ...))}, relative."""
    groups = set()
    for g in json.loads(out):
        groups.add((os.path.relpath(g["needle"]["path"], root),
                    tuple((os.path.relpath(m["path"], root), m.get("score"),
                           tuple(m.get("range", ()))) for m in g["matches"])))
    return groups


def _vdx(d):
    """{relative path: .vdx bytes} of an index directory."""
    from cbird_tpu_torch.store.database import Database
    db = Database(d)
    out = {}
    for m in db.all_media():
        with open(os.path.join(db.video_path(), f"{m.id}.vdx"), "rb") as f:
            out[os.path.relpath(m.path, d)] = f.read()
    db.close()
    return out


@pytest.fixture(scope="module")
def indexes(corpus):
    """The JAX package's and the port's index of the corpus, each with its
    -similar groups."""
    out = {}
    for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        d = _copy(corpus, name)
        got = _run(main, "-use", d, *VIDEO_ARGS, "-create", "-update",
                   "-similar", "-json")
        out[name] = d, _groups(got, d)
    return out


def test_cli_similar_groups_and_vdx_equal(indexes):
    (jd, want), (pd, got) = indexes["jax"], indexes["port"]
    assert got == want
    members = {frozenset([n] + [m[0] for m in ms]) for n, ms in got}
    assert {"a.fseq", "a_clip.fseq"} in members
    assert {"b.fseq", "b_2x.fseq"} in members
    assert {"c.fseq", "c_bright.fseq"} in members
    assert all(len({p[0] for p in g}) == 1 for g in members), members
    assert _vdx(pd) == _vdx(jd)


def test_cli_similar_to_equal_and_index_carries_across(corpus, indexes):
    """-similar-to an unindexed video, a stored one and a frame image; then
    each package's _index/ opened by the other."""
    (jd, want), (pd, _) = indexes["jax"], indexes["port"]
    root, _, c = corpus
    outside = os.path.join(root, "c_cut.fseq")
    _save(outside, c[10:70].copy())
    frame = os.path.join(root, "c_frame.png")
    from PIL import Image
    Image.fromarray(c[40]).save(frame)
    for needle in (outside, os.path.join(jd, "a_clip.fseq"), frame):
        args = ["-use", jd, *VIDEO_ARGS, "-similar-to", needle, "-json"]
        assert _groups(_run(port_cli.main, *args), jd) == \
            _groups(_run(jax_cli.main, *args), jd), needle
    hit = json.loads(_run(port_cli.main, "-use", jd, *VIDEO_ARGS,
                          "-similar-to", outside, "-json"))
    assert {os.path.basename(m["path"]) for m in hit[0]["matches"]} == \
        {"c.fseq", "c_bright.fseq"}
    assert _groups(_run(port_cli.main, "-use", jd, *VIDEO_ARGS, "-similar",
                        "-json"), jd) == want
    assert _groups(_run(jax_cli.main, "-use", pd, *VIDEO_ARGS, "-similar",
                        "-json"), pd) == _groups(
        _run(port_cli.main, "-use", pd, *VIDEO_ARGS, "-similar", "-json"), pd)


def test_make_video_index_and_compress_equal(corpus):
    _, src, c = corpus
    got = pv.make_video_index(pv.FseqBackend().frames(
        os.path.join(src, "c_bright.fseq")), threshold=8, device="cpu")
    want = jv.make_video_index(jv.FseqBackend().frames(
        os.path.join(src, "c_bright.fseq")), threshold=8)
    assert np.array_equal(got.frames, want.frames)
    assert np.array_equal(got.hashes, want.hashes)
    assert got.frames[0] == 0 and got.frames[-1] == 89
    rng = np.random.default_rng(5)
    base = rng.integers(0, 2**64, size=8, dtype=np.uint64)
    run = base[rng.integers(0, 8, 200)] ^ (  # scene runs with 0-2 bit noise
        np.uint64(1) << rng.integers(0, 64, 200).astype(np.uint64))
    run[::3] = base[rng.integers(0, 8, 67)]
    for t in (0, 1, 3, 8, 40):
        g, w = pv.compress_hash_run(run, t), jv.compress_hash_run(run, t)
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]), t


def test_process_video_resume_equal(tmp_path):
    """A resume-<md5>.vdx keeps the stored run and hashes on from its last
    frame + 1, one past the end re-hashes the whole video: the same
    indexes as the JAX package's process_video."""
    from cbird_tpu_torch.store.ioutil import full_md5_file
    from cbird_tpu_torch.store.vdx import save_vdx
    vid = str(tmp_path / "clip.fseq")
    _save(vid, make_frames(40, seed=5))
    full = pv.process_video(vid, IndexParams(), device="cpu").videoIndex
    resume = str(tmp_path / f"resume-{full_md5_file(vid)}.vdx")
    cut = int(np.searchsorted(full.frames, 25))
    for prior in (VideoIndexData(frames=full.frames[:cut].copy(),
                                 hashes=full.hashes[:cut].copy()),
                  VideoIndexData(frames=np.array([0, 99], np.int32),
                                 hashes=np.array([1, 2], np.uint64))):
        got = []
        for process in (pv.process_video, jv.process_video):
            save_vdx(resume, prior)
            kw = {"device": "cpu"} if process is pv.process_video else {}
            got.append(process(vid, IndexParams(), video_dir=str(tmp_path),
                               **kw).videoIndex)
            assert not os.path.exists(resume)  # consumed
        assert np.array_equal(got[0].frames, got[1].frames)
        assert np.array_equal(got[0].hashes, got[1].hashes)
    assert np.array_equal(got[0].frames, full.frames)  # past the end
    assert np.array_equal(got[0].hashes, full.hashes)


def test_parallel_ingest_and_ljf(tmp_path):
    """process_videos with 4 decode workers gives the serial results (two
    decoders must be in flight at once to pass a barrier), a broken file
    isolates; the scanner queues videos longest first."""
    paths = []
    for i, n in enumerate((12, 30, 20, 6)):
        p = str(tmp_path / f"v{i}.fseq")
        _save(p, make_frames(n, h=48, w=64, seed=i))
        paths.append(p)
    bad = str(tmp_path / "broken.fseq")
    with open(bad, "wb") as f:
        f.write(b"not an npz")
    barrier = threading.Barrier(2, timeout=30)
    orig = pv.FseqBackend.frames

    def frames(self, path, *a, **kw):
        barrier.wait()
        yield from orig(self, path, *a, **kw)

    pv.FseqBackend.frames = frames
    try:
        par = dict(pv.process_videos(paths + [bad], IndexParams(), workers=4,
                                     device="cpu"))
    finally:
        pv.FseqBackend.frames = orig
    ser = dict(pv.process_videos(paths, IndexParams(), workers=1,
                                 device="cpu"))
    assert par[bad] is None and not barrier.broken
    for p in paths:
        assert np.array_equal(par[p].videoIndex.hashes,
                              ser[p].videoIndex.hashes)
    params = IndexParams()
    params.minFileSize = 16
    queue = Scanner(params, device="cpu").scan_directory(
        str(tmp_path)).new_videos
    names = [os.path.basename(p) for p in queue if "broken" not in p]
    assert names == ["v1.fseq", "v2.fseq", "v0.fseq", "v3.fseq"]


def test_video_needle_image_algo(tmp_path):
    """-similar-to <video> with -p.alg dct grabs 9 evenly spaced frames and
    queries them as image needles: the posters at those frames come back
    (the JAX package's test_video_needle_image_algo, on the port)."""
    from PIL import Image
    from cbird_tpu_torch.host.engine import Engine
    root = str(tmp_path)
    full = make_frames(160, seed=7)
    _save(os.path.join(root, "full.fseq"), full)
    for i in (16, 80, 144):  # grab targets total * i // 10, total = 160
        Image.fromarray(full[i]).save(os.path.join(root, f"poster{i}.png"))
    params = IndexParams()
    params.algos = (1 << SearchParams.ALGO_DCT) | (1 << SearchParams.ALGO_VIDEO)
    params.minFileSize = 64
    eng = Engine(root, params, device="cpu")
    assert eng.update()["added"] == 4
    matches = eng.query(Media(os.path.join(root, "full.fseq")), SearchParams())
    assert {"poster16.png", "poster80.png", "poster144.png"} <= \
        {os.path.basename(m.path) for m in matches}
    eng.db.close()


def _stores(seed=3, videos=20, tombstone=6):
    """The same store in both packages: small-space hashes (dense near
    collisions), planted near copies, a removed video; plus needles."""
    rng = np.random.default_rng(seed)
    jax_idx, port_idx = JaxVideoIndex(), DctVideoIndex("cpu")
    stored = []
    for v in range(videos):
        n = int(rng.integers(5, 60))
        hashes = rng.integers(1, 1 << 16, size=n, dtype=np.uint64)
        for idx in (jax_idx, port_idx):
            idx._loaded = True
            idx._store.add_video(v + 1, np.arange(n, dtype=np.int32) * 7,
                                 hashes)
        stored.append(hashes)
    for idx in (jax_idx, port_idx):
        idx._store.remove([tombstone])
    needles = rng.integers(1, 1 << 16, size=24, dtype=np.uint64)
    plants = [stored[0][0], stored[1][2] ^ np.uint64(3),
              stored[tombstone - 1][1], stored[videos - 1][-1] ^ np.uint64(9)]
    return jax_idx, port_idx, np.concatenate([needles,
                                              np.array(plants, np.uint64)])


@pytest.fixture(scope="module")
def stores():
    return _stores()


@pytest.mark.parametrize("t", [6, 12])
def test_store_matches_reference(stores, t):
    jax_idx, port_idx, needles = stores
    js, ps = jax_idx._store, port_idx._store
    assert np.array_equal(ps.flat_hit_counts(needles, t),
                          js.flat_hit_counts(needles, t))
    for g, w in zip(ps.search_hits(needles, t), js.search_hits(needles, t)):
        assert g is not None and w is not None
        go, wo = np.argsort(g[0]), np.argsort(w[0])
        assert np.array_equal(g[0][go], w[0][wo])
        assert np.array_equal(g[1][go], w[1][wo])
    for g, w in zip(ps.search(needles), js.search(needles)):
        assert np.array_equal(g, w)
    for g, w in zip(port_idx._per_video_minima(needles, t),
                    jax_idx._per_video_minima(needles, t)):
        assert all(np.array_equal(x, y) for x, y in zip(g, w))


def test_minima_fallback_matches_dense(stores, monkeypatch):
    """Needles past k_cap go to the dense search; mixed batches equal the
    dense per-video minima and JAX's."""
    jax_idx, port_idx, needles = stores
    ps = port_idx._store
    orig = ps.search_hits
    monkeypatch.setattr(ps, "search_hits",
                        lambda h, t, **kw: orig(h, t, k_cap=1, **kw))
    assert any(r is None for r in ps.search_hits(needles, 12))
    d, f = ps.search(needles)
    for r, (s, dd, ff) in enumerate(port_idx._per_video_minima(needles, 12)):
        slots = np.nonzero(d[r] < 12)[0]
        assert s.tolist() == slots.tolist()
        assert dd.tolist() == d[r, slots].tolist()
        assert ff.tolist() == f[r, slots].tolist()
    for g, w in zip(port_idx._per_video_minima(needles, 12),
                    jax_idx._per_video_minima(needles, 12)):
        assert all(np.array_equal(x, y) for x, y in zip(g, w))


def test_search_hits_none_only_past_k_cap(stores, monkeypatch):
    """search_hits returns None exactly for the needles whose count passes
    k_cap; a top-k that disagrees with the count gate raises."""
    _, port_idx, needles = stores
    ps = port_idx._store
    counts = ps.flat_hit_counts(needles, 3)
    hits = ps.search_hits(needles, 3, k_cap=1)
    assert (counts > 1).any() and (counts == 1).any()
    assert [h is None for h in hits] == (counts > 1).tolist()
    topk = vs.hamming_topk
    monkeypatch.setattr(vs, "hamming_topk", lambda *a: (
        lambda d, i: (torch.full_like(d, 65), i))(*topk(*a)))
    with pytest.raises(RuntimeError, match="the count gate"):
        ps.search_hits(needles, 3)


def _video_indexes(seed, diverge=False):
    """12 videos x 120 frames in both packages; video 9 (7 with
    ``diverge``) copies a stretch of video 2 (3).  ``diverge`` gives every
    needle an in-memory index that differs from the stored one, so the
    all-pairs path declines and the flat count gate runs."""
    rng = np.random.default_rng(seed)
    jax_idx, port_idx = JaxVideoIndex(), DctVideoIndex("cpu")
    base = rng.integers(1, 2**63, size=120, dtype=np.uint64)
    src, dup = (3, 7) if diverge else (2, 9)
    media = []
    for v in range(12):
        hashes = rng.integers(1, 2**63, size=120, dtype=np.uint64)
        if v == src:
            hashes = base.copy()
        if v == dup:
            hashes[15:95] = base[25:105] ^ np.uint64(1 << 7)
        frames = np.arange(120, dtype=np.int32) * 10
        for idx in (jax_idx, port_idx):
            idx._loaded = True
            idx._store.add_video(v + 1, frames, hashes)
        m = Media(f"/x/{v}.mp4", TYPE_VIDEO, 64, 64, f"v{v}")
        m.id = v + 1
        m.videoIndex = VideoIndexData(
            frames=frames, hashes=hashes ^ np.uint64(diverge and v != src))
        media.append(m)
    return jax_idx, port_idx, media


def _matches(lists):
    return [[(m.mediaId, m.score, (m.range.srcIn, m.range.dstIn,
                                   m.range.len)) for m in b] for b in lists]


@pytest.mark.parametrize("diverge", [False, True])
def test_find_batch_matches_reference(diverge, monkeypatch):
    """The all-pairs self-search path (stored needles) and the flat count
    gate (diverged needles) give JAX's Match lists."""
    jax_idx, port_idx, media = _video_indexes(11, diverge)
    sp = SearchParams()
    sp.skipFrames = 40
    sp.minFramesMatched = 10
    calls = []
    orig = port_idx._store.flat_hit_counts
    monkeypatch.setattr(port_idx._store, "flat_hit_counts",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = _matches(port_idx.find_batch(media, sp))
    assert got == _matches(jax_idx.find_batch(media, sp))
    assert bool(calls) == diverge
    src, dup = (3, 7) if diverge else (2, 9)
    assert any(m[0] == dup + 1 for m in got[src])
    assert any(m[0] == src + 1 for m in got[dup])


def test_video_verbs_import_no_jax(corpus):
    """The video verbs in a subprocess: neither jax nor any module of the
    JAX package (cbird_tpu) is loaded."""
    d = _copy(corpus, "nojax")
    a = os.path.join(d, "a.fseq")
    code = (
        "import shutil, sys\n"
        "from cbird_tpu_torch.cli.main import main\n"
        f"v = {VIDEO_ARGS!r}\n"
        f"d, a = {d!r}, {a!r}\n"
        "assert main(['-use', d, *v, '-create', '-update', '-similar',"
        " '-json']) == 0\n"
        "assert main(['-use', d, *v, '-similar-to', a, '-dump']) == 0\n"
        "x = shutil.copy(d + '/c.fseq', d + '/extra.fseq')\n"
        "assert main(['-use', d, '-add-video', x, '-test-video-decoder', a,"
        " '-video-thumbnail', a, '10', '-compare-videos', a,"
        " d + '/a_clip.fseq']) == 0\n"
        "bad = [k for k in sys.modules if k == 'jax' or k == 'cbird_tpu'\n"
        "       or k.startswith(('jax.', 'cbird_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('NOJAX-OK')\n")
    env = dict(os.environ, CBIRD_TORCH_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert out.rstrip().endswith("NOJAX-OK")
    groups = json.loads(out[:out.index("\n]\n") + 2])
    assert len(groups) == 3
    assert "90 frames" in out and "alignment offset:" in out
    assert os.path.exists(os.path.join(d, "thumb.png"))
    assert os.path.exists(os.path.join(d, "compare.kdenlive"))
