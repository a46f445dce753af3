"""Port parity of the ORB extractor and the feature algorithms' CLI:
``cbird_tpu_torch.ops.orb`` on the CPU against ``cbird_tpu.ops.orb`` on the
JAX CPU backend, on the same seeded images.

Everything that runs the JAX ORB pyramid is in this one file, so that one
worker compiles its level programs once (at the batch of 16 that
``extract_features_batch`` and the CLI use).  Each JAX level program costs
seconds of compile on the CPU, so the whole extraction and the CLI run at
FEW_LEVELS pyramid levels (the CBIRD_ORB_LEVELS setting, patched into
both packages), and the level programs are checked at level 0 of that
pyramid (the program they share) and at levels 6 and 11 of the default
twelve.

Tolerances, and why:
- keypoints (xs, ys, size, valid): exact.  The port rounds the Harris
  response and the keypoint map-back as XLA's compiled program does (the
  window sum, multiply-adds), and breaks top-k ties by the lower index;
- Harris responses 1e-4 relative and level images 1e-3 absolute (0..255):
  float32 sums in another order;
- angles 1e-5 rad: the intensity centroid's sums in another order and
  another libm's atan2;
- descriptors: exact given the same angles.  From the image, a rotated
  sample offset on a rounding edge flips a bit where the angles differ in
  the last ulps: at most 1 bit a keypoint, in at most 1% of keypoints
  (ROADMAP queue 3);
- keypoint hashes: bit for bit, except the bits whose coefficient lies
  within float noise of the hash's threshold (the coefficients' mean;
  within 1e-6 of the ROI's DC term, from a float64 recomputation).  Such
  a bit is noise in either package.  In a flat ROI every bit is; in an
  almost flat one (a faint edge at its border) most are, as the
  coefficients that are zero in exact arithmetic sit at the threshold
  (ROADMAP queue 3).
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

import jax
import jax.numpy as jnp

from cbird_tpu.cli import main as jax_cli
from cbird_tpu.ops import hamming as jh
from cbird_tpu.ops import orb as jo
from cbird_tpu_torch.cli import main as port_cli
from cbird_tpu_torch.ops import dct_hash as pdh
from cbird_tpu_torch.ops import orb as po


torch.set_num_threads(1)

NFEAT = 400
FEW_LEVELS = 2  # the pyramid depth of the extraction and CLI tests
BATCH = 16  # extract_features_batch's chunk: the level programs' batch


def textured(rng, h, w, n=40):
    """Blocks of random grey on a flat ground (tests/test_features.py)."""
    img = np.full((h, w), 60, np.uint8)
    for _ in range(n):
        y, x = rng.integers(0, h - 20), rng.integers(0, w - 20)
        hh, ww = rng.integers(8, 50), rng.integers(8, 50)
        img[y:y + hh, x:x + ww] = rng.integers(0, 255)
    return img


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CBIRD_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(jh, "_MESH", None)  # single-device reference


@contextlib.contextmanager
def few_levels():
    """Both packages at FEW_LEVELS pyramid levels, as CBIRD_ORB_LEVELS sets
    them at import."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jo, "N_LEVELS", FEW_LEVELS)
        mp.setattr(po, "N_LEVELS", FEW_LEVELS)
        yield


@pytest.fixture
def at_few_levels():
    with few_levels():
        yield


@pytest.fixture(scope="module")
def grays():
    rng = np.random.default_rng(77)
    return [textured(rng, 320, 400), textured(rng, 400, 260),
            textured(rng, 300, 300)]


@pytest.fixture(scope="module")
def canvas(grays):
    """The prescaled images in a canvas of BATCH, as both packages pack."""
    imgs = [jo._prescale(g) for g in grays]
    c = np.zeros((BATCH, po.CANVAS, po.CANVAS), np.float32)
    sizes = np.zeros((BATCH, 2), np.int32)
    for n, g in enumerate(imgs):
        c[n, :g.shape[0], :g.shape[1]] = g
        sizes[n] = g.shape
    return imgs, c, sizes


def small(seed, n=96):
    """A textured n x n level image (float32)."""
    rng = np.random.default_rng(seed)
    return textured(rng, n, n, n=24).astype(np.float32)


def desc_bits(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Differing bits per row of two [K, 32] uint8 / [K, 8] uint32 sets."""
    x = np.ascontiguousarray(a).view(np.uint8) ^ \
        np.ascontiguousarray(b).view(np.uint8)
    return np.unpackbits(x.reshape(len(a), 32), axis=1).sum(axis=1)


def check_desc(bits: np.ndarray, measured: int):
    """At most 1 bit a keypoint, in at most ``measured`` keypoints (the
    count these inputs gave when the test was written)."""
    print(f"descriptors with a differing bit: {np.count_nonzero(bits)} of "
          f"{len(bits)}")
    assert bits.max(initial=0) <= 1, bits.max()
    assert np.count_nonzero(bits) <= measured, \
        (np.count_nonzero(bits), len(bits))


def noise_bits(gray: np.ndarray, xs, ys, sizes, valid) -> np.ndarray:
    """Per hashed ROI (keypoint_hashes' order): the uint64 mask of the hash
    bits whose coefficient lies within 1e-6 of the DC term of the
    threshold, the coefficients' mean (float64)."""
    h, w = gray.shape
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt)[None]
    boxes, ok = po.roi_boxes(t(xs, torch.float32), t(ys, torch.float32),
                             t(sizes, torch.float32), t(valid, torch.bool),
                             torch.tensor([h]), torch.tensor([w]))
    bx = boxes[0][ok[0]]
    if not len(bx):
        return np.zeros(0, np.uint64)
    top, bottom, left, right = bx.unbind(1)
    rb = pdh._blur_radius((bottom - top) * (right - left))
    mh = pdh._axis_map(top, bottom - top, rb, 32, h).double()
    mw = pdh._axis_map(left, right - left, rb, 32, w).double()
    g = mh @ torch.from_numpy(gray).double() @ mw.transpose(1, 2)
    d = torch.as_tensor(pdh._D32).double()
    f = d @ g @ d.T
    v = f[:, :9, :9].reshape(-1, 81)[:, torch.as_tensor(pdh._ZZ64)]
    near = (v - v.mean(dim=1, keepdim=True)).abs() \
        < 1e-6 * f[:, :1, 0].abs()
    w = torch.as_tensor(pdh._BITS)
    return (near.long() * w).sum(dim=1).numpy().view(np.uint64)


def check_hashes(want: np.ndarray, got: np.ndarray, noise: np.ndarray):
    assert len(want) == len(got) == len(noise)
    wrong = (want ^ got) & ~noise
    assert not wrong.any(), np.nonzero(wrong)


# ---- the pieces, on small canvases ---------------------------------------

def test_budgets_pattern_and_dims():
    assert po.features_per_level(NFEAT) == jo.features_per_level(NFEAT)
    assert sum(po.features_per_level(NFEAT, 5)) == NFEAT
    assert np.array_equal(po._PATTERN, jo._PATTERN)
    assert po._level_dims() == jo._LEVEL_DIMS


@pytest.mark.parametrize("seed", [1, 2])
def test_fast_nms_resize_pieces(seed):
    img = small(seed)
    t = torch.from_numpy(img)[None]
    got = po._fast_corners(t)[0].numpy()
    assert np.array_equal(got, np.asarray(jax.jit(jo._fast_corners)(img)))
    resp = np.where(got, img * 3.0, -np.inf).astype(np.float32)
    assert np.array_equal(po._nms3(torch.from_numpy(resp)[None])[0].numpy(),
                          np.asarray(jax.jit(jo._nms3)(resp)))
    hr = np.asarray(jax.jit(jo._harris)(img))
    pr = po._harris(t)[0].numpy()
    np.testing.assert_allclose(pr, hr, rtol=1e-4,
                               atol=1e-4 * np.abs(hr).max())
    # a 96 px canvas of a 90 x 70 image, to levels 2 and 6 of the pyramid
    for out_n in (72, 40):
        f = jax.jit(lambda c, h, w: jo._resize_area(c, h, w, out_n))
        lj, lhj, lwj = f(img, jnp.int32(90), jnp.int32(70))
        lp, lhp, lwp = po._resize_area(t, torch.tensor([90]),
                                       torch.tensor([70]), out_n)
        assert (int(lhj), int(lwj)) == (int(lhp[0]), int(lwp[0]))
        np.testing.assert_allclose(lp[0].numpy(), np.asarray(lj), atol=1e-3)


@pytest.mark.parametrize("seed", [3, 4])
def test_detect_orientation_descriptors(seed):
    img = small(seed)
    k = 40
    yj, xj, rj, vj = [np.asarray(a) for a in jax.jit(
        lambda a: jo._detect_level(a, jnp.int32(96), jnp.int32(90), k))(img)]
    yp, xp, rp, vp = po._detect_level(torch.from_numpy(img)[None],
                                      torch.tensor([96]), torch.tensor([90]),
                                      k)
    assert vj.sum() >= 3
    assert np.array_equal(yj, yp[0].numpy()) and np.array_equal(
        xj, xp[0].numpy()) and np.array_equal(vj, vp[0].numpy())
    np.testing.assert_allclose(rp[0].numpy()[vj], rj[vj], rtol=1e-4)
    pad = np.pad(img, po.PATCH)
    patches = np.asarray(jax.jit(jo._gather_patches)(pad, yj, xj))
    pp = po._gather_patches(torch.from_numpy(pad)[None], yp, xp)[0]
    assert np.array_equal(pp.numpy(), patches)
    aj = np.asarray(jax.jit(jo._orientation)(patches))
    ap = po._orientation(pp).numpy()
    np.testing.assert_allclose(ap[vj], aj[vj], atol=1e-5, rtol=0)
    blurred = np.asarray(jax.jit(
        lambda a: jnp.pad(jo._box_blur(a, 2), po.PATCH))(img))
    dj = np.asarray(jax.jit(jo._descriptors)(blurred, yj, xj, aj))
    dp = po._descriptors(torch.from_numpy(np.array(blurred))[None], yp,
                         xp, torch.from_numpy(aj)[None])[0].numpy()
    assert np.array_equal(dp.view(np.uint32).reshape(dj.shape), dj)


# ---- the level programs, the keypoint hashes, the whole extraction --------

# keypoints whose descriptor differs (by one bit) on these inputs: per
# checked level, and over the whole extraction of the three images
MEASURED = {0: 0, 6: 2, 11: 0, "all": 0}


def level_budget(lvl: int) -> int:
    """The keypoint budget of checked level ``lvl``: level 0 of the
    FEW_LEVELS pyramid, other levels of the default one."""
    return max(jo.features_per_level(NFEAT)[lvl] if lvl else
               po.features_per_level(NFEAT, FEW_LEVELS)[0], 1)


@pytest.mark.parametrize("lvl", [0, 6, 11])
def test_level_program(canvas, lvl):
    imgs, c, sizes = canvas
    k = level_budget(lvl)
    want = [np.asarray(a)[:len(imgs)] for a in jo._level_kernel(lvl, k)(
        jnp.asarray(c), jnp.asarray(sizes[:, 0]), jnp.asarray(sizes[:, 1]))]
    n = len(imgs)
    got = po.orb_level(torch.from_numpy(c[:n]), torch.from_numpy(sizes[:n, 0]),
                       torch.from_numpy(sizes[:n, 1]), lvl, k)
    got = {key: v.numpy() for key, v in got.items()}
    xs, ys, size, resp, angle, desc, valid = want
    for key, w in (("xs", xs), ("ys", ys), ("size", size), ("valid", valid)):
        assert np.array_equal(got[key], w), key
    if lvl < 11:
        assert valid.sum() >= 3
    np.testing.assert_allclose(got["resp"][valid], resp[valid], rtol=1e-4)
    np.testing.assert_allclose(got["angle"][valid], angle[valid], atol=1e-5,
                               rtol=0)
    check_desc(desc_bits(got["desc"][valid], desc[valid]), MEASURED[lvl])


def test_keypoint_hashes(canvas):
    """The ROI hashes of the JAX package's own level-0 keypoints."""
    imgs, c, sizes = canvas
    k = level_budget(0)
    xs, ys, size, _, _, _, valid = [np.asarray(a) for a in jo._level_kernel(
        0, k)(jnp.asarray(c), jnp.asarray(sizes[:, 0]),
              jnp.asarray(sizes[:, 1]))]
    total = 0
    for n, g in enumerate(imgs):
        want = jo.keypoint_hashes(g, xs[n], ys[n], size[n], valid[n])
        got = po.keypoint_hashes(g, xs[n], ys[n], size[n], valid[n],
                                 device="cpu")
        check_hashes(want, got, noise_bits(g, xs[n], ys[n], size[n],
                                          valid[n]))
        total += len(want)
    assert total > 100


def test_extract_features_batch(grays, canvas, at_few_levels):
    """Three images at FEW_LEVELS levels: the same keypoints, the
    descriptors and the keypoint hashes per the tolerances above."""
    imgs, c, sizes = canvas
    want = jo.extract_features_batch(grays, nfeatures=NFEAT)
    got = po.extract_features_batch(grays, nfeatures=NFEAT, device="cpu")
    kp = {key: np.asarray(v)[:len(imgs)] for key, v in jo._orb_kernel(
        jnp.asarray(c), jnp.asarray(sizes), NFEAT).items()}
    bits = []
    for n, ((dj, hj), (dp, hp)) in enumerate(zip(want, got)):
        assert dp.dtype == np.uint8 and dp.shape == dj.shape
        assert len(dj) > 50 and len(hj) > 10
        bits.append(desc_bits(dp, dj))
        check_hashes(hj, hp, noise_bits(imgs[n], kp["xs"][n], kp["ys"][n],
                                       kp["size"][n], kp["valid"][n]))
    check_desc(np.concatenate(bits), MEASURED["all"])


def test_features_independent_of_batch(grays):
    """One image alone gives, bit for bit, the features it gets in a batch
    of 8 (at FEW_LEVELS levels; the level images at every level of the
    default pyramid): no step rounds by the batch's shape."""
    rng = np.random.default_rng(78)
    imgs = [po._prescale(g) for g in grays] + [
        po._prescale(textured(rng, 200 + 40 * i, 300)) for i in range(5)]
    canvas, sizes = po.pack_chunk(imgs, "cpu")
    n = 5
    for lvl, (out_n, _) in enumerate(po._level_dims(12)):
        one = po._resize_area(canvas[n:n + 1], sizes[n:n + 1, 0],
                              sizes[n:n + 1, 1], out_n)[0]
        all8 = po._resize_area(canvas, sizes[:, 0], sizes[:, 1], out_n)[0]
        assert torch.equal(one[0], all8[n]), lvl
    nfeat = 100  # a quarter of the default: the ROI hashes take most time
    batch = po.features_chunk(canvas, sizes, nfeat, levels=FEW_LEVELS)
    alone = po.features_chunk(canvas[n:n + 1], sizes[n:n + 1], nfeat,
                              levels=FEW_LEVELS)
    for key, v in alone.items():
        assert torch.equal(v[0], batch[key][n]), key
    assert batch["valid"].sum() > 8 * 50 and alone["hash_ok"].sum() > 20


# ---- the fdct and orb CLI against the JAX package's ------------------------

ARGS = ["-i.algos", "dct+fdct+orb"]


def _run(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(args))
    assert rc == 0, args
    return buf.getvalue()


def _groups(out: str, root: str):
    """-json output -> {(needle, frozenset(matches))}, paths relative to
    root.  The order of a group's matches is left out: equal scores keep
    the order of their votes, which a keypoint hash's noise bits (noise
    in either package, see above) can change."""
    rel = lambda m: os.path.relpath(m["path"], root)
    return {(rel(g["needle"]), frozenset(map(rel, g["matches"])))
            for g in json.loads(out)}


@pytest.fixture(scope="module")
def feature_dirs(tmp_path_factory):
    """Four textured sources, each with a 0.75 scale and a crop, indexed by
    each package."""
    root = tmp_path_factory.mktemp("feat")
    src = str(root / "src")
    os.makedirs(src)
    rng = np.random.default_rng(7)
    for b in range(4):
        im = Image.fromarray(textured(rng, 320, 400))
        im.save(os.path.join(src, f"t{b}.png"))
        im.resize((300, 240), Image.BOX).save(
            os.path.join(src, f"t{b}_s75.png"))
        im.crop((50, 30, 350, 290)).save(os.path.join(src, f"t{b}_crop.png"))
    dirs = {}
    with pytest.MonkeyPatch.context() as mp, few_levels():
        mp.setenv("CBIRD_TORCH_DEVICE", "cpu")
        mp.setattr(jh, "_MESH", None)
        for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
            d = str(root / name)
            shutil.copytree(src, d)
            _run(main, "-use", d, *ARGS, "-create", "-update")
            dirs[name] = d
    return dirs


@pytest.mark.parametrize("alg", ["fdct", "orb"])
def test_feature_cli_equal(feature_dirs, at_few_levels, alg):
    """-similar and -similar-to give the JAX CLI's groups; each package
    also reads the other's index."""
    dj, dp = feature_dirs["jax"], feature_dirs["port"]
    want = _groups(_run(jax_cli.main, "-use", dj, "-p.alg", alg, "-similar",
                        "-json"), dj)
    got = _groups(_run(port_cli.main, "-use", dp, "-p.alg", alg, "-similar",
                       "-json"), dp)
    assert got == want
    assert len(want) >= 2
    across = _groups(_run(port_cli.main, "-use", dj, "-p.alg", alg,
                          "-similar", "-json"), dj)
    assert across == want
    needle = min(want)[0]
    want_to = _groups(_run(jax_cli.main, "-use", dj, "-p.alg", alg,
                           "-similar-to", os.path.join(dj, needle),
                           "-json"), dj)
    got_to = _groups(_run(port_cli.main, "-use", dp, "-p.alg", alg,
                          "-similar-to", os.path.join(dp, needle),
                          "-json"), dp)
    assert got_to == want_to and want_to
