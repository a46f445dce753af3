"""Port parity for the whole dct slice: the CLI through cbird_tpu and through
cbird_tpu_torch on the CPU (``CBIRD_TORCH_DEVICE=cpu``).

- ``-create -update -similar -json`` on one small corpus gives equal
  groups (and equal hashes) in both packages;
- state carries across: an ``_index/`` the JAX package built opens in the
  port without re-hashing and gives the same groups, and the reverse;
- ``-show`` writes the same HTML report in both;
- a subprocess imports every module of the port and runs its slice, and
  neither ``jax`` nor any module of ``cbird_tpu`` is imported.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from cbird_tpu.cli import main as jax_cli
from cbird_tpu.ops import hamming as jh
from cbird_tpu.store import ioutil as jax_ioutil
from cbird_tpu_torch.cli import main as port_cli
from cbird_tpu_torch.store import ioutil as port_ioutil

from fixtures import make_corpus

torch.set_num_threads(1)

# small decode size: the JAX hash program compiles for a 256^2 canvas
ARGS = ["-i.algos", "dct", "-i.rsize", "128"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CBIRD_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(jh, "_MESH", None)  # single-device reference


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    src = str(root / "src")
    groups = make_corpus(src, n_base=5, scales=(1.0, 0.75, 0.5))
    return str(root), src, groups


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
    """-json output -> {(needle, (matches...))} with paths relative to root,
    plus {path: dctHash}."""
    groups, hashes = set(), {}
    for g in json.loads(out):
        members = [g["needle"]] + g["matches"]
        for m in members:
            hashes[os.path.relpath(m["path"], root)] = m["dctHash"]
        groups.add(tuple(os.path.relpath(m["path"], root) for m in members))
    return groups, hashes


@pytest.fixture(scope="module")
def jax_index(corpus):
    d = _copy(corpus, "jax")
    out = _run(jax_cli.main, "-use", d, *ARGS, "-create", "-update",
               "-similar", "-json")
    return d, _groups(out, d)


def test_similar_groups_equal(corpus, jax_index):
    _, want = jax_index
    d = _copy(corpus, "port")
    out = _run(port_cli.main, "-use", d, *ARGS, "-create", "-update",
               "-similar", "-json")
    groups, hashes = _groups(out, d)
    assert groups == want[0]
    assert hashes == want[1]
    assert len(groups) == 5  # each base image groups its two rescales


def test_similar_to_equal(corpus, jax_index):
    d, _ = jax_index
    needle = os.path.join(d, "img002_s075.png")
    want = _run(jax_cli.main, "-use", d, *ARGS, "-similar-to", needle, "-json")
    got = _run(port_cli.main, "-use", d, *ARGS, "-similar-to", needle,
               "-json")
    assert _groups(got, d) == _groups(want, d)
    assert len(json.loads(got)[0]["matches"]) == 2


def test_index_carries_across(corpus, jax_index):
    """The JAX-built _index/ opens in the port, and the port's in JAX."""
    d, want = jax_index
    got = _run(port_cli.main, "-use", d, "-similar", "-json")
    assert _groups(got, d) == want
    p = _copy(corpus, "port2")
    _run(port_cli.main, "-use", p, *ARGS, "-create", "-update")
    back = _run(jax_cli.main, "-use", p, "-similar", "-json")
    assert _groups(back, p) == want


def test_jpeg_digests_equal_reference():
    """The port's pure-Python jpeg payload scan gives the JAX package's
    digests (its native scan where it builds): real jpegs with and without
    EXIF, and FF-dense marker soup."""
    img = Image.fromarray(
        (np.arange(64 * 64).reshape(64, 64) % 255).astype(np.uint8))
    exif = Image.Exif()
    exif[0x010F] = "cbird-test-camera"
    cases = [b"", b"\xff\xd8\xff\xe1\x00\x04ab\xff\xda123\xff\xd9"]
    for kw in ({}, {"exif": exif.tobytes()}):
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90, **kw)
        cases.append(buf.getvalue())
    rng = np.random.default_rng(42)
    for _ in range(100):
        raw = rng.integers(0, 256, int(rng.integers(2, 64))).astype(np.uint8)
        raw[rng.random(len(raw)) < 0.3] = 0xFF
        raw[:2] = (0xFF, 0xD8)
        cases.append(raw.tobytes())
    for data in cases:
        assert (port_ioutil.image_content_md5(data)
                == jax_ioutil.image_content_md5(data)), data.hex()
        assert port_ioutil.jpeg_payload(data) == jax_ioutil.jpeg_payload(data)


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _stop_browser(port):
    """Press the browser's Quit button once its page answers."""
    import re
    import time
    import urllib.request
    url = f"http://127.0.0.1:{port}/"
    for _ in range(300):
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                token = re.search(rb'TOKEN="([0-9a-f]+)"', r.read()).group(1)
            break
        except OSError:
            time.sleep(0.1)
    req = urllib.request.Request(url + "api/quit", data=b"{}", method="POST",
                                 headers={"X-Cbird-Token": token.decode()})
    urllib.request.urlopen(req, timeout=10).read()


def _stop_server(port, mod):
    """Ping the query server, then stop it."""
    import time
    for _ in range(300):
        try:
            c = mod.QueryClient(f"127.0.0.1:{port}")
            break
        except OSError:
            time.sleep(0.1)
    assert c.call({"cmd": "ping"})["pong"]
    assert c.call({"cmd": "stop"})["stopping"]
    c.close()


@pytest.mark.parametrize("verb", ["-p.tm", "-browse", "-serve", "-verify",
                                  "-qualityscore", "-select-grid"])
def test_lifted_verbs_exit_as_jax(verb, jax_index, monkeypatch):
    """The verbs the port used to refuse run and exit as the JAX CLI's:
    -p.tm 1 -similar (both ORBs at two pyramid levels), -browse (stopped
    by its Quit button), -serve (stopped by a client), -verify,
    -qualityscore and -select-grid (tests/test_torch_verbs.py and
    tests/test_torch_template_matcher.py hold their output)."""
    import threading
    import jax.numpy
    from cbird_tpu.cli import serve as jax_serve
    from cbird_tpu.ops import orb as jo
    from cbird_tpu_torch.cli import serve as port_serve
    from cbird_tpu_torch.ops import orb as po
    d, _ = jax_index
    monkeypatch.setattr(jo, "N_LEVELS", 2)
    monkeypatch.setattr(po, "N_LEVELS", 2)
    orb_kernel = jo._orb_kernel

    def padded(canvas, sizes, nfeatures):
        """The JAX ORB at one batch shape: the template and its two
        candidates (the pyramid runs each image of a batch on its own)."""
        b = canvas.shape[0]
        c = jax.numpy.zeros((2,) + canvas.shape[1:], canvas.dtype)
        z = jax.numpy.ones((2, 2), sizes.dtype)
        res = orb_kernel(c.at[:b].set(canvas), z.at[:b].set(sizes), nfeatures)
        return {k: v[:b] for k, v in res.items()}
    monkeypatch.setattr(jo, "_orb_kernel", padded)
    args = {"-p.tm": ["-p.tm", "1", "-p.tnf", "400", "-p.thf", "400",
                      "-similar", "-json"],
            "-browse": ["-similar", "-browse"],
            "-serve": ["-serve"],
            "-verify": ["-verify"],
            "-qualityscore": ["-similar", "-qualityscore"],
            "-select-grid": ["-select-grid",
                             os.path.join(d, "img000_s100.png"), "-count"],
            }[verb]
    outs = []
    for main, serve in ((port_cli.main, port_serve), (jax_cli.main,
                                                       jax_serve)):
        port = _free_port()
        monkeypatch.setenv("CBIRD_BROWSER_PORT", str(port))
        monkeypatch.setenv("CBIRD_SERVE_ADDR", f"127.0.0.1:{port}")
        stop = {"-browse": lambda: _stop_browser(port),
                "-serve": lambda: _stop_server(port, serve)}.get(verb)
        stopper = threading.Thread(target=stop) if stop else None
        if stopper:
            stopper.start()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["-use", d, *args])
        if stopper:
            stopper.join(timeout=60)
            assert not stopper.is_alive()
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0] == 0


def test_show_report_equal(jax_index, tmp_path, monkeypatch):
    """-show writes the JAX package's HTML report, byte for byte."""
    d, _ = jax_index
    pages = []
    for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        out = str(tmp_path / f"{name}.html")
        monkeypatch.setenv("CBIRD_REPORT", out)
        _run(main, "-use", d, "-similar", "-show")
        with open(out, "rb") as f:
            pages.append(f.read())
    assert pages[0] == pages[1]
    assert pages[1].count(b"data:image/jpeg;base64,") == 15


def test_slice_imports_no_jax(corpus):
    """Every module of the port imported, then the CLI slice run (dct,
    -update -similar with fdct, with orb and with color, -p.tm 1 -similar,
    and a -serve that a client queries and stops): neither jax nor any
    module of the JAX package (cbird_tpu) is loaded."""
    d = _copy(corpus, "nojax")
    needle = os.path.join(d, "img000_s100.png")
    port = _free_port()
    code = (
        "import importlib, pkgutil, sys\n"
        "import cbird_tpu_torch\n"
        "for m in pkgutil.walk_packages(cbird_tpu_torch.__path__,\n"
        "                               'cbird_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from cbird_tpu_torch.cli.main import main\n"
        f"args = {ARGS!r}\n"
        f"assert main(['-use', {d!r}, *args, '-create', '-update',"
        " '-similar', '-json']) == 0\n"
        f"assert main(['-use', {d!r}, '-similar-to', {needle!r}]) == 0\n"
        "import contextlib, io\n"
        "for alg in ('fdct', 'orb', 'color'):\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        f"        assert main(['-use', {d!r}, '-i.algos', 'dct+' + alg,"
        " '-update', '-p.alg', alg, '-similar']) == 0\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    assert main(['-use', {d!r}, '-p.tm', '1', '-similar']) == 0\n"
        "import os, threading, time\n"
        "from cbird_tpu_torch.cli.serve import QueryClient\n"
        f"os.environ['CBIRD_SERVE_ADDR'] = '127.0.0.1:{port}'\n"
        f"t = threading.Thread(target=main, args=(['-use', {d!r},"
        " '-serve'],))\n"
        "t.start()\n"
        "for _ in range(600):\n"
        "    try:\n"
        f"        c = QueryClient('127.0.0.1:{port}')\n"
        "        break\n"
        "    except OSError:\n"
        "        time.sleep(0.1)\n"
        f"assert len(c.query({needle!r})[0]) == 3\n"
        "assert c.call({'cmd': 'stop'})['stopping']\n"
        "c.close()\n"
        "t.join(60)\n"
        "assert not t.is_alive()\n"
        "bad = [k for k in sys.modules if k == 'jax' or k == 'cbird_tpu'\n"
        "       or k.startswith(('jax.', 'cbird_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('NOJAX-OK')\n")
    # ORB at two levels (the scanner's fdct and orb -update too) and two
    # torch threads: the extraction stays cheap under a loaded machine
    env = dict(os.environ, CBIRD_TORCH_DEVICE="cpu", CBIRD_ORB_LEVELS="2",
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.rstrip().endswith("NOJAX-OK")
    groups = json.loads(proc.stdout[:proc.stdout.rindex("NOJAX-OK")])
    assert len(groups) == 5


def test_complete_takes_only_a_shell(tmp_path, monkeypatch, capsys):
    """-complete consumes a following "bash" or "zsh" as its shell; any
    other argument is the next verb's (here an unknown one: rc 2)."""
    monkeypatch.chdir(tmp_path)
    for shell in ("bash", "zsh"):
        assert port_cli.main(["-complete", shell]) == 0
        assert "complete -F _cbird_complete cbird" in capsys.readouterr().out
    assert port_cli.main(["-complete", "-version"]) == 0
    assert capsys.readouterr().out.rstrip().endswith(port_cli.__version__)
    assert port_cli.main(["-complete", "notashell"]) == 2
    assert "unknown argument: notashell" in capsys.readouterr().err


def test_known_verbs_equal_dispatch():
    """The completion list holds every verb _dispatch takes (each literal
    it compares the verb with and the GUI option sets it names),
    single-dash spellings only, each once."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(port_cli))
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "_dispatch")
    named = {t.id: n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
             for t in n.targets if isinstance(t, ast.Name)}
    verbs = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name) \
                and node.left.id == "a":
            for c in node.comparators:
                c = named.get(c.id, c) if isinstance(c, ast.Name) else c
                verbs |= {s.value for s in ast.walk(c)
                          if isinstance(s, ast.Constant)
                          and isinstance(s.value, str)
                          and not s.value.startswith("--")}
    assert sorted(port_cli._KNOWN_VERBS) == sorted(verbs)
    assert {"-test-video-decoder", "-test-video", "-test-image-loader",
            "-simtest"} <= verbs


def test_stopped_update_keeps_modified_rows(corpus, monkeypatch):
    """A stopped -update removes a modified file's row only when it writes
    the re-add: the rows it did not reach stay, are reported, and the next
    update re-adds them."""
    from cbird_tpu_torch.host.engine import Engine
    from cbird_tpu_torch.params import IndexParams
    d = _copy(corpus, "stop")
    _run(port_cli.main, "-use", d, *ARGS, "-create", "-update")
    params = IndexParams()
    params.set_param("algos", "dct")
    params.set_param("rsize", "128")
    eng = Engine(d, params)
    now = eng.db.last_added()
    eng.db.write_last_added(now - 100)  # as if indexed 100 s ago
    for f in os.listdir(d):
        if f.endswith(".png"):
            os.utime(os.path.join(d, f), (now - 200, now - 200))
    modified = [os.path.join(d, f) for f in ("img001_s100.png",
                                             "img003_s050.png")]
    old = {p: eng.db.media_with_path(p).md5 for p in modified}
    for p in modified:
        with Image.open(p) as im:
            im.transpose(Image.Transpose.FLIP_LEFT_RIGHT).save(p)
        os.utime(p, (now - 50, now - 50))
    count = eng.db.count()
    real = eng.scanner.process_images

    def stop_at_first(paths, progress=None):
        for m in real(paths, progress):
            eng.stop_update()
            yield m
    monkeypatch.setattr(eng.scanner, "process_images", stop_at_first)
    stats = eng.update()
    assert stats["stopped"] and stats["modified"] == 2
    assert len(stats["modified_kept"]) == 1
    kept, = stats["modified_kept"]
    done, = set(modified) - {kept}
    assert eng.db.count() == count
    assert eng.db.media_with_path(kept).md5 == old[kept]
    assert eng.db.media_with_path(done).md5 != old[done]
    stats = Engine(d, params).update()
    assert not stats["stopped"] and stats["modified"] == 2
    assert eng.db.media_with_path(kept).md5 != old[kept]
    assert eng.db.count() == count
