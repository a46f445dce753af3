"""Port parity for the whole dct slice: the CLI through cbird_tpu and through
cbird_tpu_torch on the CPU (``CBIRD_TORCH_DEVICE=cpu``).

- ``-create -update -similar -json`` on one small corpus gives equal
  groups (and equal hashes) in both packages;
- state carries across: an ``_index/`` the JAX package built opens in the
  port without re-hashing and gives the same groups, and the reverse;
- a subprocess runs the port's slice and shows ``jax`` never imported.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from cbird_tpu.cli import main as jax_cli
from cbird_tpu.ops import hamming as jh
from cbird_tpu_torch.cli import main as port_cli

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


def test_not_ported_verbs_fail_cleanly(jax_index, capsys):
    d, _ = jax_index
    assert port_cli.main(["-use", d, "-p.alg", "orb", "-similar"]) == 2
    assert port_cli.main(["-use", d, "-show"]) == 2
    assert "not ported yet" in capsys.readouterr().err


def test_slice_imports_no_jax(corpus):
    d = _copy(corpus, "nojax")
    needle = os.path.join(d, "img000_s100.png")
    code = (
        "import json, sys\n"
        "from cbird_tpu_torch.cli.main import main\n"
        f"args = {ARGS!r}\n"
        f"assert main(['-use', {d!r}, *args, '-create', '-update',"
        " '-similar', '-dump']) == 0\n"
        f"assert main(['-use', {d!r}, '-similar-to', {needle!r}]) == 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NOJAX-OK')\n")
    env = dict(os.environ, CBIRD_TORCH_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NOJAX-OK" in proc.stdout
    assert "=== group" in proc.stdout
