"""The port's kernel build (``cbird_tpu_torch/_build.py``) on the CPU: a
library's path hashes its source with every local header it includes, so
an edited header rebuilds each source that includes it and no other; and
every form that chip_tune.py builds as a text edit of a kernel source
still finds its text.  No nvcc is needed: nothing is compiled.
"""

import importlib.util
import os
import shutil

import pytest

from cbird_tpu_torch import _build

HEADER = "sm90.cuh"
INCLUDERS = ("count_below_mma", "hamming_lanes_topk")
OTHERS = ("count_below", "band_count", "hamming_topk", "color_scores")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads instead."""
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", str(dst))
    return dst


def _paths():
    return {name: _build.library_path(name) for name in INCLUDERS + OTHERS}


def test_sources_list_included_headers(csrc):
    """The tensor-core sources include the shared header, once each; the
    others include no local header."""
    for name in INCLUDERS:
        assert [os.path.basename(p) for p in _build.sources(name)] == [
            f"{name}.cu", HEADER]
    for name in OTHERS:
        assert _build.sources(name) == [str(csrc / f"{name}.cu")]


def test_header_edit_changes_library_path(csrc):
    """Editing the header changes the library path of each source that
    includes it, and of no other; editing a source changes only its own."""
    before = _paths()
    with open(csrc / HEADER, "a") as f:
        f.write("\n// edited\n")
    after = _paths()
    for name in INCLUDERS:
        assert after[name] != before[name], name
    for name in OTHERS:
        assert after[name] == before[name], name
    with open(csrc / "count_below_mma.cu", "a") as f:
        f.write("\n// edited\n")
    again = _paths()
    assert again["count_below_mma"] != after["count_below_mma"]
    assert {k: v for k, v in again.items() if k != "count_below_mma"} == {
        k: v for k, v in after.items() if k != "count_below_mma"}


def test_nested_header_is_hashed(csrc):
    """A header included by the shared header is part of the hash too."""
    with open(csrc / HEADER, "a") as f:
        f.write('\n#include "extra.cuh"\n')
    (csrc / "extra.cuh").write_text("// one\n")
    first = _build.library_path("count_below_mma")
    assert [os.path.basename(p) for p in _build.sources("count_below_mma")
            ] == ["count_below_mma.cu", HEADER, "extra.cuh"]
    (csrc / "extra.cuh").write_text("// two\n")
    assert _build.library_path("count_below_mma") != first


@pytest.fixture(scope="module")
def chip_tune():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_tune", os.path.join(root, "chip_tune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _forms(ct, part: str) -> list:
    """(source name, form, edits) of each form of a chip_tune.py part that
    edits the package's source ("bf16": K1-mma's bf16 forms)."""
    if part == "k4":
        return [("hamming_topk", v, ct.k4_edits(v)) for v in ct.K4_VARIANTS]
    if part == "k3":
        return [("band_count", v, ct.k3_edits(v)) for v in ct.K3_VARIANTS]
    if part == "k3run":
        return [("band_count", f, e) for f, e in ct.K3RUN_FORMS.items()]
    if part in ("mma", "bf16"):
        kind = "bf16" if part == "bf16" else "e4m3"
        return [("count_below_mma", f, e) for f, (e, types) in
                ct.MMA_FORMS.items() if kind in types]
    if part == "k5":
        return [("hamming_lanes_topk", f, e) for f, e in ct.K5_FORMS.items()]
    return [("color_scores", f, e) for f, e in ct.K6_VARIANTS.items()]


@pytest.mark.parametrize("part", ["k4", "k3", "k3run", "mma", "bf16", "k5",
                                  "k6"])
def test_chip_tune_forms_apply(chip_tune, part):
    """Every form of chip_tune.py's part finds the text it edits in the
    package's source (local headers inlined), and changes it unless each
    of its edits keeps its text (a part's first form: the source)."""
    forms = _forms(chip_tune, part)
    assert len(forms) > 1
    for name, form, edits in forms:
        plain = chip_tune.edited_source(name, ())
        assert '#include "' not in plain
        src = chip_tune.edited_source(name, edits)
        keeps = all(old == new for old, new in edits)
        assert (src == plain) == keeps, (part, form)
