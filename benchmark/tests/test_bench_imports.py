"""Nothing the benchmark loads is JAX or the JAX package, by whole
top-level name (the port's name begins with the JAX package's, so a
prefix test would be wrong), and the references load nothing of the
port.  Each in a fresh interpreter, so no other test's imports count."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "cbird_tpu"}

HARNESS = f"""
import json, sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
from benchlib import cell, manifest
m = manifest.Manifest({ROOT!r})
for c in m.data["configs"]:
    cfg = m.config(c["name"])
    manifest.part("indexes", cfg["index"])
    manifest.part("reference", cfg["index"])
for w in m.data["workloads"]:
    mix = m.traffic(w["traffic"])
    index = m.config(w["config"])["index"]
    manifest.part("verbs", index + "." + mix["verb"])
    manifest.part("loops", mix["loop"])
for kind in ("end_to_end", "per_layer"):
    for e in m.data[kind]:
        manifest.part("metrics", e["name"])
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""

REFERENCE = f"""
import json, sys
sys.path[:0] = [{BENCH!r}]
from benchlib.manifest import part
for name in ("dct", "color"):
    part("reference", name)
for name in ("peaks", "hamming", "k1mma", "k3", "k4", "k6"):
    part("rooflines", name)
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert "cbird_tpu_torch" in names  # the port is what it runs
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_references_load_nothing_of_the_port():
    names = _top_level(REFERENCE)
    assert not names & (FORBIDDEN | {"cbird_tpu_torch"})


def test_forbidden_check_compares_whole_names():
    from benchlib.cell import FORBIDDEN as CHECKED, forbidden_modules
    assert set(CHECKED) == FORBIDDEN
    assert "cbird_tpu_torch" not in forbidden_modules()
