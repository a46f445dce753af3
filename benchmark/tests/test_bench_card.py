"""On a card: a short run of every cell, untraced and traced, through
run.py as a benchmark run starts it; each comes out correct with every metric
the manifest names for it."""

import json
import os
import subprocess
import sys

import pytest

from benchlib.manifest import Manifest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_runs_correct(card, trace):
    m = Manifest(ROOT)
    for i, c in enumerate(m.data["workloads"]):
        p = subprocess.run(
            [sys.executable, os.path.join("benchmark", "run.py"),
             "--workload", c["name"], "--seed", str(2**31 + 900 + i),
             "--seconds", "2", "--trace", str(trace)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-2000:]
        out = json.loads(p.stdout.splitlines()[-1])
        assert out["correct"], out["checks"]
        want = {e["name"] for e in m.metrics(c["name"], bool(trace))}
        assert set(out["metrics"]) == want, c["name"]
