"""A whole run of each cell on the CPU at a small size, past the look for
a card: sound, it comes out correct; with the timed path broken
underneath (an answer altered where the store produces it; half of a
request's needles, or of -similar's rows, left out), not correct."""

import time

import numpy as np
import pytest
import torch

from benchlib import cell
from benchlib.manifest import Manifest

from conftest import ROOT

SMALL = {
    "dct1m-similar": {"config": {"rows": 8000}, "traffic": {
        "planted_pairs": 300}},
    "color1m-similar-to": {"config": {"rows": 4096}, "traffic": {
        "pool": 256}},
}
SEED = (1 << 31) + 77


def _run(name, traced=False):
    return cell.run(Manifest(ROOT), name, SEED, 1.0, traced,
                    torch.device("cpu"), time.perf_counter(), SMALL[name])


def _break_search(monkeypatch, cls, fault):
    """Wraps ``cls.search`` (per needle (ids, values)) with ``fault``."""
    search = cls.search

    def broken(self, *args, **kwargs):
        out = list(search(self, *args, **kwargs))
        if fault == "half":
            return [o if i % 2 else (o[0][:0], o[1][:0])
                    for i, o in enumerate(out)]
        for i, (ids, vals) in enumerate(out):
            if len(ids):
                vals = vals.copy()
                vals[0] += 1
                out[i] = (ids, vals)
                break
        return out

    monkeypatch.setattr(cls, "search", broken)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("name", ["color1m-similar-to"])
def test_broken_query_is_not_correct(monkeypatch, name, fault):
    from cbird_tpu_torch.ops.color import PackedColorStore
    _break_search(monkeypatch, PackedColorStore, fault)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_broken_similar_is_not_correct(monkeypatch, fault):
    from cbird_tpu_torch.ops.hamming import PackedHashStore
    search_self = PackedHashStore.search_self

    def broken(self, *args, **kwargs):
        raw = search_self(self, *args, **kwargs)
        rows = sorted(raw)
        if fault == "half":
            return {r: raw[r] for r in rows[::2]}
        ids, d = raw[rows[0]]
        raw[rows[0]] = (ids, np.asarray(d) + 1)
        return raw

    monkeypatch.setattr(PackedHashStore, "search_self", broken)
    assert not _run("dct1m-similar")["correct"]


def test_traced_run_reads_the_per_layer_metrics():
    out = _run("color1m-similar-to", traced=True)
    assert out["correct"]
    assert {"index_ms.query", "db_ms.query"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_where_the_program_passes(name):
    """The control (the reference broken as ``benchmark/reference/``
    says) in the program's place fails the cell's limits; the program on
    the same sizes passes them."""
    import calibrate
    out = calibrate.calibrate(Manifest(ROOT), name, SEED, 1, 1, 1.0,
                              torch.device("cpu"), SMALL[name],
                              show=lambda line: None)
    limits = out["limits"]
    assert all(out["program_max"][k] <= limits[k] for k in limits)
    assert any(out["control_min"][k] > limits[k] for k in limits), out
