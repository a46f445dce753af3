"""BENCHMARK.json and the files it names, found by name.

- a cell: its entry in ``workloads`` and ``benchmark/workloads/<cell>.json``
  (the check's sample and the limits of the numbers it compares);
- a configuration: its entry in ``configs`` and the file the entry names
  (``benchmark/configs/<name>.json``), whose ``index`` names the adapter
  ``benchmark/indexes/<index>.py`` and the plain reference
  ``benchmark/reference/<index>.py``;
- a traffic mix: ``benchmark/traffic/<mix>.json``, parameters that
  ``benchlib/traffic.py`` reads;
- a metric: its entry in ``end_to_end`` or ``per_layer`` and its reader
  ``benchmark/metrics/<name>.py``;
- a roofline count: ``benchmark/rooflines/<name>.py``.

Adding a cell, a configuration of an existing index, a mix or a metric
adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

# the benchmark's folder (this package's parent)
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_parts: dict = {}


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def part(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module, loaded once (kind:
    indexes, reference, rooflines, metrics; metric files carry dots in
    their names, so every part is loaded by path)."""
    key = (kind, name)
    if key not in _parts:
        path = os.path.join(BENCH_DIR, kind, f"{name}.py")
        mod_name = f"benchlib_{kind}_{name}".replace(".", "_").replace(
            "-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _parts[key] = mod
    return _parts[key]


class Manifest:
    def __init__(self, root: str):
        self.root = root
        self.data = _json(os.path.join(root, "BENCHMARK.json"))

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def cell(self, name: str) -> dict:
        """The ``workloads`` entry, with the cell file's keys added."""
        out = dict(self._named("workloads", name))
        out.update(_json(os.path.join(BENCH_DIR, "workloads",
                                      f"{name}.json")))
        return out

    def config(self, name: str) -> dict:
        entry = self._named("configs", name)
        out = _json(os.path.join(self.root, entry["file"]))
        out.update(name=name, source=entry["source"])
        return out

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))

    def metrics(self, cell: str, per_layer: bool) -> list[dict]:
        """The metrics the cell reports: an entry with ``workloads`` in
        the cells it lists; a per-layer one without, in every cell that
        reports the end-to-end metric it moves; an end-to-end one
        without, in every cell."""
        e2e = [m for m in self.data["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not per_layer:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in names
                                 else [])]

