"""CSV accuracy harness (`-test-csv`) — regression testing for search recall.

Rebuild of the reference's in-binary test harness
(src/commands.cpp:1173, -test-csv): a CSV of
``needle,expected-match[,expected-match...]`` rows is queried against the
index with the current search parameters; results are written to
``match.csv`` next to the input and a pass/fail summary is printed.  This is
the tool for checking recall parity against the reference corpus.
"""

from __future__ import annotations

import csv
import os

from ..store.media import Media
from ..utils.log import info, warn


def run_test_csv(engine, params, csv_path: str,
                 truth: dict[str, set[str]] | None = None,
                 any_of: bool = False) -> dict:
    """@return {"rows": n, "pass": n_pass, "fail": n_fail,
                "precision": float, "recall": float}

    recall    = Σ|expected ∩ got| / Σ|expected|   (micro-averaged)
    precision = Σ|true ∩ got| / Σ|got| where true is ``truth[needle]``
                when given (ALL acceptable matches, e.g. every same-base
                sibling) else the row's expected set — so rows may list
                only the must-find files without extra hits counting as
                false positives.
    @param any_of a row passes when ANY member of its truth set is
           retrieved (duplicate-CLUSTER recall — used by the adversarial
           corpus where >maxMatches same-base siblings compete for slots);
           recall is then the pass rate"""
    root = engine.db.path()

    def resolve(p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(root, p)

    rows = []
    with open(csv_path, newline="") as f:
        for rec in csv.reader(f):
            rec = [c.strip() for c in rec if c.strip()]
            if not rec or rec[0].startswith("#"):
                continue
            rows.append(rec)

    out_path = os.path.join(os.path.dirname(os.path.abspath(csv_path)),
                            "match.csv")
    n_pass = n_fail = 0
    want_total = want_found = got_total = got_true = 0
    with open(out_path, "w", newline="") as out:
        w = csv.writer(out)
        w.writerow(["needle", "expected", "found", "result", "matches"])
        for rec in rows:
            needle_path = resolve(rec[0])
            expected = {os.path.basename(resolve(p)) for p in rec[1:]}
            needle = engine.db.media_with_path(needle_path)
            if not needle.is_valid():
                needle = Media(needle_path)
            matches = engine.query(needle, params)
            got = {os.path.basename(m.path) for m in matches}
            true_set = expected
            if truth is not None:
                true_set = truth.get(os.path.basename(needle_path), expected)
            if any_of and true_set:
                ok = bool(got & true_set)
                want_total += 1
                want_found += ok
            else:
                ok = expected <= got if expected else bool(got)
                want_total += len(expected)
                want_found += len(expected & got)
            n_pass += ok
            n_fail += not ok
            got_total += len(got)
            got_true += len(got & true_set)
            w.writerow([rec[0], ";".join(sorted(expected)),
                        ";".join(sorted(got)), "pass" if ok else "FAIL",
                        len(matches)])
            if not ok:
                warn(f"test-csv FAIL: {rec[0]} expected {sorted(expected)} "
                     f"got {sorted(got)}")
    recall = want_found / want_total if want_total else 1.0
    precision = got_true / got_total if got_total else 1.0
    info(f"test-csv: {n_pass}/{len(rows)} passed, recall {recall:.3f}, "
         f"precision {precision:.3f} -> {out_path}")
    return {"rows": len(rows), "pass": n_pass, "fail": n_fail,
            "precision": precision, "recall": recall}
