"""``-similar`` of the dct index: the N^2 search, ``DctHashIndex.find_all``
at the configuration's threshold, as ``Database.similar`` calls it; a
request is one call, with no needles.

Each kept answer is held against ``benchmark/reference/dct.py``: every
row it lists, and a seeded sample of planted and uniform rows besides.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import data
from benchlib.manifest import part
from benchlib.traffic import Requests

ref = part("reference", "dct")
k3 = part("rooflines", "k3")


class Verb:
    def __init__(self, system, mix: dict, seed: int):
        self.system, self.mix = system, mix
        self.requests = Requests(mix, data.seed_of(seed))
        self._work: dict | None = None

    # ---- the timed path -----------------------------------------------------
    def issue(self, req):
        s = self.system
        return s.index.find_all(s.params)

    def instrument(self, spans) -> None:
        """Spans around the index's entry and the store's search."""
        s = self.system
        spans.wrap(s.index, "find_all", "index")
        spans.wrap(s.index._store, "search_self", "store")

    # ---- answers and work -------------------------------------------------------
    def compact(self, req, out) -> dict:
        """find_all's {row: (ids, dists)} -> {row: (store rows, dists)}."""
        _, raw = out
        return {int(r): (np.asarray(ids, np.int64) - 1,
                         np.asarray(d, np.int64)) for r, (ids, d) in
                raw.items()}

    def prepare_trace(self) -> None:
        """The work of a call, the same in every call (the index does not
        change): its hot rows, from one call made here, and K3's
        equal-key pairs, counted on the device."""
        s = self.system
        hot = sum(1 for r, (rows, _) in self.compact(None, self.issue(None))
                  .items() if (rows > r).any())
        self._work = {"n_rows": s.hashes.numel(), "n_valid": s.n_valid,
                      "k": s.k, "topk_needles": hot,
                      "k3_pairs": k3.equal_key_pairs(s.hashes, s.alive, s.t),
                      "k3_blocks": s.t}

    def work(self, req) -> list[dict]:
        """The call's work for the roofline counts."""
        return [self._work]

    # ---- the check -------------------------------------------------------------
    def check(self, kept: list, sample: dict, seed: int,
              control: bool = False) -> dict:
        """@param kept (request, answer) pairs drawn from the window, each
               answer as ``compact`` gives it
        @param sample ``planted`` and ``uniform`` rows to check besides
               every row the answers list
        @param control judge the control's answers in the program's place
        @return {"wrong_lists": count}"""
        s = self.system
        store = ref.pm1_store(s.hashes)
        wrong = 0
        for _, out in kept:
            rng = np.random.default_rng([data.seed_of(seed), 7])
            planted = s.planted.cpu().numpy()
            got = {} if control else out
            rows = np.union1d(np.fromiter(got, np.int64, len(got)),
                              np.concatenate([
                                  rng.choice(planted, min(
                                      sample["planted"], len(planted)),
                                      replace=False),
                                  rng.integers(0, s.hashes.numel(),
                                               sample["uniform"])]))
            want = ref.similar_rows(store, s.hashes, s.alive, rows, s.t, s.k)
            if control:
                kept_rows = np.fromiter(want, np.int64, len(want))
                lists = ref.control(s.hashes[torch.as_tensor(
                    kept_rows, device=s.device)], s.hashes,
                    [want[r] for r in kept_rows])
                got = {int(r): v for r, v in zip(kept_rows, lists)
                       if len(v[0]) >= 2}
            empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
            wrong += ref.wrong_lists([got.get(int(r), empty) for r in rows],
                                     [want.get(int(r), empty) for r in rows])
        return {"wrong_lists": wrong}
