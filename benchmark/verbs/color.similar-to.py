"""``-similar-to`` of the color index through the verb's own entry,
``Database.similar_to``, one call a needle, as the CLI's ``-similar-to``
sends each needle: the index's ``find`` (``find_batch`` of one needle),
the matches sorted and cut to ``maxMatches``, each match's media read
from the collection's ``media`` table and its descriptor from the index.
A request is one ``-similar-to`` of ``needles`` needles, answered when
the last needle's group is in hand.

Needles: a pool of copies of stored rows, each l, u, v code moved by a
uniform integer in [-jitter, jitter] (clipped), the count and weights
kept; each a media without an id, as a file that is not in the
collection.

Each kept answer is held against ``benchmark/reference/color.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import data
from benchlib.manifest import part
from benchlib.traffic import Requests
from cbird_tpu_torch.store.media import Media

ref = part("reference", "color")
k6 = part("rooflines", "k6")
color = part("indexes", "color")

MEDIA_TABLE = True  # the groups' media are read from the collection


class Verb:
    def __init__(self, system, mix: dict, seed: int):
        if mix["copy_share"] != 1:
            raise ValueError("color -similar-to mixes: copies only")
        self.system, self.mix = system, mix
        s, g = system, system.g
        size = mix["pool"]
        src = torch.randint(0, s.colors.shape[0], (size,), generator=g,
                            device=s.device)
        j = mix["jitter"]
        jit = torch.randint(-j, j + 1, (size, color.NUM_COLORS, 3),
                            generator=g, device=s.device, dtype=torch.int32)
        self.pool_colors = torch.clamp(s.colors[src] + jit, 0, color.U16)
        self.pool_counts = s.counts[src]
        self.pool_counts_host = self.pool_counts.cpu().numpy()
        items = []
        for d in color.descriptors(self.pool_colors, self.pool_counts):
            m = Media()
            m.colorDescriptor = d
            items.append(m)
        self.requests = Requests(mix, data.seed_of(seed), items, size)
        self.db = s.collection.db
        self._row_counts: np.ndarray | None = None
        self._by_count: dict[int, dict] = {}

    # ---- the timed path -----------------------------------------------------
    def issue(self, req) -> list:
        db, params = self.db, self.system.params
        return [db.similar_to(m, params) for m in req.items]

    def instrument(self, spans) -> None:
        """Spans around the verb's entry, the index's search and the
        store's."""
        s = self.system
        spans.wrap(self.db, "similar_to", "database")
        spans.wrap(s.index, "find_batch", "index")
        spans.wrap(s.index._store, "search", "store")

    # ---- answers and work -------------------------------------------------------
    def compact(self, req, out) -> list:
        """Each needle's group -> (store rows, integer scores)."""
        return [(np.fromiter((m.id - 1 for m in grp), np.int64, len(grp)),
                 np.fromiter((m.score for m in grp), np.int64, len(grp)))
                for grp in out]

    def prepare_trace(self) -> None:
        """The rows' color counts, which every call's work reads."""
        self._row_counts = self.system.counts.cpu().numpy()

    def work(self, req) -> list[dict]:
        """The request's K6 launches (one a needle) for the roofline
        counts; a launch's work hangs on the needle's color count alone."""
        out = []
        for x in self.pool_counts_host[req.sel].tolist():
            if x not in self._by_count:
                ops, nbytes = k6.work([x], self._row_counts)
                self._by_count[x] = {"k6_instructions": ops,
                                     "k6_bytes": nbytes}
            out.append(self._by_count[x])
        return out

    # ---- the check -------------------------------------------------------------
    def check(self, kept: list, sample: dict, seed: int,
              control: bool = False) -> dict:
        """@param kept (request, answer) pairs drawn from the window, each
               answer as ``compact`` gives it
        @param control judge the control (the reference in bfloat16) in
               the program's place
        @return {"rank_gap": ..., "score_err": ...}"""
        s = self.system
        k = s.params.maxMatches
        h_colors = ref.dequantize(s.colors)
        valid = torch.ones_like(s.counts, dtype=torch.bool)
        out = {"rank_gap": 0.0, "score_err": 0.0}
        for req, answer in kept:
            sel = torch.as_tensor(req.sel, device=s.device)
            n_colors = ref.dequantize(self.pool_colors[sel])
            n_counts = self.pool_counts[sel]
            sc = ref.scores(n_colors, n_counts, h_colors, s.counts, valid)
            if control:
                low = ref.scores(n_colors, n_counts, h_colors, s.counts,
                                 valid, dtype=torch.bfloat16)
                got = [(rows, np.floor(v).astype(np.int64))
                       for rows, v in ref.best(low, k)]
            else:
                got = answer
            for key, value in ref.gaps(sc, got, k).items():
                out[key] = max(out[key], value)
        return out
