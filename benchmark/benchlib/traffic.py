"""The general generator: a traffic mix's parameters -> requests.

A mix (``benchmark/traffic/<mix>.json``) is data:

- ``verb``: the verb file ``benchmark/verbs/<index>.<verb>.py`` that sends
  the requests through the program's entry (``similar-to``: needles;
  ``similar``: the N^2 search, no needles);
- ``loop``: the loop file ``benchmark/loops/<loop>.py`` that decides when
  each request is sent, with its own parameters (``closed``: ``clients``);
- ``needles``: needles a request;
- ``copy_share``: the share of a request's needles drawn from the pool of
  copies of stored rows; the rest come from the pool of distractors
  (fresh data, no stored original).  The count is fixed: round(share x
  needles) every request;
- ``pool``: entries in each pool, made once in set-up by the verb from
  the seed (a request's needles are drawn with replacement
  from them: the port caches no answer, so a needle drawn twice costs
  what a new one does);
- the adapter's own parameters: how a copy differs from its original
  (``flips`` for hashes, ``jitter`` for color descriptors) and how many
  near-duplicate pairs the store holds (``planted_pairs``,
  ``planted_flips``).

Request i of stream s draws from ``numpy.random.default_rng([seed, s,
i])``: the same seed gives the same requests in the same order, and every
request the same number of copies and distractors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

WINDOW, WARM, TRACE_WARM, TRACE = range(4)  # request streams


@dataclasses.dataclass
class Request:
    sel: np.ndarray | None  # pool entries of the needles, in order
    items: list | None      # the needles as the index takes them
    size: int               # needles answered (1 for a -similar call)


class Requests:
    def __init__(self, mix: dict, seed: int, pool_items: list | None = None,
                 copies: int = 0):
        """@param pool_items the needles of both pools as the index takes
               them, copies first, made once in set-up: building a
               request is then a list of references, so the window's time
               and the garbage collector's work are the program's
        @param copies how many of ``pool_items`` are copies"""
        self.mix = mix
        self.seed = seed
        self.items = pool_items
        self.copies = copies

    def request(self, stream: int, i: int) -> Request:
        if self.items is None:
            return Request(None, None, 1)
        rng = np.random.default_rng([self.seed, stream, i])
        n = self.mix["needles"]
        n_copy = round(self.mix["copy_share"] * n)
        parts = [rng.integers(0, self.copies, n_copy)]
        if n > n_copy:
            parts.append(rng.integers(self.copies, len(self.items),
                                      n - n_copy))
        sel = np.concatenate(parts)
        sel = sel[rng.permutation(n)]
        return Request(sel, [self.items[j] for j in sel], n)
