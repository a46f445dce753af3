"""The dct index (``-p.alg dct``, ``DctHashIndex``) under the benchmark:
the data and the index; the verbs (``benchmark/verbs/dct.<verb>.py``)
send the requests and check the answers.

Set-up, from the seed, on the device in a few large calls: ``rows``
random 64-bit hashes; ``planted_pairs`` pairs of distinct rows where the
second is the first with ``planted_flips`` bits flipped; a
``tombstone_share`` of the other rows removed.  The index is filled
through its own load path: a collection (``benchlib/collection.py``;
its ``media`` table only where the verb reads it) whose sidecar cache
(``index/cache.py``) holds the arrays, loaded by ``Database.load_index``
as ``-similar`` loads a large collection, then ``remove`` tombstones the
dead rows.  Media ids are store row + 1.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchlib import data
from benchlib.collection import Collection
from cbird_tpu_torch.index.cache import save_cache
from cbird_tpu_torch.index.dct_hash_index import DctHashIndex
from cbird_tpu_torch.params import SearchParams


def u64(h: torch.Tensor) -> np.ndarray:
    return h.cpu().numpy().view(np.uint64)


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device, mark=lambda what: None,
                 media_table: bool = False):
        """@param mark called with the name of each part of the set-up as
               it ends
        @param media_table fill the collection's ``media`` table (a verb
               through ``Database`` reads it)"""
        self.cfg, self.mix, self.device = cfg, mix, device
        self.params = SearchParams()
        self.params.algo = DctHashIndex.id
        for key, value in cfg["params"].items():
            setattr(self.params, key, value)
        self.t = self.params.dctThresh
        self.k = max(self.params.maxMatches * 4, 64)  # the index's own k
        self.g = g = data.generator(seed, device)
        n = cfg["rows"]
        h = data.random_words(n, g, device)
        perm = torch.randperm(n, generator=g, device=device)
        pairs = mix.get("planted_pairs", 0)
        self.planted = perm[:2 * pairs]
        lo, hi = mix.get("planted_flips", (1, 4))
        h[perm[pairs:2 * pairs]] = h[perm[:pairs]] ^ data.flip_masks(
            pairs, lo, hi, g, device)
        dead = perm[2 * pairs:2 * pairs + round(n * cfg["tombstone_share"])]
        self.alive = torch.ones(n, dtype=torch.bool, device=device)
        self.alive[dead] = False
        self.hashes = h  # the benchmark's own copy: the reference reads it
        self.n_valid = n - dead.numel()
        mark("data")
        self.collection = Collection(DctHashIndex(device))
        hashes = u64(h)
        if media_table:
            self.collection.add_media(n, hashes)
        save_cache(self.collection.db.cache_path(), "dcthash",
                   ids=np.arange(1, n + 1, dtype=np.uint32), hashes=hashes)
        self.index = self.collection.load(self.params)
        if self.index.count() != n:
            raise RuntimeError("the index did not load its sidecar cache")
        mark("index load")
        self.index.remove((dead + 1).cpu().numpy().astype(np.uint32))
        mark("tombstones")

    def free(self) -> None:
        """Drops the collection, the index and its device arrays."""
        self.collection.close()
        self.collection = self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
