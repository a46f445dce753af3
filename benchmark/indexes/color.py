"""The color index (``-p.alg color``, ``ColorDescIndex``) under the
benchmark: the data and the index; the verbs
(``benchmark/verbs/color.<verb>.py``) send the requests and check the
answers.

Set-up, from the seed, on the device in a few large calls: ``rows``
quantized descriptors [33, 4] uint16: uniform random l, u, v codes, the
weights descending from 65535 to 2000, the color count drawn from
``num_colors_hist`` ({count: weight}).  The index is filled through its
own load path: a collection (``benchlib/collection.py``; its ``media``
table only where the verb reads it) whose ``color`` table holds the
descriptors, loaded by ``Database.load_index`` as the CLI loads a
collection.  Media ids are store row + 1.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchlib import data
from benchlib.collection import Collection
from cbird_tpu_torch.index.color_desc_index import ColorDescIndex
from cbird_tpu_torch.params import SearchParams

NUM_COLORS = 32
U16 = 65535


def descriptors(colors: torch.Tensor, counts: torch.Tensor) -> np.ndarray:
    """[n, 32, 3] codes and [n] counts -> [n, 33, 4] uint16."""
    n = colors.shape[0]
    out = np.zeros((n, NUM_COLORS + 1, 4), np.uint16)
    out[:, :NUM_COLORS, :3] = colors.cpu().numpy()
    out[:, :NUM_COLORS, 3] = np.linspace(U16, 2000, NUM_COLORS).astype(
        np.uint16)
    out[:, NUM_COLORS, 0] = counts.cpu().numpy()
    return out


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
        self.params.algo = ColorDescIndex.id
        for key, value in cfg["params"].items():
            setattr(self.params, key, value)
        self.k = max(self.params.maxMatches * 4, 64)  # the index's own k
        self.g = g = data.generator(seed, device)
        n = cfg["rows"]
        hist = cfg["num_colors_hist"]
        keys = torch.tensor([int(c) for c in hist], device=device)
        weights = torch.tensor([float(w) for w in hist.values()],
                               device=device)
        self.colors = torch.randint(0, U16 + 1, (n, NUM_COLORS, 3),
                                    generator=g, device=device,
                                    dtype=torch.int32)
        self.counts = keys[torch.multinomial(weights, n, replacement=True,
                                             generator=g)]
        descs = descriptors(self.colors, self.counts)
        mark("data")
        self.collection = Collection(ColorDescIndex(device))
        if media_table:
            self.collection.add_media(n)
        with Collection.bulk(self.collection.connect_index()) as conn:
            conn.executemany(
                "insert into color (media_id, color_desc) values (?,?)",
                ((i + 1, descs[i].tobytes()) for i in range(n)))
        del descs
        mark("collection")
        self.index = self.collection.load(self.params)
        if self.index.count() != n:
            raise RuntimeError("the index did not load every descriptor")
        mark("index load")

    def free(self) -> None:
        """Drops the collection, the index and its device arrays."""
        self.collection.close()
        self.collection = self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
