"""K4, the exact top-k below the threshold (``topk_scan``): each needle
that reaches the top-k against every live row of the store.

Operations: one Hamming pair (``hamming.py``) per needle and live row.
Bytes, each input read once and each output written once: a live row's
8-byte hash and every row's validity byte, a needle's 8 bytes, and the
[Q, k] distances and rows (4 + 4 bytes a slot).
"""

from benchlib.manifest import part

hamming = part("rooflines", "hamming")

KERNEL = "topk_scan"
NEEDLES = "topk_needles"


def least_s(rec: dict):
    """@param rec one call's work: ``topk_needles``, ``n_valid``,
    ``n_rows``, ``k``; @return seconds, or None when the call needs no
    top-k"""
    q = rec.get(NEEDLES, 0)
    if not q:
        return None
    nbytes = 8 * rec["n_valid"] + rec["n_rows"] + 8 * q + 8 * q * rec["k"]
    return hamming.least_s(q * rec["n_valid"], nbytes)
