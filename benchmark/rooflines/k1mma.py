"""K1-mma, the count gate (``wgmma_count_kernel``): every needle of a
request against every live row of the store.

Operations: one Hamming pair (``hamming.py``) per needle and live row.
Bytes: a live row's 8-byte hash and every row's validity byte, a needle's
8 bytes and its 4-byte count.
"""

from benchlib.manifest import part

hamming = part("rooflines", "hamming")

KERNEL = "wgmma_count_kernel"
NEEDLES = "gate_needles"


def least_s(rec: dict):
    """@param rec one call's work: ``gate_needles``, ``n_valid``,
    ``n_rows``; @return seconds, or None when the call counts nothing"""
    q = rec.get(NEEDLES, 0)
    if not q:
        return None
    nbytes = 8 * rec["n_valid"] + rec["n_rows"] + 12 * q
    return hamming.least_s(q * rec["n_valid"], nbytes)
