"""The benchmark's own tests: the reference, the roofline counts, the
checks' controls and faults on the CPU at small sizes; tests marked
``cuda`` run the harness on a card and skip without one.

    python -m pytest benchmark/tests -q            # CPU
    python -m pytest benchmark/tests -q -m cuda    # on a card
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    """A CUDA device, or a skip (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
