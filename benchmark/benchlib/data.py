"""Seeded data on the device, in a few large calls."""

from __future__ import annotations

import torch

BITS = 64


def seed_of(seed: int) -> int:
    """A ``--seed`` as torch's generator takes it (any whole number)."""
    return seed % (1 << 64)


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed))


def random_words(n: int, g: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """[n] int64 with every one of the 64 bits uniform."""
    lo = torch.randint(0, 1 << 32, (n,), generator=g, device=device,
                       dtype=torch.int64)
    hi = torch.randint(-(1 << 31), 1 << 31, (n,), generator=g,
                       device=device, dtype=torch.int64)
    return hi * (1 << 32) + lo  # in range: no overflow


def flip_masks(n: int, lo: int, hi: int, g: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """[n] int64 masks, each with a uniform number in [lo, hi] of distinct
    random bits set."""
    bits = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    order = torch.rand((n, BITS), generator=g, device=device).argsort(dim=1)
    one = torch.tensor([(1 << b) - (1 << 64) if b == 63 else 1 << b
                        for b in range(BITS)], dtype=torch.int64,
                       device=device)
    mask = torch.zeros(n, dtype=torch.int64, device=device)
    for j in range(hi):
        mask |= torch.where(bits > j, one[order[:, j]], 0)
    return mask
