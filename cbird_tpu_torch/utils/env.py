"""Process/system environment helpers (reference src/env.h:35-48, src/cpu.h).

Memory queries read /proc (no psutil dependency); idle priority mirrors the
reference's Env::setIdleProcessPriority used during -update so indexing
doesn't starve the desktop (src/main.cpp:939)."""

from __future__ import annotations

import os


def system_memory() -> tuple[int, int]:
    """@return (total_bytes, available_bytes)."""
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        pass
    return total, avail


def process_memory() -> int:
    """Resident set size in bytes."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def set_idle_priority() -> bool:
    """Lower scheduling priority so batch indexing yields to interactive use."""
    try:
        os.nice(19)
        return True
    except OSError:
        return False
