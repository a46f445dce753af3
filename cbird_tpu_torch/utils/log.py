"""Console logging with color markup + progress-line compression.

Rebuild of the reference logger (src/qtutil.h:165-258):
severity colors, in-place progress lines, and the same environment switches
(CBIRD_FORCE_COLORS, CBIRD_NO_COLORS, CBIRD_LOG_TIMESTAMP,
CBIRD_CONSOLE_WIDTH; readme.md:177-191).
"""

from __future__ import annotations

import os
import shutil
import sys
import time

_LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3}
_verbosity = 1  # default: info+


def set_verbosity(level: str) -> None:
    global _verbosity
    _verbosity = _LEVELS.get(level, 1)


def _colors_enabled() -> bool:
    if os.environ.get("CBIRD_NO_COLORS"):
        return False
    if os.environ.get("CBIRD_FORCE_COLORS"):
        return True
    return sys.stderr.isatty()


def _console_width() -> int:
    w = os.environ.get("CBIRD_CONSOLE_WIDTH")
    if w and w.isdigit():
        return int(w)
    return shutil.get_terminal_size((100, 24)).columns


_COLOR = {"debug": "\x1b[90m", "info": "", "warn": "\x1b[33m", "error": "\x1b[31m"}
_RESET = "\x1b[0m"
_progress_active = False


def _emit(level: str, msg: str) -> None:
    global _progress_active
    if _LEVELS[level] < _verbosity:
        return
    if _progress_active:
        sys.stderr.write("\n")
        _progress_active = False
    ts = ""
    if os.environ.get("CBIRD_LOG_TIMESTAMP"):
        ts = time.strftime("[%H:%M:%S] ")
    if _colors_enabled() and _COLOR[level]:
        sys.stderr.write(f"{_COLOR[level]}{ts}{msg}{_RESET}\n")
    else:
        sys.stderr.write(f"{ts}{msg}\n")
    sys.stderr.flush()


def debug(msg: str) -> None:
    _emit("debug", msg)


def info(msg: str) -> None:
    _emit("info", msg)


def warn(msg: str) -> None:
    _emit("warn", msg)


def error(msg: str) -> None:
    _emit("error", msg)


class ProgressLogger:
    """Rate-limited in-place progress line, hidden unless the task is slow
    (reference ProgressLogger, src/qtutil.h:223-258)."""

    def __init__(self, fmt: str, total: int, min_interval: float = 0.1,
                 show_after: float = 0.5):
        self.fmt = fmt
        self.total = max(total, 1)
        self.min_interval = min_interval
        self.show_after = show_after
        self.start = time.monotonic()
        self.last = 0.0

    def step(self, current: int, *args) -> None:
        global _progress_active
        now = time.monotonic()
        if now - self.start < self.show_after:
            return
        if now - self.last < self.min_interval:
            return
        self.last = now
        pct = 100 * current // self.total
        msg = self.fmt.replace("%percent", f"{pct}%").replace(
            "%step", str(current))
        for n, a in enumerate(args, 1):
            msg = msg.replace(f"%{n}", str(a))
        width = _console_width()
        sys.stderr.write("\r" + msg[:width].ljust(min(len(msg) + 8, width)))
        sys.stderr.flush()
        _progress_active = True

    def end(self, current: int = -1, *args) -> None:
        global _progress_active
        if _progress_active:
            sys.stderr.write("\n")
            sys.stderr.flush()
            _progress_active = False


def progress_line(msg: str) -> None:
    global _progress_active
    width = _console_width()
    sys.stderr.write("\r" + msg[:width].ljust(min(len(msg) + 8, width)))
    sys.stderr.flush()
    _progress_active = True


import contextlib


def profile_mark(name: str) -> None:
    """Under CBIRD_PROFILE, log elapsed real time SINCE PROCESS START at a
    named point — attributes interpreter+import startup and the total
    process wall, which per-stage timers cannot see (VERDICT r04 #1: ~110 s
    of a 10M CLI -similar was unattributed)."""
    if not os.environ.get("CBIRD_PROFILE"):
        return
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        info(f"[profile] @{name}: {age * 1000:.0f} ms since process start")
    except (OSError, ValueError, IndexError):
        pass


@contextlib.contextmanager
def profile_stage(name: str):
    """Per-stage wall-time logging, enabled by CBIRD_PROFILE=1 (the
    reference's ad-hoc nanoTime() stage percentages, SURVEY.md §5)."""
    if not os.environ.get("CBIRD_PROFILE"):
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        info(f"[profile] {name}: {(time.monotonic() - t0) * 1000:.1f} ms")
