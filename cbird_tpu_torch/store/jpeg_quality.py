"""JPEG quality estimation from quantization tables (DQT markers).

Rebuild of the reference's Hacker-Factor-derived estimator
(src/lib/jpegquality.{h,cpp}): parse DQT segments from the
jpeg byte stream and invert the IJG quality→table scaling against the
standard Annex K luminance/chrominance tables.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

# ITU T.81 Annex K reference tables (zig-zag order irrelevant for averages)
_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    dtype=np.float64)
_STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    dtype=np.float64)


def parse_dqt_tables(data: bytes) -> dict[int, np.ndarray]:
    """@return table id -> 64 quantization values (walks all DQT segments)."""
    tables: dict[int, np.ndarray] = {}
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return tables
    i = 2
    n = len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            i += 1
            continue
        code = data[i + 1]
        if code == 0xD8 or (0xD0 <= code <= 0xD7) or code == 0x01:
            i += 2
            continue
        if code == 0xD9 or code == 0xDA:  # EOI / SOS: quant tables all seen
            break
        if i + 4 > n:
            break
        seg_len = struct.unpack(">H", data[i + 2:i + 4])[0]
        if code == 0xDB:  # DQT
            j = i + 4
            end = i + 2 + seg_len
            while j < min(end, n):
                pq_tq = data[j]
                precision = pq_tq >> 4  # 0: 8-bit, 1: 16-bit
                table_id = pq_tq & 0x0F
                j += 1
                count = 64 * (2 if precision else 1)
                if j + count > n:
                    break
                if precision:
                    vals = np.frombuffer(data[j:j + 128], dtype=">u2").astype(np.float64)
                else:
                    vals = np.frombuffer(data[j:j + 64], dtype=np.uint8).astype(np.float64)
                tables[table_id] = vals
                j += count
        i += 2 + seg_len
    return tables


def _scale_to_quality(scale_pct: float) -> float:
    """Invert the IJG scaling: scale = q<50 ? 5000/q : 200-2q."""
    if scale_pct <= 0:
        return 100.0
    if scale_pct < 100:
        return (200.0 - scale_pct) / 2.0
    return 5000.0 / scale_pct


def estimate_jpeg_quality(data: bytes) -> Optional[int]:
    """@return estimated encoder quality 1..100, or None if not a jpeg /
    no quantization tables present."""
    tables = parse_dqt_tables(data)
    if not tables:
        return None
    estimates = []
    for tid, vals in tables.items():
        std = _STD_LUMA if tid == 0 else _STD_CHROMA
        if len(vals) != 64:
            continue
        # per-coefficient implied scale, averaged (robust to clamping at 1/255)
        scale = 100.0 * np.mean(vals / std)
        estimates.append(_scale_to_quality(scale))
    if not estimates:
        return None
    return int(round(max(1.0, min(100.0, float(np.mean(estimates))))))
