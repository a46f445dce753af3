"""Static HTML dedup report — the headless stand-in for the reference GUI.

The reference's MediaGroupListWidget (src/gui/, ~6k LoC of
Qt) shows paged match groups with thumbnails, scores and actions.  A TPU
deployment is headless, so `-show` here renders the current result to a
self-contained HTML file (inline base64 thumbnails, per-item metadata,
needle highlighted, weeds flagged) that any browser can open.
"""

from __future__ import annotations

import base64
import html
import io

from ..store.media import Media, MediaGroupList
from ..utils.log import info

_THUMB = 256

_CSS = """
body { background:#1e1e24; color:#ddd; font-family:sans-serif; margin:1em; }
.group { border:1px solid #444; border-radius:8px; margin:1em 0; padding:.6em; }
.items { display:flex; flex-wrap:wrap; gap:.8em; }
.item { background:#2a2a33; border-radius:6px; padding:.5em; max-width:280px; }
.item.needle { outline:2px solid #4a9; }
.item.weed { outline:2px solid #a44; }
.item img { max-width:256px; max-height:256px; display:block; }
.meta { font-size:.75em; color:#aaa; word-break:break-all; }
.score { color:#4a9; font-weight:bold; }
h1 { font-size:1.2em; }
"""


def _thumb_b64(m: Media) -> str | None:
    try:
        from ..host.scanner import read_bytes
        from PIL import Image
        if m.type == Media.TypeVideo:
            from ..host.video import backend_for
            be = backend_for(m.path)
            if be is None:
                return None
            frame = next(iter(be.frames(m.path, max_side=_THUMB)), None)
            if frame is None:
                return None
            img = Image.fromarray(frame)
        else:
            img = Image.open(io.BytesIO(read_bytes(m.path)))
            img.thumbnail((_THUMB, _THUMB))
            img = img.convert("RGB")
        buf = io.BytesIO()
        img.convert("RGB").save(buf, "JPEG", quality=80)
        return base64.b64encode(buf.getvalue()).decode()
    except Exception:  # noqa: BLE001 — thumbnails are best-effort
        return None


def write_report(groups: MediaGroupList, out_path: str, title: str = "cbird results") -> str:
    parts = [f"<!doctype html><html><head><meta charset='utf-8'>"
             f"<title>{html.escape(title)}</title><style>{_CSS}</style></head><body>"]
    parts.append(f"<h1>{html.escape(title)} — {len(groups)} groups</h1>")
    for n, group in enumerate(groups):
        if not group:
            continue
        parts.append(f"<div class='group'><div>group {n} ({len(group)} items)</div>"
                     f"<div class='items'>")
        for j, m in enumerate(group):
            classes = ["item"]
            if j == 0:
                classes.append("needle")
            if m.isWeed:
                classes.append("weed")
            parts.append(f"<div class='{' '.join(classes)}'>")
            b64 = _thumb_b64(m)
            if b64:
                parts.append(f"<img src='data:image/jpeg;base64,{b64}'>")
            score = f"<span class='score'>score {m.score}</span>" if m.score >= 0 else ""
            rng = ""
            if m.matchRange.is_valid():
                rng = f" frames {m.matchRange.srcIn}→{m.matchRange.dstIn}+{m.matchRange.len}"
            dims = f"{m.width}×{m.height}" if m.width > 0 else ""
            parts.append(
                f"<div class='meta'>{html.escape(m.path)}<br>"
                f"{dims} {score}{rng}{' WEED' if m.isWeed else ''}</div></div>")
        parts.append("</div></div>")
    parts.append("</body></html>")
    with open(out_path, "w") as f:
        f.write("".join(parts))
    info(f"report written: {out_path}")
    return out_path
