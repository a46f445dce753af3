"""Index thumbnail writer — the save half of the reference's interactive
crop tool (CropWidget::setIndexThumbnail, src/gui/cropwidget.cpp:30-140):
crop a region out of a media image, scale it to <=1024 px on the longest
side, and write it to ``<root>/thumb.png`` (Database::thumbPath,
src/database.h:58) with a text comment recording provenance (path, crop
rect, frame, id, md5, dct) so the thumbnail can be re-cropped later and
external references can find the original.

The interactive rectangle selection lives in the browser (shift+drag in
the compare view, key ``t``); the CLI ``-video-thumbnail`` verb writes an
uncropped frame thumb headlessly (reference src/main.cpp:1790-1800).
"""

from __future__ import annotations

import io
import os

from PIL import Image
from PIL.PngImagePlugin import PngInfo

from .ioutil import write_file_atomically

MAX_SIDE = 1024
COMMENT_KEY = "Comment"


def read_thumb_comment(thumb_path: str) -> str:
    """Existing provenance comment of a thumbnail ('' if none) — the
    reference preserves it across re-crops (cropwidget.cpp:58-68)."""
    if not os.path.exists(thumb_path):
        return ""
    try:
        with Image.open(thumb_path) as im:
            return str(im.info.get(COMMENT_KEY, ""))
    except OSError:
        return ""


def build_comment(*, rel_path: str, crop: tuple[int, int, int, int],
                  frame: int | None = None, media=None) -> str:
    """Provenance lines matching the reference's UserComment fields
    (cropwidget.cpp:89-110)."""
    lines = ["cbird thumbnail", "version:1", f"path:{rel_path}",
             "crop:%d:%d:%d:%d" % crop]
    if frame is not None:
        lines.append(f"frame:{frame}")
    if media is not None:
        if getattr(media, "md5", ""):
            lines.append(f"id:{media.id}")
            lines.append(f"md5:{media.md5}")
        dct = int(getattr(media, "dctHash", 0) or 0)
        if dct:
            lines.append(f"dct:{dct:x}")
    return "\n".join(lines)


def save_index_thumb(root: str, image: Image.Image, *,
                     rel_path: str,
                     crop: tuple[int, int, int, int] | None = None,
                     frame: int | None = None, media=None) -> str:
    """Crop + scale ``image`` and atomically write ``<root>/thumb.png``.

    @param crop (x, y, w, h) in original image pixels; clamped to the
           image bounds; None keeps the full frame
    @return the thumbnail path
    @raises ValueError on an empty (fully out-of-bounds) crop
    """
    w0, h0 = image.size
    if crop is None:
        crop = (0, 0, w0, h0)
    x, y, w, h = (int(v) for v in crop)
    x0, y0 = max(0, min(x, w0)), max(0, min(y, h0))
    x1, y1 = max(0, min(x + w, w0)), max(0, min(y + h, h0))
    if x1 <= x0 or y1 <= y0:
        raise ValueError(f"empty crop {crop} for {w0}x{h0} image")
    out = image.crop((x0, y0, x1, y1))
    cw, ch = out.size
    if max(cw, ch) > MAX_SIDE:
        scale = MAX_SIDE / max(cw, ch)
        out = out.resize((max(1, round(cw * scale)),
                          max(1, round(ch * scale))), Image.LANCZOS)

    thumb_path = os.path.join(root, "thumb.png")
    # Preserve provenance only across re-crops of the SAME source — the
    # reference carries the comment on the media being cropped
    # (cropwidget.cpp:58-68), so a thumbnail replaced from a different
    # file must get a freshly built comment.
    comment = read_thumb_comment(thumb_path)
    if comment and f"path:{rel_path}" not in comment.splitlines():
        comment = ""
    if not comment:
        comment = build_comment(rel_path=rel_path,
                                crop=(x0, y0, x1 - x0, y1 - y0),
                                frame=frame, media=media)
    meta = PngInfo()
    meta.add_text(COMMENT_KEY, comment)
    buf = io.BytesIO()
    out.convert("RGB").save(buf, format="PNG", pnginfo=meta)
    write_file_atomically(thumb_path, buf.getvalue())
    return thumb_path
