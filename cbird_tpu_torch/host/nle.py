"""Non-linear-editor project export (kdenlive/MLT XML).

Headless rebuild of the reference's KdenEdit + VideoCompareWidget
"compare in kdenlive" action (src/nleutil.cpp:200-359,
src/gui/videocomparewidget.cpp:723-743): build an MLT project with one
video track per input, each clip cued to its temporally aligned in-frame,
so both videos can be scrubbed in sync in kdenlive/melt.

The reference patches a bundled template project via QDomDocument; here
the (small) MLT document is generated directly — same producers/tracks/
blank+clip structure, no Qt resource dependency.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

TEMPLATE_FPS = 29.97  # the reference template's profile (videocomparewidget.cpp:724)
LEAD_BLANK = 150      # frames of leader before both clips (nleutil addBlank)
CLIP_LEN = 300        # exported excerpt length in template frames


def _prop(parent: ET.Element, name: str, value) -> ET.Element:
    el = ET.SubElement(parent, "property", {"name": name})
    el.text = str(value)
    return el


class KdenEdit:
    """Minimal MLT/kdenlive project writer: producers, tracks, blanks,
    clips (reference KdenEdit, src/nleutil.cpp:200-359)."""

    def __init__(self, fps: float = TEMPLATE_FPS):
        self.fps = fps
        self._root = ET.Element("mlt", {
            "LC_NUMERIC": "C", "version": "7.0.0", "producer": "main_bin",
            "profile": "cbird_compare",
        })
        ET.SubElement(self._root, "profile", {
            "description": "cbird compare", "width": "1920", "height": "1080",
            "progressive": "1", "sample_aspect_num": "1", "sample_aspect_den": "1",
            "display_aspect_num": "16", "display_aspect_den": "9",
            "frame_rate_num": str(int(round(fps * 1000))),
            "frame_rate_den": "1000", "colorspace": "709",
        })
        self._producers: list[str] = []
        self._tracks: dict[str, ET.Element] = {}
        self._track_order: list[str] = []

    def add_producer(self, path: str) -> int:
        """@return producer index for ``path`` (reused if already added)."""
        pid = f"producer{len(self._producers)}"
        prod = ET.SubElement(self._root, "producer", {"id": pid})
        _prop(prod, "resource", path)
        _prop(prod, "mlt_service", "avformat")
        self._producers.append(pid)
        return len(self._producers) - 1

    def add_track(self, name: str) -> None:
        pl = ET.SubElement(self._root, "playlist",
                           {"id": f"playlist{len(self._tracks)}"})
        _prop(pl, "kdenlive:track_name", name)
        self._tracks[name] = pl
        self._track_order.append(name)

    def add_blank(self, track: str, length: int) -> None:
        ET.SubElement(self._tracks[track], "blank", {"length": str(int(length))})

    def add_clip(self, track: str, producer: int, in_frame: int,
                 out_frame: int) -> None:
        ET.SubElement(self._tracks[track], "entry", {
            "producer": self._producers[producer],
            "in": str(max(0, int(in_frame))), "out": str(int(out_frame)),
        })

    def save_xml(self, path: str) -> None:
        tractor = ET.SubElement(self._root, "tractor", {"id": "tractor0"})
        for name in self._track_order:
            ET.SubElement(tractor, "track",
                          {"producer": self._tracks[name].get("id")})
        tree = ET.ElementTree(self._root)
        ET.indent(tree)
        tree.write(path, xml_declaration=True, encoding="unicode")


def export_compare(path_a: str, path_b: str, in_a: int, in_b: int,
                   fps_a: float, fps_b: float, out_path: str) -> None:
    """Two-track aligned compare project: clip k starts at its native
    aligned frame, rescaled to the template fps like the reference
    (videocomparewidget.cpp:728-738)."""
    edit = KdenEdit()
    for i, (path, native_in, fps) in enumerate(
            ((path_a, in_a, fps_a), (path_b, in_b, fps_b))):
        tmpl_in = int(native_in * TEMPLATE_FPS / max(fps, 1e-6))
        p = edit.add_producer(path)
        track = f"Video {i + 1}"
        edit.add_track(track)
        edit.add_blank(track, LEAD_BLANK)
        edit.add_clip(track, p, tmpl_in, tmpl_in + CLIP_LEN)
    edit.save_xml(out_path)
