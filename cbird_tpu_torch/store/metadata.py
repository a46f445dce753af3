"""Embedded metadata readers: EXIF / IPTC / XMP / PNG text / ffmeta.

Rebuild of Media::readEmbeddedMetadata (src/media.cpp:
1627-1760) and VideoContext::readMetaData.  The reference uses Exiv2 and
exposes Exiv2-style dotted keys (``Exif.Image.Model``,
``Exif.Photo.DateTimeOriginal``, ``Iptc.Application2.Keywords``,
``Xmp.dc.subject``); property expressions take a comma-separated key list
and the first non-empty value wins.  This implementation reads the same
namespaces from PIL (EXIF IFDs, IPTC records, the raw XMP packet, PNG text
chunks) and ffprobe (container metadata), emitting the same key names so
CLI expressions are portable between the two programs.

Values for keys containing "Date" are normalised from the EXIF
``YYYY:MM:DD HH:MM:SS`` form to ISO ``YYYY-MM-DDTHH:MM:SS`` (the reference
converts them to QDateTime, media.cpp:1692-1694).
"""

from __future__ import annotations

import io
import re
import threading
from typing import Any, Optional

_cache: dict[str, Any] = {}
_cache_lock = threading.Lock()

_DATE_RE = re.compile(r"^(\d{4}):(\d{2}):(\d{2})[ T](\d{2}:\d{2}:\d{2})")

# IPTC record 2 (Application2) dataset number → Exiv2 tag name
_IPTC_APP2 = {
    0: "RecordVersion", 5: "ObjectName", 10: "Urgency", 15: "Category",
    20: "SuppCategory", 25: "Keywords", 30: "ReleaseDate", 35: "ReleaseTime",
    40: "SpecialInstructions", 55: "DateCreated", 60: "TimeCreated",
    65: "Program", 70: "ProgramVersion", 80: "Byline", 85: "BylineTitle",
    90: "City", 92: "SubLocation", 95: "ProvinceState", 100: "CountryCode",
    101: "CountryName", 103: "TransmissionReference", 105: "Headline",
    110: "Credit", 115: "Source", 116: "Copyright", 120: "Caption",
    122: "Writer",
}

# common XMP namespace URI → Exiv2 prefix
_XMP_NS = {
    "http://purl.org/dc/elements/1.1/": "dc",
    "http://ns.adobe.com/xap/1.0/": "xmp",
    "http://ns.adobe.com/xap/1.0/mm/": "xmpMM",
    "http://ns.adobe.com/xap/1.0/rights/": "xmpRights",
    "http://ns.adobe.com/photoshop/1.0/": "photoshop",
    "http://ns.adobe.com/exif/1.0/": "exif",
    "http://ns.adobe.com/tiff/1.0/": "tiff",
    "http://ns.adobe.com/exif/1.0/aux/": "aux",
    "http://iptc.org/std/Iptc4xmpCore/1.0/xmlns/": "Iptc4xmpCore",
    "http://ns.adobe.com/lightroom/1.0/": "lr",
    "http://www.w3.org/1999/02/22-rdf-syntax-ns#": "rdf",
}


def _normalize_date(key: str, value: str) -> str:
    if "Date" in key:
        m = _DATE_RE.match(value)
        if m:
            return f"{m.group(1)}-{m.group(2)}-{m.group(3)}T{m.group(4)}"
    return value


def _stringify(v: Any) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, (tuple, list)):
        return ", ".join(_stringify(x) for x in v)
    try:  # PIL rationals
        from PIL.TiffImagePlugin import IFDRational
        if isinstance(v, IFDRational):
            return str(float(v))
    except ImportError:
        pass
    return str(v).strip("\x00 ")


def _exif_table(img) -> dict[str, str]:
    """All EXIF tags as Exiv2-style keys: IFD0 → Exif.Image.*, the EXIF IFD
    → Exif.Photo.*, GPS → Exif.GPSInfo.*."""
    from PIL import ExifTags
    out: dict[str, str] = {}
    exif = img.getexif()
    for tid, val in exif.items():
        name = ExifTags.TAGS.get(tid)
        if name:
            out[f"Exif.Image.{name}"] = _stringify(val)
    try:
        for tid, val in exif.get_ifd(ExifTags.IFD.Exif).items():
            name = ExifTags.TAGS.get(tid)
            if name:
                out[f"Exif.Photo.{name}"] = _stringify(val)
        for tid, val in exif.get_ifd(ExifTags.IFD.GPSInfo).items():
            name = ExifTags.GPSTAGS.get(tid)
            if name:
                out[f"Exif.GPSInfo.{name}"] = _stringify(val)
        for tid, val in exif.get_ifd(ExifTags.IFD.Interop).items():
            name = ExifTags.TAGS.get(tid)
            if name:
                out[f"Exif.Iop.{name}"] = _stringify(val)
    except (AttributeError, KeyError):
        pass
    return out


def _iptc_table(img) -> dict[str, str]:
    from PIL import IptcImagePlugin
    out: dict[str, str] = {}
    info = IptcImagePlugin.getiptcinfo(img)
    if not info:
        return out
    for (record, dataset), val in info.items():
        if record != 2:
            continue
        name = _IPTC_APP2.get(dataset)
        if not name:
            continue
        # repeated datasets (e.g. Keywords) arrive as a list; Exiv2's
        # findKey returns the first datum (media.cpp:1700-1712)
        first = val[0] if isinstance(val, list) else val
        out[f"Iptc.Application2.{name}"] = _stringify(first)
    return out


def _xmp_packet(img, data: Optional[bytes]) -> Optional[bytes]:
    xmp = img.info.get("xmp") or img.info.get("XML:com.adobe.xmp")
    if xmp:
        return xmp.encode() if isinstance(xmp, str) else xmp
    if data:
        start = data.find(b"<x:xmpmeta")
        if start >= 0:
            end = data.find(b"</x:xmpmeta>", start)
            if end >= 0:
                return data[start:end + len(b"</x:xmpmeta>")]
    return None


def _xmp_table(packet: bytes) -> dict[str, str]:
    """Flatten an XMP packet to Xmp.<prefix>.<name> keys.  Handles both
    attribute and element properties plus the first item of
    rdf:Seq/Bag/Alt arrays."""
    import xml.etree.ElementTree as ET
    out: dict[str, str] = {}
    try:
        root = ET.fromstring(packet.decode("utf-8", "replace"))
    except ET.ParseError:
        return out

    def key_for(tag: str) -> Optional[str]:
        if not tag.startswith("{"):
            return None
        uri, _, local = tag[1:].partition("}")
        prefix = _XMP_NS.get(uri)
        if prefix is None or prefix == "rdf":
            return None
        return f"Xmp.{prefix}.{local}"

    def first_li(el) -> Optional[str]:
        for child in el.iter():
            if child.tag.endswith("}li") and (child.text or "").strip():
                return child.text.strip()
        return None

    for desc in root.iter("{http://www.w3.org/1999/02/22-rdf-syntax-ns#}Description"):
        for attr, val in desc.attrib.items():
            k = key_for(attr)
            if k:
                out.setdefault(k, val)
        for el in desc:
            k = key_for(el.tag)
            if not k:
                continue
            text = (el.text or "").strip()
            if not text:
                text = first_li(el) or ""
            if text:
                out.setdefault(k, text)
    return out


def read_embedded(path: str, keys: list[str], field: str,
                  data: Optional[bytes] = None) -> list[Optional[str]]:
    """Look up Exiv2-style keys of one namespace in one image
    (Media::readEmbeddedMetadata, media.cpp:1627-1760).

    @param field one of "exif", "iptc", "xmp", "text"
    @return one value (or None) per requested key"""
    values: list[Optional[str]] = [None] * len(keys)
    try:
        from PIL import Image
        if data is None:
            from ..host.scanner import read_bytes
            data = read_bytes(path)
        img = Image.open(io.BytesIO(data))
        if field == "text":  # PNG tEXt/iTXt chunks (img.text needs load)
            table = {k: _stringify(v) for k, v in getattr(img, "text", {}).items()}
        elif field == "exif":
            table = _exif_table(img)
        elif field == "iptc":
            table = _iptc_table(img)
        elif field == "xmp":
            packet = _xmp_packet(img, data)
            table = _xmp_table(packet) if packet else {}
        else:
            raise ValueError(f"unknown metadata namespace: {field}")
    except (OSError, KeyError, ValueError):
        return values
    for i, key in enumerate(keys):
        v = table.get(key)
        if v is not None:
            values[i] = _normalize_date(key, v)
    return values


def read_ffmeta(path: str, keys: list[str]) -> list[Optional[str]]:
    """Container metadata via ffprobe (VideoContext::readMetaData)."""
    values: list[Optional[str]] = [None] * len(keys)
    import json
    import shutil
    import subprocess
    if shutil.which("ffprobe") is None:
        return values
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-show_entries", "format_tags",
             "-of", "json", path], capture_output=True, text=True,
            timeout=60).stdout
        tags = json.loads(out).get("format", {}).get("tags", {})
    except (OSError, subprocess.SubprocessError, json.JSONDecodeError):
        return values
    lower = {k.lower(): str(v) for k, v in tags.items()}
    for i, key in enumerate(keys):
        values[i] = lower.get(key.lower())
    return values


def lookup(path: str, field: str, keys: list[str],
           use_cache: bool = True) -> Optional[str]:
    """First non-empty value among ``keys``; thread-safe per-path cache
    like the reference propCache (media.cpp:772-793).  Returns None when no
    key exists — the reference's null QVariant, so ``%null`` filter terms
    distinguish missing tags from empty ones."""
    cache_key = f"{path}:{field}{','.join(keys)}"
    if use_cache:
        with _cache_lock:
            if cache_key in _cache:
                return _cache[cache_key]
    if field == "ffmeta":
        vals = read_ffmeta(path, keys)
    else:
        vals = read_embedded(path, keys, field)
    result = next((v for v in vals if v), None)
    if use_cache:
        with _cache_lock:
            _cache[cache_key] = result
    return result
