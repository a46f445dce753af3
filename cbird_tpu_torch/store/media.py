"""Media value object, groups, and the property/sort/filter expression engine.

TPU-native rebuild of the reference Media model
(src/media.h:127-660, src/media.cpp:333-770):

- ``Media``: one indexed item (image / video / audio) with its content
  signatures (md5, dct hash, color descriptor, keypoint hashes/descriptors,
  video index) and per-match metadata (score, match range).
- ``MediaGroup``/``MediaGroupList``: a match group is a plain list whose
  first element is, by convention, the needle.
- property expression engine: compiles "prop#func,args#func" strings into
  closures over media properties — powering -sort, -group-by, -with filters.

Archive members use the virtual path syntax "archive.zip:member.jpg"
(reference src/media.h:548-611).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Callable, Optional

import numpy as np

from ..params import TYPE_AUDIO, TYPE_IMAGE, TYPE_VIDEO

_ZIP_MARKERS = (".zip:", ".cbz:", ".epub:", ".odt:", ".ods:", ".odp:",
                ".docx:", ".pptx:", ".xlsx:", ".xps:")


def is_archived(path: str) -> bool:
    lower = path.lower()
    return any(m in lower for m in _ZIP_MARKERS)


def archive_paths(path: str) -> tuple[str, str]:
    """Split 'a.zip:member' into (a.zip, member); ('', path) if not archived."""
    lower = path.lower()
    for m in _ZIP_MARKERS:
        i = lower.find(m)
        if i >= 0:
            cut = i + len(m) - 1  # position of ':'
            return path[:cut], path[cut + 1:]
    return "", path


@dataclasses.dataclass
class MatchRange:
    """Matched segment; frame numbers for partial video matches
    (reference src/media.h MatchRange)."""
    srcIn: int = -1
    dstIn: int = -1
    len: int = 0

    def is_valid(self) -> bool:
        return self.srcIn >= 0 or self.dstIn >= 0


@dataclasses.dataclass
class VideoIndexData:
    """In-memory per-video hash sequence (frame numbers + 64-bit hashes)."""
    frames: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    hashes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.uint64))

    def is_empty(self) -> bool:
        return len(self.frames) == 0


class Media:
    """One media item. Mutable value object (ids are assigned by Database)."""

    TypeImage = TYPE_IMAGE
    TypeVideo = TYPE_VIDEO
    TypeAudio = TYPE_AUDIO

    __slots__ = (
        "id", "path", "type", "width", "height", "md5", "dctHash",
        "colorDescriptor", "keyPointHashes", "keyPointDescriptors",
        "videoIndex", "score", "matchRange", "isWeed", "origSize",
        "transform", "roi", "image", "attrs",
    )

    def __init__(self, path: str = "", type: int = TYPE_IMAGE, width: int = -1,
                 height: int = -1, md5: str = "", dctHash: int = 0, id: int = 0):
        self.id = id
        self.path = path
        self.type = type
        self.width = width
        self.height = height
        self.md5 = md5
        self.dctHash = int(dctHash)
        self.colorDescriptor: Optional[np.ndarray] = None  # [32,4] f32 (l,u,v,w), NaN-padded
        self.keyPointHashes: Optional[np.ndarray] = None   # [K] uint64
        self.keyPointDescriptors: Optional[np.ndarray] = None  # [K,32] uint8 (256-bit)
        self.videoIndex: Optional[VideoIndexData] = None
        self.score = -1
        self.matchRange = MatchRange()
        self.isWeed = False
        self.origSize = -1
        self.transform = None
        self.roi = None
        self.image: Optional[np.ndarray] = None  # retained decode (optional)
        self.attrs: dict[str, str] = {}

    # ---- identity / paths ------------------------------------------------
    def is_valid(self) -> bool:
        return bool(self.path)

    def is_archived(self) -> bool:
        return is_archived(self.path)

    def archive_paths(self) -> tuple[str, str]:
        return archive_paths(self.path)

    def parent_path(self) -> str:
        """Containing dir; for archive members, the archive file."""
        arch, _ = self.archive_paths()
        if arch:
            return arch
        return os.path.dirname(self.path)

    def dir_path(self) -> str:
        arch, _ = self.archive_paths()
        if arch:
            return os.path.dirname(arch)
        return os.path.dirname(self.path)

    def name(self) -> str:
        _, member = self.archive_paths()
        return os.path.basename(member)

    def suffix(self) -> str:
        n = self.name()
        i = n.rfind(".")
        return n[i + 1:].lower() if i >= 0 else ""

    def type_flag(self) -> int:
        return 1 << (self.type - 1)

    def file_size(self) -> int:
        if self.origSize >= 0:
            return self.origSize
        arch, _ = self.archive_paths()
        target = arch if arch else self.path
        try:
            return os.path.getsize(target)
        except OSError:
            return 0

    def resolution(self) -> int:
        return max(self.width, 0) * max(self.height, 0)

    def compression_ratio(self) -> float:
        res = self.resolution()
        size = self.file_size()
        return (res * 3.0 / size) if size > 0 else 0.0

    def __repr__(self) -> str:
        return f"Media(id={self.id}, path={self.path!r}, type={self.type})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Media) and self.path == other.path

    def __hash__(self) -> int:
        return hash(self.path)


MediaGroup = list  # list[Media]; group[0] is the needle by convention
MediaGroupList = list  # list[MediaGroup]


def read_metadata(m: Media) -> None:
    """Lazily populate m.attrs with exif:* keys (reference reads exif/iptc/
    xmp via Exiv2; here PIL's EXIF reader covers the common tags used by
    sort/filter expressions). Safe no-op on failure."""
    if m.attrs.get("_meta_read"):
        return
    m.attrs["_meta_read"] = "1"
    try:
        import io
        from PIL import Image, ExifTags
        from ..host.scanner import read_bytes
        img = Image.open(io.BytesIO(read_bytes(m.path)))
        exif = img.getexif()
        for tag_id, value in exif.items():
            name = ExifTags.TAGS.get(tag_id)
            if name:
                m.attrs[f"exif:{name}"] = str(value)
        # common aliases the reference exposes (Exiv2 key style)
        for alias, name in (("exif:Photo.DateTimeOriginal", "DateTimeOriginal"),
                            ("exif:Image.Model", "Model"),
                            ("exif:Image.Make", "Make")):
            ifd = exif.get_ifd(ExifTags.IFD.Exif) if hasattr(ExifTags, "IFD") else {}
            for tid, val in ifd.items():
                if ExifTags.TAGS.get(tid) == name:
                    m.attrs[alias] = str(val)
            if name in ("Model", "Make"):
                for tid, val in exif.items():
                    if ExifTags.TAGS.get(tid) == name:
                        m.attrs[alias] = str(val)
    except Exception:  # noqa: BLE001 — metadata is best-effort
        pass


# ---------------------------------------------------------------------------
# property / expression engine (reference src/media.cpp:333-770)
# ---------------------------------------------------------------------------

_PROPS: dict[str, Callable[[Media], Any]] = {
    "id": lambda m: m.id,
    "path": lambda m: m.path,
    "dirPath": lambda m: m.dir_path(),
    "parentPath": lambda m: m.parent_path(),
    "name": lambda m: m.name(),
    "completeBaseName": lambda m: os.path.splitext(m.name())[0],
    "suffix": lambda m: m.suffix(),
    "type": lambda m: m.type,
    "isArchived": lambda m: m.is_archived(),
    "archivePath": lambda m: m.archive_paths()[0],
    "md5": lambda m: m.md5,
    "dctHash": lambda m: m.dctHash,
    "fileSize": lambda m: m.file_size(),
    "width": lambda m: m.width,
    "height": lambda m: m.height,
    "resolution": lambda m: m.resolution(),
    "res": lambda m: max(m.width, m.height),
    "compressionRatio": lambda m: m.compression_ratio(),
    "score": lambda m: m.score,
    "isWeed": lambda m: m.isWeed,
    "random": lambda m: hash(m.path) & 0xFFFF,
}


def _todate(v):
    """EXIF "YYYY:MM:DD HH:MM:SS" → ISO (reference unaryFunc todate)."""
    from .metadata import _normalize_date
    return _normalize_date("Date", str(v))


def _unary_funcs() -> dict[str, Callable]:
    def mid(v, start, length=None):
        s = str(v)
        start = int(start)
        return s[start:] if length is None else s[start:start + int(length)]

    def trim(v):
        return str(v).strip()

    funcs: dict[str, Callable] = {
        "mid": mid,
        "trim": trim,
        "upper": lambda v: str(v).upper(),
        "lower": lambda v: str(v).lower(),
        "title": lambda v: str(v).title(),
        "len": lambda v: len(str(v)),
        "abs": lambda v: abs(float(v)),
        "int": lambda v: int(float(v)),
        "todate": _todate,
        "year": lambda v: str(v)[:4],
        "month": lambda v: str(v)[5:7],
        "day": lambda v: str(v)[8:10],
        "split": lambda v, sep: str(v).split(sep),
        "join": lambda v, sep: sep.join(v if isinstance(v, list) else [str(v)]),
        "camelsplit": lambda v: " ".join(re.findall(r"[A-Z]?[a-z0-9]+|[A-Z]+(?![a-z])",
                                                    str(v))),
        "pad": lambda v, n: str(v).zfill(int(n)),
        "add": lambda v, n: float(v) + float(n),
        "sub": lambda v, n: float(v) - float(n),
        "mul": lambda v, n: float(v) * float(n),
        "div": lambda v, n: float(v) / float(n),
    }
    return funcs


_FUNCS = _unary_funcs()


def property_func(expr: str) -> Callable[[Media], Any]:
    """Compile "prop[#func[,arg...]][#func...]" into a closure.

    Mirrors the reference Media::propertyFunc grammar
    (src/media.cpp:648-770).  Properties prefixed "exif:",
    "iptc:", "xmp:" or "ffmeta:" read the media's attrs dict (populated by
    the metadata reader when available).
    """
    parts = expr.split("#")
    prop = parts[0]

    if prop in ("exif", "iptc", "xmp", "text", "ffmeta"):
        # reference grammar: exif#<tag1[,tagN]>[#func...] — the first chain
        # element is a comma-separated Exiv2-style key list, first non-empty
        # value wins; "nocache" prefix skips the value cache
        # (media.cpp:761-803)
        if len(parts) < 2:
            raise ValueError(f"{prop} requires tag name(s), e.g. "
                             f"{prop}#Exif.Photo.DateTimeOriginal")
        keys = parts[1].split(",")
        use_cache = True
        if keys and keys[0] == "nocache":
            keys = keys[1:]
            use_cache = False
        parts = [prop] + parts[2:]  # remaining elements are unary funcs

        def getter(m: Media, _f=prop, _keys=tuple(keys), _uc=use_cache) -> Any:
            from .metadata import lookup
            return lookup(m.path, _f, list(_keys), use_cache=_uc)
    elif ":" in prop:
        ns, key = prop.split(":", 1)
        if ns in ("exif", "iptc", "xmp", "ffmeta"):
            def getter(m: Media, _prop=prop) -> Any:
                if _prop not in m.attrs:
                    read_metadata(m)
                return m.attrs.get(_prop, "")
        else:
            raise ValueError(f"unknown property namespace: {ns}")
    elif prop in _PROPS:
        getter = _PROPS[prop]
    else:
        raise ValueError(f"unknown property: {prop} (expected one of "
                         f"{','.join(sorted(_PROPS))})")

    chain = []
    for fn in parts[1:]:
        args = fn.split(",")
        name, fargs = args[0], args[1:]
        if name not in _FUNCS:
            raise ValueError(f"unknown function: {name}")
        chain.append((_FUNCS[name], fargs))

    def run(m: Media) -> Any:
        v = getter(m)
        if v is None:  # null metadata value stays null through the chain
            return None
        for f, fargs in chain:
            v = f(v, *fargs)
        return v

    return run


def _sort_key(value: Any):
    # numeric-aware ("natural") sort comparable across str/num
    if value is None:
        return (-1, 0, "")  # null (missing metadata) sorts first
    if isinstance(value, bool):
        return (0, int(value), "")
    if isinstance(value, (int, float)):
        return (0, value, "")
    s = str(value)
    # natural sort: split digit runs
    parts = re.split(r"(\d+)", s)
    key = tuple((1, int(p), "") if p.isdigit() else (2, 0, p) for p in parts if p != "")
    return (1, 0, key)


def sort_group(group: MediaGroup, props: list[str], reverse: bool = False) -> None:
    fns = [property_func(p) for p in props]
    group.sort(key=lambda m: tuple(_sort_key(fn(m)) for fn in fns), reverse=reverse)


def sort_group_list(groups: MediaGroupList, props: list[str]) -> None:
    fns = [property_func(p) for p in props]
    groups.sort(key=lambda g: tuple(_sort_key(fn(g[0])) for fn in fns) if g else ())


def group_by(media: list[Media], prop: str) -> MediaGroupList:
    fn = property_func(prop)
    buckets: dict[Any, MediaGroup] = {}
    for m in media:
        buckets.setdefault(fn(m), []).append(m)
    return [buckets[k] for k in sorted(buckets, key=_sort_key)]


def expand_group_list(groups: MediaGroupList) -> MediaGroupList:
    """{a,b,c} => {a,b}+{a,c} (reference SearchParams.expandGroups)."""
    out: MediaGroupList = []
    for g in groups:
        if len(g) <= 2:
            out.append(g)
        else:
            out.extend([[g[0], other] for other in g[1:]])
    return out


def merge_group_list(groups: MediaGroupList) -> MediaGroupList:
    """Merge n-connected groups: {a,b},{a,c} => {a,b,c}."""
    parent: dict[str, str] = {}

    def find(x: str) -> str:
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    def union(a: str, b: str) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    media_by_path: dict[str, Media] = {}
    for g in groups:
        for m in g:
            media_by_path.setdefault(m.path, m)
            parent.setdefault(m.path, m.path)
        for m in g[1:]:
            union(g[0].path, m.path)

    merged: dict[str, MediaGroup] = {}
    for path in parent:
        merged.setdefault(find(path), []).append(media_by_path[path])
    out = [sorted(g, key=lambda m: m.path) for g in merged.values()]
    out.sort(key=lambda g: g[0].path if g else "")
    return out
