"""Declarative parameter registry (cbird `-p.*` / `-i.*` surface).

Re-implements the reference's reflection-style Params system
(src/params.h:23-92, src/params.cpp) as a Python descriptor
registry: every parameter has a short key, category, help label, type, and
optional named values / range / links.  Same keys, same defaults, same help
output so cbird users can switch without relearning flags
(src/index.cpp:53-174, src/scanner.cpp:1236-1333).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any


class ParamError(ValueError):
    pass


BOOL = "bool"
INT = "int"
ENUM = "enum"
FLAGS = "flags"
GLOB = "glob"
LIST = "list"
STR = "str"

INT_MAX = 2**31 - 1


@dataclasses.dataclass
class NamedValue:
    value: int
    shortName: str
    description: str


@dataclasses.dataclass
class ParamSpec:
    key: str
    category: int
    label: str
    type: str
    attr: str  # attribute on the owning Params object
    namedValues: list[NamedValue] = dataclasses.field(default_factory=list)
    range: tuple[int, int] | None = None

    def parse(self, text: str) -> Any:
        """Parse a CLI string into this parameter's value."""
        if self.type == BOOL:
            t = text.strip().lower()
            if t in ("1", "true", "yes", "y", "on"):
                return True
            if t in ("0", "false", "no", "n", "off"):
                return False
            raise ParamError(f"invalid bool for -{self.key}: {text}")
        if self.type == INT:
            if self.namedValues:
                for nv in self.namedValues:
                    if nv.shortName == text:
                        return nv.value
            try:
                v = int(text)
            except ValueError:
                raise ParamError(f"invalid int for -{self.key}: {text}") from None
            if self.range and not (self.range[0] <= v <= self.range[1]):
                raise ParamError(
                    f"-{self.key} out of range [{self.range[0]},{self.range[1]}]: {v}")
            return v
        if self.type == ENUM:
            for nv in self.namedValues:
                if nv.shortName == text:
                    return nv.value
            try:
                v = int(text)
            except ValueError:
                names = ",".join(nv.shortName for nv in self.namedValues)
                raise ParamError(
                    f"invalid value for -{self.key}: {text} (expected one of {names})"
                ) from None
            if not any(nv.value == v for nv in self.namedValues):
                raise ParamError(f"invalid enum value for -{self.key}: {v}")
            return v
        if self.type == FLAGS:
            # "h+v+b" syntax (reference src/params.cpp:189-222); also accepts int
            try:
                return int(text)
            except ValueError:
                pass
            mask = 0
            for part in text.split("+"):
                part = part.strip()
                if part in ("", "none") and not any(
                        nv.shortName == part for nv in self.namedValues):
                    continue  # format() emits "none" for an empty mask
                for nv in self.namedValues:
                    if nv.shortName == part:
                        mask |= nv.value
                        break
                else:
                    names = "+".join(nv.shortName for nv in self.namedValues)
                    raise ParamError(
                        f"invalid flag for -{self.key}: {part} (expected subset of {names})")
            return mask
        # GLOB/LIST/STR: string payloads, appended for GLOB/LIST
        return text

    def format(self, value: Any) -> str:
        if self.type == ENUM:
            for nv in self.namedValues:
                if nv.value == value:
                    return nv.shortName
            return str(value)
        if self.type == FLAGS:
            parts = [nv.shortName for nv in self.namedValues if nv.value and (value & nv.value)]
            return "+".join(parts) if parts else "none"
        if self.type == BOOL:
            return "true" if value else "false"
        if self.type in (GLOB, LIST):
            return ",".join(value)
        return str(value)


class Params:
    """Base for parameter bundles with a class-level spec registry."""

    SPECS: list[ParamSpec] = []
    CATEGORY_LABELS: list[str] = []
    VALUE_LABEL = "Parameter"

    # links: (srcKey, srcValue) -> list[(dstKey, dstValue)]; applied when src
    # is set and dst was not explicitly set (reference src/params.h link()).
    LINKS: dict[tuple[str, int], list[tuple[str, Any]]] = {}

    def __init__(self) -> None:
        self._explicit: set[str] = set()

    def spec(self, key: str) -> ParamSpec:
        for s in self.SPECS:
            if s.key == key:
                return s
        raise ParamError(f"unknown {self.VALUE_LABEL.lower()}: {key}")

    def set_param(self, key: str, text: str) -> None:
        s = self.spec(key)
        value = s.parse(text)
        if s.type in (GLOB, LIST):
            getattr(self, s.attr).append(value)
        else:
            setattr(self, s.attr, value)
        self._explicit.add(key)
        for (src, srcval), dsts in self.LINKS.items():
            if src == key and srcval == value:
                for dkey, dval in dsts:
                    if dkey not in self._explicit:
                        setattr(self, self.spec(dkey).attr, dval)

    def get_param(self, key: str) -> Any:
        return getattr(self, self.spec(key).attr)

    def was_set(self, key: str) -> bool:
        return key in self._explicit

    def changed_kv(self) -> list[tuple[str, str]]:
        """Explicitly-set parameters as (key, formatted-value) pairs —
        round-trippable through set_param (the -serve client protocol)."""
        return [(k, self.spec(k).format(self.get_param(k)))
                for k in sorted(self._explicit)]

    def help_text(self) -> str:
        lines = [f"{self.VALUE_LABEL}s:"]
        by_cat: dict[int, list[ParamSpec]] = {}
        for s in self.SPECS:
            by_cat.setdefault(s.category, []).append(s)
        for cat in sorted(by_cat):
            label = self.CATEGORY_LABELS[cat] if cat < len(self.CATEGORY_LABELS) else ""
            lines.append(f"  [{label}]")
            for s in by_cat[cat]:
                cur = s.format(getattr(self, s.attr))
                extra = ""
                if s.namedValues:
                    extra = " {" + ",".join(nv.shortName for nv in s.namedValues) + "}"
                elif s.range:
                    extra = f" [{s.range[0]}..{s.range[1]}]"
                lines.append(f"    {s.key:<8} {s.label}{extra} (={cur})")
        return "\n".join(lines)


# media type ids (reference src/media.h Media::TypeImage/Video/Audio)
TYPE_IMAGE = 1
TYPE_VIDEO = 2
TYPE_AUDIO = 3

FLAG_IMAGE = 1 << (TYPE_IMAGE - 1)
FLAG_VIDEO = 1 << (TYPE_VIDEO - 1)
FLAG_AUDIO = 1 << (TYPE_AUDIO - 1)


class SearchParams(Params):
    """Search parameters; same knobs/defaults as the reference
    (src/index.h:73-121, src/index.cpp:54-174)."""

    # algorithms
    ALGO_DCT = 0
    ALGO_DCT_FEATURES = 1
    ALGO_CV_FEATURES = 2
    ALGO_COLOR = 3
    ALGO_VIDEO = 4
    NUM_ALGOS = 5

    MIRROR_NONE = 0
    MIRROR_HORIZONTAL = 1
    MIRROR_VERTICAL = 2
    MIRROR_BOTH = 4

    CAT_ALGO, CAT_QUERY, CAT_PRE, CAT_POST, CAT_DIAG = range(5)
    CATEGORY_LABELS = ["Algorithm", "Querying", "Preprocessing", "Postprocessing", "Diagnostic"]
    VALUE_LABEL = "Search Parameter"

    _ALGO_VALUES = [
        NamedValue(ALGO_DCT, "dct", "DCT image hash"),
        NamedValue(ALGO_DCT_FEATURES, "fdct", "DCT image hashes of features"),
        NamedValue(ALGO_CV_FEATURES, "orb", "ORB descriptors of features"),
        NamedValue(ALGO_COLOR, "color", "Color histogram"),
        NamedValue(ALGO_VIDEO, "video", "DCT image hashes of video frames"),
    ]
    _MIRROR_VALUES = [
        NamedValue(MIRROR_NONE, "none", "No flipping"),
        NamedValue(MIRROR_HORIZONTAL, "h", "Flip horizontally"),
        NamedValue(MIRROR_VERTICAL, "v", "Flip vertically"),
        NamedValue(MIRROR_BOTH, "b", "Flip horizontal and vertical"),
    ]
    _TYPE_VALUES = [
        NamedValue(FLAG_IMAGE, "i", "Image files"),
        NamedValue(FLAG_VIDEO, "v", "Video files"),
        NamedValue(FLAG_AUDIO, "a", "Audio files"),
    ]

    SPECS = [
        ParamSpec("alg", CAT_ALGO, "Search algorithm", ENUM, "algo", _ALGO_VALUES),
        ParamSpec("dht", CAT_ALGO, "DCT hash distance threshold (dct,fdct,video)", INT,
                  "dctThresh", range=(0, 65)),
        ParamSpec("odt", CAT_ALGO, "ORB descriptor distance threshold (orb)", INT,
                  "cvThresh", range=(0, 100)),
        ParamSpec("ovg", CAT_ALGO, "ORB vote gate: drop matches scoring > R x the "
                  "needle's best match, 0=off (orb)", INT, "cvGate",
                  range=(0, INT_MAX)),
        ParamSpec("vradix", CAT_ALGO, "Divides the haystack by ~ 2^R but loses accuracy (video)",
                  INT, "videoRadix", range=(1, 24)),
        ParamSpec("vfm", CAT_ALGO, "Minimum number of frames matched per video", INT,
                  "minFramesMatched", range=(0, INT_MAX)),
        ParamSpec("vfn", CAT_ALGO, "Minimum percent of frames near each other", INT,
                  "minFramesNear", range=(1, 100)),
        ParamSpec("fs", CAT_QUERY, "Filter Self: remove item that matched itself", BOOL,
                  "filterSelf"),
        ParamSpec("mn", CAT_QUERY, "Minimum matches per needle", INT, "minMatches",
                  range=(1, INT_MAX)),
        ParamSpec("mm", CAT_QUERY, "Maximum matches per needle", INT, "maxMatches",
                  range=(1, INT_MAX)),
        ParamSpec("mt", CAT_QUERY, "Maximum threshold to try, until minMatches are found", INT,
                  "maxThresh", range=(0, INT_MAX)),
        ParamSpec("refl", CAT_QUERY, "Also search reflections of needle", FLAGS, "mirrorMask",
                  _MIRROR_VALUES),
        # the reference sets SearchParams::path internally from GUI/verb
        # scoping (src/database.cpp:1209-1247 filterMatch); exposed here as
        # explicit -p keys so CLI users can scope match results by subtree
        ParamSpec("path", CAT_POST, "Keep only matches outside this path (inside with -p.inpath)",
                  STR, "path"),
        ParamSpec("inpath", CAT_POST, "Invert -p.path: keep only matches inside the path", BOOL,
                  "inPath"),
        ParamSpec("types", CAT_PRE, "Enabled needle media types", FLAGS, "queryTypes",
                  _TYPE_VALUES),
        ParamSpec("crop", CAT_PRE, "Enable de-letterbox/autocrop pre-filter", BOOL, "autoCrop"),
        ParamSpec("vtrim", CAT_PRE, "Number of frames to ignore at start/end (video)", INT,
                  "skipFrames", range=(0, INT_MAX)),
        ParamSpec("tm", CAT_POST, "Enable template match result filter", BOOL, "templateMatch"),
        ParamSpec("tnf", CAT_POST, "Template match number of needle features", INT,
                  "needleFeatures", range=(1, INT_MAX)),
        ParamSpec("thf", CAT_POST, "Template match number of haystack features", INT,
                  "haystackFeatures", range=(1, INT_MAX)),
        ParamSpec("tdht", CAT_POST, "Template matcher DCT hash threshold", INT, "tmThresh",
                  range=(0, INT_MAX)),
        ParamSpec("tscale", CAT_POST, "Template matcher scale factor %", INT, "tmScalePct",
                  range=(1, INT_MAX)),
        ParamSpec("neg", CAT_POST, "Enable negative match result filter", BOOL, "negativeMatch"),
        ParamSpec("fg", CAT_POST,
                  "Filter Groups: remove duplicate groups from result: {a,b}=={b,a}", BOOL,
                  "filterGroups"),
        ParamSpec("fp", CAT_POST, "Filter Parent: remove items in the same directory as needle",
                  BOOL, "filterParent"),
        ParamSpec("mg", CAT_POST, "Merge n-connected groups: {a,b},{a,c}=>{a,b,c}", INT,
                  "mergeGroups", range=(0, INT_MAX)),
        ParamSpec("eg", CAT_POST, "Expand groups to make pairs {a,b,c}=>{a,b}+{a,c}", BOOL,
                  "expandGroups"),
        ParamSpec("verbose", CAT_DIAG, "Enable diagnostic/verbose output", BOOL, "verbose"),
    ]

    # "-p.alg video" implies "-p.types i+v" unless -p.types was given
    # (reference src/index.cpp:167-173)
    LINKS = {
        ("alg", ALGO_DCT): [("types", FLAG_IMAGE)],
        ("alg", ALGO_DCT_FEATURES): [("types", FLAG_IMAGE)],
        ("alg", ALGO_CV_FEATURES): [("types", FLAG_IMAGE)],
        ("alg", ALGO_COLOR): [("types", FLAG_IMAGE)],
        ("alg", ALGO_VIDEO): [("types", FLAG_IMAGE | FLAG_VIDEO)],
    }

    def __init__(self) -> None:
        super().__init__()
        self.algo = self.ALGO_DCT
        self.dctThresh = 5
        self.cvThresh = 25
        self.cvGate = 25
        self.minMatches = 1
        self.maxMatches = 5
        self.needleFeatures = 100
        self.haystackFeatures = 1000
        self.mirrorMask = self.MIRROR_NONE
        self.maxThresh = 0
        self.tmThresh = 7
        self.tmScalePct = 200
        self.templateMatch = False
        self.negativeMatch = False
        self.autoCrop = False
        self.verbose = False
        self.path = ""
        self.inPath = False
        self.set: list = []   # media subset (for -similar-in etc.)
        self.inSet = False
        self.target = 0
        self.queryTypes = FLAG_IMAGE
        self.skipFrames = 300
        self.minFramesMatched = 30
        self.minFramesNear = 60
        self.videoRadix = 10
        self.filterSelf = True
        self.filterGroups = True
        self.filterParent = False
        self.expandGroups = False
        self.mergeGroups = 0
        self.progressInterval = 1000

    def resultTypes(self) -> int:
        if self.algo == self.ALGO_VIDEO:
            return FLAG_VIDEO
        return FLAG_IMAGE

    def mediaSupported(self, media) -> bool:
        flag = 1 << (media.type - 1)
        return bool(self.queryTypes & flag)

    def copy(self) -> "SearchParams":
        import copy as _copy
        return _copy.copy(self)


class IndexParams(Params):
    """Index/ingest parameters; same knobs/defaults as the reference
    (src/scanner.h:48-90, src/scanner.cpp:1236-1333)."""

    (CAT_ALGORITHMS, CAT_FILESYSTEM, CAT_IMAGEPROC, CAT_THREADS, CAT_JOBS,
     CAT_DIAGNOSTIC) = range(6)
    CATEGORY_LABELS = ["Algorithms", "Filesystem", "Image Processing", "Threads", "Jobs",
                       "Diagnostic"]
    VALUE_LABEL = "Index Parameter"

    _ALGO_BITS = [
        NamedValue(1 << SearchParams.ALGO_DCT, "dct", "DCT image hash"),
        NamedValue(1 << SearchParams.ALGO_DCT_FEATURES, "fdct", "DCT image hashes of features"),
        NamedValue(1 << SearchParams.ALGO_CV_FEATURES, "orb", "ORB descriptors of features"),
        NamedValue(1 << SearchParams.ALGO_COLOR, "color", "Color histogram"),
        NamedValue(1 << SearchParams.ALGO_VIDEO, "video", "DCT image hashes of video frames"),
    ]
    # flag values 1/2/4 (reference src/scanner.h:35: TypeAudio = 4 as a flag)
    _TYPE_BITS = [
        NamedValue(1, "i", "Image files"),
        NamedValue(2, "v", "Video files"),
        NamedValue(4, "a", "Audio files"),
    ]

    SPECS = [
        ParamSpec("algos", CAT_ALGORITHMS, "Enabled algorithms", FLAGS, "algos", _ALGO_BITS),
        ParamSpec("types", CAT_ALGORITHMS, "Enabled media types", FLAGS, "types", _TYPE_BITS),
        ParamSpec("sync", CAT_ALGORITHMS,
                  "Ensures previous algos persist even if -i.algos changes", BOOL, "sync"),
        ParamSpec("dirs", CAT_FILESYSTEM, "Enable recursive scan of subdirectories", BOOL,
                  "recursive"),
        ParamSpec("exclude", CAT_FILESYSTEM, "Add glob/pattern to exclude matching paths", GLOB,
                  "excludePatterns"),
        ParamSpec("include", CAT_FILESYSTEM, "Add glob/pattern to include matching paths", GLOB,
                  "includePatterns"),
        ParamSpec("fsize", CAT_FILESYSTEM, "Minimum file size in bytes, ignore smaller files",
                  INT, "minFileSize", range=(0, INT_MAX)),
        ParamSpec("links", CAT_FILESYSTEM, "Follow symlinks to files and directories", BOOL,
                  "followSymlinks"),
        ParamSpec("resolve", CAT_FILESYSTEM,
                  "Store resolved symlink if it is child of index root", BOOL, "resolveLinks"),
        ParamSpec("dups", CAT_FILESYSTEM,
                  "Follow duplicate inodes (hard links,symlinks,junctions)", BOOL, "dupInodes"),
        ParamSpec("modtime", CAT_FILESYSTEM,
                  "Force using potentially unreliable file modification time", BOOL, "modTime"),
        ParamSpec("crop", CAT_IMAGEPROC,
                  "Enable border crop/de-letterbox for images (video=>always enabled)", BOOL,
                  "autocrop"),
        ParamSpec("nfeat", CAT_IMAGEPROC, "Number of features per image (fdct,orb)", INT,
                  "numFeatures", range=(0, INT_MAX)),
        ParamSpec("rsize", CAT_IMAGEPROC,
                  "Dimension for prescaling images before processing (dct,fdct,orb,color)", INT,
                  "resizeLongestSide", range=(1, INT_MAX)),
        ParamSpec("vht", CAT_IMAGEPROC,
                  "Dct threshold for discarding nearby frame hashes (video)", INT,
                  "videoThreshold", range=(1, INT_MAX)),
        ParamSpec("hwdec", CAT_THREADS, "Add hardware decoder <device-id>,family=<family>[,...]",
                  LIST, "accelList"),
        ParamSpec("forkhw", CAT_THREADS,
                  "Run hardware decoders in a separate process (for buggy decoders/codecs)", BOOL,
                  "forkAccel"),
        ParamSpec("decthr", CAT_THREADS, "Max threads for a cpu video decoding job (0==auto)",
                  INT, "decoderThreads", range=(0, INT_MAX)),
        ParamSpec("idxthr", CAT_THREADS, "Max threads for all jobs (0==auto)", INT,
                  "indexThreads", range=(0, INT_MAX)),
        ParamSpec("bsize", CAT_JOBS, "Size of database write batches", INT, "writeBatchSize",
                  range=(1, INT_MAX)),
        ParamSpec("ljf", CAT_JOBS, "Estimate job cost and process longest jobs first", BOOL,
                  "estimateCost"),
        ParamSpec("ignored", CAT_DIAGNOSTIC, "Log all ignored files", BOOL, "showIgnored"),
        ParamSpec("verbose", CAT_DIAGNOSTIC,
                  "Log links followed, all files queued for processing, etc", BOOL, "verbose"),
        ParamSpec("dryrun", CAT_DIAGNOSTIC,
                  "Don't index any files, only show what changes would be made", BOOL, "dryRun"),
    ]

    def __init__(self) -> None:
        super().__init__()
        self.algos = 31
        self.types = 7  # i+v+a (reference TypeAll)
        self.sync = True
        self.recursive = True
        self.excludePatterns: list[str] = []
        self.includePatterns: list[str] = []
        self.minFileSize = 1024
        self.followSymlinks = False
        self.resolveLinks = False
        self.dupInodes = False
        self.modTime = False
        self.autocrop = True
        self.numFeatures = 400
        self.resizeLongestSide = 400
        self.videoThreshold = 8
        self.retainData = False
        self.retainImage = False
        self.accelList: list[str] = []
        self.forkAccel = False
        self.decoderThreads = 0
        self.indexThreads = 0
        self.writeBatchSize = 1024
        self.estimateCost = True
        self.showIgnored = False
        self.verbose = False
        self.dryRun = False

    def path_included(self, path: str) -> bool:
        """Apply include/exclude globs (reference src/scanner.cpp:1179-1212)."""
        for pat in self.excludePatterns:
            if fnmatch.fnmatch(path, pat) or pat in path:
                # include patterns can rescue an excluded path
                for ipat in self.includePatterns:
                    if fnmatch.fnmatch(path, ipat) or ipat in path:
                        return True
                return False
        return True
