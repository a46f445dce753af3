"""Larger CLI subcommands: filter expressions, rename, nuke, weeds.

Rebuild of the reference Commands layer (src/commands.cpp)
and its `-with` expression grammar (src/res/usage.txt:183-207):

  <expr> := [<binop>]<string> | :<regex> | [<binop>]%needle
          | %<binop><string> (absolute difference vs needle)
          | %null | !%null | %empty | !%empty
          | <expr>&&<expr> | <expr>||<expr>
  <binop> := == | = | != | < | <= | > | >= | ~ (contains) | ! (not contains)
"""

from __future__ import annotations

import math
import os
import re
import shutil
from typing import Callable, Optional

from ..store.media import Media, MediaGroup, property_func
from ..utils.log import info, warn

_BINOPS = ["==", "!=", "<=", ">=", "=", "<", ">", "~", "!"]


def _to_num(v) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _compare(op: str, value, rhs) -> bool:
    if op in ("~", "!"):
        hit = str(rhs) in str(value)
        return hit if op == "~" else not hit
    nv, nr = _to_num(value), _to_num(rhs)
    if nv is not None and nr is not None:
        value, rhs = nv, nr
    else:
        value, rhs = str(value), str(rhs)
    if op in ("==", "="):
        return value == rhs
    if op == "!=":
        return value != rhs
    if op == "<":
        return value < rhs
    if op == "<=":
        return value <= rhs
    if op == ">":
        return value > rhs
    if op == ">=":
        return value >= rhs
    raise ValueError(f"bad operator {op}")


def _parse_term(term: str) -> Callable:
    """@return predicate(value, needle_value) for one expression term."""
    if term == "%null":
        return lambda v, nv: v is None
    if term == "!%null":
        return lambda v, nv: v is not None
    if term == "%empty":
        return lambda v, nv: str(v or "") == ""
    if term == "!%empty":
        return lambda v, nv: str(v or "") != ""
    if term.startswith(":"):
        rx = re.compile(term[1:])
        return lambda v, nv: bool(rx.search(str(v)))
    if term.startswith("%") and term != "%needle":
        # %<binop><string>: absolute difference with needle
        rest = term[1:]
        for op in _BINOPS:
            if rest.startswith(op):
                rhs = rest[len(op):]
                def diff_pred(v, nv, op=op, rhs=rhs):
                    a, b = _to_num(v), _to_num(nv)
                    if a is None or b is None:
                        return False
                    return _compare(op, abs(a - b), rhs)
                return diff_pred
        raise ValueError(f"bad %-expression: {term}")
    op = "=="
    rhs = term
    for o in _BINOPS:
        if term.startswith(o):
            op, rhs = o, term[len(o):]
            break
    if rhs == "%needle":
        return lambda v, nv, op=op: _compare(op, v, nv)
    return lambda v, nv, op=op, rhs=rhs: _compare(op, v, rhs)


def compile_filter(prop: str, expr: str) -> Callable[[Media, Optional[Media]], bool]:
    """Compile '-with <prop> <expr>' into predicate(media, needle)."""
    get = property_func(prop)
    # || binds looser than &&
    or_terms = []
    for or_part in expr.split("||"):
        and_preds = [_parse_term(t) for t in or_part.split("&&")]
        or_terms.append(and_preds)

    def run(m: Media, needle: Optional[Media]) -> bool:
        v = get(m)
        nv = get(needle) if needle is not None else None
        for and_preds in or_terms:
            if all(p(v, nv) for p in and_preds):
                return True
        return False

    return run


def filter_selection(selection: list[Media], prop: str, expr: str,
                     negate: bool = False) -> list[Media]:
    pred = compile_filter(prop, expr)
    return [m for m in selection if pred(m, None) != negate]


def filter_groups(groups: list[MediaGroup], prop: str, expr: str,
                  negate: bool = False) -> list[MediaGroup]:
    """Filter match items within groups; the needle (group[0]) provides
    %needle context and survives; groups left without matches are dropped.
    negate=True keeps items that do NOT match (-without)."""
    raw = compile_filter(prop, expr)
    pred = (lambda m, n: not raw(m, n)) if negate else raw
    out = []
    for g in groups:
        if not g:
            continue
        needle = g[0]
        kept = [m for m in g[1:] if pred(m, needle)]
        if len(g) == 1:
            if pred(needle, needle):
                out.append([needle])
        elif kept:
            out.append([needle] + kept)
    return out


# ---------------------------------------------------------------------------
# rename (reference src/commands.cpp:381-525)
# ---------------------------------------------------------------------------

def _expand_templates(name: str, m: Media) -> str:
    """Expand {prop[#func]} / {arg:func} templates."""
    def sub(match: re.Match) -> str:
        body = match.group(1)
        if ":" in body:
            arg, funcs = body.split(":", 1)
            fake = Media(arg)
            try:
                v = property_func("path#" + funcs.replace(":", "#"))(fake)
            except ValueError:
                return match.group(0)
            return "" if v is None else str(v)
        try:
            v = property_func(body)(m)
        except ValueError:
            return match.group(0)
        return "" if v is None else str(v)  # null metadata expands empty
    return re.sub(r"\{([^{}]+)\}", sub, name)


def rename(db, selection: list[Media], src_pat: str, dst_pat: str,
           options: str = "", dry_run: bool = False) -> int:
    """Regex rename with capture refs (#n), sequence numbers (%n, padded),
    and {prop} templates; operates on the base name, keeps the extension."""
    try:
        rx = re.compile(src_pat)
    except re.error as e:
        raise ValueError(f"rename: illegal regular expression <{src_pat}>: {e}")

    find_replace = "#" not in dst_pat
    pad = int(math.log10(max(len(selection), 1))) + 1
    num = 1
    renamed = 0
    for m in selection:
        if m.is_archived():
            warn(f"rename: cannot rename archived file: {m.path}")
            continue
        base = os.path.basename(m.path)
        stem, dot, suffix = base.rpartition(".")
        if not dot:
            warn(f"rename: no file extension: {m.path}")
            continue
        old_name = stem
        if "p" in options:
            rel = os.path.relpath(os.path.dirname(m.path), db.path())
            old_name = (rel + "/" if rel != "." else "") + stem

        if find_replace:
            new_name = rx.sub(dst_pat, old_name)
            if "%n" in new_name:
                new_name = new_name.replace("%n", str(num).zfill(pad))
            elif new_name == old_name:
                if "v" in options:
                    warn(f"rename: <find> ({src_pat}) doesn't match: <{old_name}>")
                continue
        else:
            match = rx.search(old_name)
            if not match:
                if "v" in options:
                    warn(f"rename: <find> <{src_pat}> does not match: <{old_name}>")
                continue
            new_name = dst_pat
            groups = (match.group(0),) + match.groups("")
            for i in range(len(groups) - 1, -1, -1):
                new_name = new_name.replace(f"#{i}", groups[i])
            if "%n" in new_name:
                new_name = new_name.replace("%n", str(num).zfill(pad))

        new_name = _expand_templates(new_name, m)
        new_rel = os.path.join(os.path.dirname(os.path.relpath(m.path, db.path())),
                               new_name + "." + suffix) \
            if "p" not in options else new_name + "." + suffix
        if dry_run:
            info(f"would rename: {os.path.basename(m.path)} -> {new_name}.{suffix}")
            num += 1
            renamed += 1
            continue
        if db.rename(m, new_rel):
            num += 1
            renamed += 1
        else:
            warn(f"rename failed: {m.path} -> {new_rel}")
    return renamed


# ---------------------------------------------------------------------------
# nuke / weeds (reference -nuke, -nuke-dups-in, -nuke-weeds, DesktopHelper trash)
# ---------------------------------------------------------------------------

def trash_file(path: str) -> bool:
    """Move to trash (CBIRD_TRASH_DIR override like the reference DesktopHelper);
    falls back to unlink when no trash dir is configured."""
    trash_dir = os.environ.get("CBIRD_TRASH_DIR")
    try:
        if trash_dir:
            os.makedirs(trash_dir, exist_ok=True)
            dst = os.path.join(trash_dir, os.path.basename(path))
            n = 1
            while os.path.exists(dst):
                stem, dot, suffix = os.path.basename(path).rpartition(".")
                dst = os.path.join(trash_dir, f"{stem or suffix}.{n}.{suffix if dot else ''}")
                n += 1
            shutil.move(path, dst)
        else:
            os.unlink(path)
        return True
    except OSError as e:
        warn(f"nuke: cannot remove {path}: {e}")
        return False


def open_path(path: str) -> bool:
    """Open a file with the desktop default application (reference
    DesktopHelper::openImage 'Desktop Default' preset,
    src/qtutil.cpp:416-446).  ``CBIRD_OPEN_CMD`` overrides
    the launcher, mirroring the reference's configurable program table."""
    import shlex
    import subprocess
    override = os.environ.get("CBIRD_OPEN_CMD")
    if override:
        cmd = shlex.split(override) + [path]
    else:
        for launcher in ("xdg-open", "open", "start"):
            if shutil.which(launcher):
                cmd = [launcher, path]
                break
        else:
            warn("open: no desktop launcher found (set CBIRD_OPEN_CMD)")
            return False
    try:
        subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
        return True
    except OSError as e:
        warn(f"open: {e}")
        return False


def reveal_path(path: str) -> bool:
    """Reveal a file in the system file manager, selecting it when the
    manager supports it (reference DesktopHelper::revealPath,
    src/qtutil.cpp:379-415).  ``CBIRD_REVEAL_CMD``
    overrides; otherwise try select-capable managers, then fall back to
    opening the containing directory (the reference's DesktopServices
    fallback opens the dir too)."""
    import shlex
    import subprocess
    override = os.environ.get("CBIRD_REVEAL_CMD")
    candidates = ([shlex.split(override) + [path]] if override else
                  [["nautilus", "-s", path],
                   ["dolphin", "--select", path],
                   ["open", "-R", path]])
    for cmd in candidates:
        if shutil.which(cmd[0]):
            try:
                subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
                return True
            except OSError:
                continue
    return open_path(os.path.dirname(os.path.abspath(path)) or ".")


def nuke(db, selection: list[Media]) -> int:
    """Delete selected files (trash) and drop them from the index."""
    removed_ids = []
    for m in selection:
        if m.is_archived():
            warn(f"nuke: refusing to delete archive member: {m.path}")
            continue
        if trash_file(m.path):
            if m.id:
                removed_ids.append(m.id)
    if removed_ids:
        db.remove(removed_ids)
    return len(removed_ids)


def nuke_dups_in(db, groups: list[MediaGroup], path_prefix: str) -> int:
    """Delete dups under path_prefix, record them as weeds of the kept copy
    (reference -nuke-dups-in)."""
    victims = []
    for g in groups:
        inside = [m for m in g if m.path.startswith(path_prefix)]
        outside = [m for m in g if not m.path.startswith(path_prefix)]
        if inside and outside:
            for v in inside:
                db.add_weed(v, outside[0])
                victims.append(v)
    return nuke(db, victims)


def nuke_weeds(db) -> int:
    """Delete all indexed files previously recorded as weeds."""
    victims = [m for m in db.all_media() if db.is_weed(m)]
    return nuke(db, victims)
