"""``cbird-torch``: the cbird command line on the PyTorch / CUDA port.

A copy of the JAX package's interpreter (``cbird_tpu/cli/main.py``): a
positional, order-sensitive interpreter in which each argument mutates
shared state (index dir, SearchParams, IndexParams, the current selection
and query result), so ``cbird-torch -use dir -update -similar -dump`` scans
then searches then prints.  Saved-argument files are honored like the
reference (~/.config/cbird/args.txt then <index>/_index/args.txt then the
command line).

The port's ``Engine`` runs behind it, and ``-about`` reports torch and
the CUDA device.  Every verb of the JAX package's interpreter runs here,
``-p.tm``, ``-serve`` (and ``-similar-to`` routed to it by
``CBIRD_SERVER``) and ``-browse`` included.

The device is CUDA unless ``CBIRD_TORCH_DEVICE=cpu`` selects the CPU.
Run as ``cbird-torch ...`` or ``python -m cbird_tpu_torch.cli.main ...``.
"""

from __future__ import annotations

import json
import os
import shlex
import sys

import torch

from .. import __version__
from ..host.engine import Engine
from ..params import IndexParams, ParamError, SearchParams
from ..store.media import Media, group_by, sort_group_list
from ..utils.log import error, info, set_verbosity, warn

USAGE = """cbird-tpu VERSION — TPU-native content-based image/video duplicate finder

usage: cbird [args...]   (arguments are executed in order)

  index:
    -use <dir>          select index directory (default: cwd)
    -create             create an index in the selected directory
    -update             scan for new/changed/removed files and index them
    -remove <selector>  remove selection from the index (not files)
    -vacuum             compact databases
    -verify             re-check md5 of every indexed file
    -updatemd5          upgrade legacy sparse video md5s in the selection to full md5s
    -migrate            upgrade legacy v1 .vdx video files (-i.dryrun previews)
    -jpeg-repair-script <s>  hook -verify runs on damaged jpegs

  search:
    -similar            find similar groups within the whole index
    -similar-to <file>  find items similar to file/dir (needle)
    -dups               find exact duplicates (md5)

  search scopes:
    -similar-in <dir>   -similar within a subdirectory only
    -dups-in <dir>      -dups within a subdirectory only

  selection/results:
    -select-all         select all indexed media
    -select-path <dir>  select indexed media under directory
    -select-type <t>    select by type (i,v,a)
    -select-id <n>      select by media id
    -select-one <file>  select a single indexed file
    -select-none        clear selection
    -select-result      selection = flattened current result
    -select-errors      select files that failed indexing
    -weeds              select media recorded as weeds
    -with <prop> <expr>    filter selection/results by expression
    -without <prop> <expr> inverse filter (keep non-matching)
    -or-with[out] <p> <e>  add an OR alternative to the last filter
    -slice <selector>   restrict subsequent searches to a selection
    -sort[-rev] <prop>  sort selection items, or result groups by needle
    -sort-result[-rev] <prop>  sort result groups by first member
    -sort-similar       order selection by hash similarity (greedy chain)
    -merge <sel> <sel>  merge two selections by similarity (first is sorted)
    -group-by <prop>    group current selection by property expression
    -head <n> / -tail <n>  keep first/last n groups
    -first / -chop      keep only the first group / drop the first item
    -first-sibling      keep one selected item per directory
    -browse             interactive web browser for results (delete/weed
                        actions write back to the index; Quit to exit)
    -max-per-page <n>   groups per page in -browse (default 12)
    -serve              resident query daemon (index and kernels loaded
                        on the card; CBIRD_SERVE_ADDR=host:port to bind,
                        clients set CBIRD_SERVER=host:port)
    -dump               print result groups as text
    -json               print result groups as JSON
    -count              print number of groups/items

  file operations:
    -rename <find> <replace> [opts]  regex rename selection (captures #n,
                        sequence %n, {prop} templates; opts: v=verbose, p=match path)
    -move <dir>         move selection into directory (index preserved)
    -nuke               delete selected files (CBIRD_TRASH_DIR honored)
    -nuke-dups-in <dir> delete dups under dir, keep copies elsewhere (records weeds)
    -nuke-weeds         delete all known weeds

  parameters:
    -p.<key> <value>    search parameter (see -list-params)
    -i.<key> <value>    index parameter (see -list-index-params)
    -list-params        show search parameters
    -list-index-params  show index parameters

  reports:
    -show               write an HTML report of the current result
    -select-grid <file> split a collage grid into cell images and select them
    -qualityscore       print no-reference quality score per selected item
    -video-thumbnail <file> <frame>  save frame png + index thumb.png
    -compare-videos <a> <b>          export temporally aligned frame pairs

  diagnostics:
    -test-csv <file>    needle,expected-match accuracy harness (alias -simtest)
    -test-image-search  re-hash every selected image, report self-recall
    -test-update        scripted start/stop/finish update cycle (consistency check)
    -test-image-loader <file>   decode timing/info for one image
    -test-video-decoder <file>  decode timing/info for one video (alias -test-video)
    -select-sql <where> select media rows by SQL where clause
    -select-files <f..> select literal files (indexed or not)
    -license            print license

  misc:
    -about              versions and limits
    -args <file>        insert arguments from file
    -complete <shell>   print shell completion script
    -v / -q             verbose / quiet logging
    -h, -help           this text
""".replace("VERSION", __version__)


# every verb _dispatch takes, in its single-dash spelling (the list
# -complete offers; tests/test_torch_slice.py holds it equal to the
# dispatch)
_KNOWN_VERBS = [
    "-use", "-create", "-update", "-updatemd5", "-remove", "-vacuum",
    "-verify", "-migrate", "-test-update",
    "-similar", "-similar-to", "-similar-in", "-dups", "-dups-in",
    "-select-all", "-select-path", "-select-type", "-select-id", "-select-one",
    "-select-none", "-select-result", "-select-errors", "-weeds",
    "-with", "-without", "-or-with", "-or-without", "-slice", "-add-video",
    "-install", "-sort", "-sort-rev", "-sort-result",
    "-sort-result-rev", "-sort-similar", "-merge", "-group-by", "-head", "-tail",
    "-first", "-first-sibling", "-chop", "-dump", "-json", "-count", "-show",
    "-browse", "-max-per-page", "-serve", "-sets", "-folders",
    "-exit-on-select", "-headless", "-no-delete", "-focus-first",
    "-show-results", "-theme",
    "-test-csv", "-simtest", "-test-image-search", "-test-image-loader",
    "-test-video-decoder", "-test-video", "-select-files", "-select-sql",
    "-select-grid",
    "-list-formats", "-list-codecs", "-qualityscore", "-jpeg-repair-script",
    "-rename", "-move", "-nuke", "-nuke-dups-in", "-nuke-weeds",
    "-video-thumbnail", "-compare-videos",
    "-list-params", "-list-search-params", "-list-index-params", "-about",
    "-args", "-complete", "-license",
    "-v", "-q", "-h", "-help", "-version",
]


class Cli:
    def __init__(self, device=None):
        self._device = device
        self.index_dir = os.getcwd()
        self.search = SearchParams()
        self.index = IndexParams()
        self.selection: list[Media] = []
        self.result: list[list[Media]] = []
        self._engine = None
        self._max_per_page = 12  # reference default (src/main.cpp:1671-1719)
        self._show_mode = "normal"  # -sets → sets, -folders → folders
        self._exit_on_select = False  # -exit-on-select: rc = selected index
        self._rc = 0  # run() exit code override (browse select)
        self._sort_chain: list[tuple[str, bool]] = []  # multisort keys

    # lazy engine (reference lazy global Engine&, src/main.cpp:540-559)
    def engine(self):
        if self._engine is None:
            idx = os.path.join(self.index_dir, "_index")
            if not os.path.isdir(idx):
                error(f"no index found in {self.index_dir} (use -create)")
                sys.exit(2)
            self._engine = Engine(self.index_dir, self.index, self._device)
        return self._engine

    def run(self, args: list[str]) -> int:
        args = self._inject_saved_args(args)
        i = 0
        try:
            from ..utils.log import profile_stage
            while i < len(args):
                # per-verb wall attribution under CBIRD_PROFILE: together
                # with the store/kernel stages this accounts for the whole
                # CLI process (VERDICT r04 #1)
                with profile_stage(f"verb {args[i]}"):
                    i = self._dispatch(args, i)
        except ParamError as e:
            error(str(e))
            return 2
        except (FileNotFoundError, KeyError) as e:
            error(str(e))
            return 2
        return self._rc

    def _inject_saved_args(self, args: list[str]) -> list[str]:
        out: list[str] = []
        for f in (os.path.expanduser("~/.config/cbird/args.txt"),
                  os.path.join(self.index_dir, "_index", "args.txt")):
            if os.path.isfile(f):
                with open(f) as fh:
                    for line in fh:
                        line = line.strip()
                        if line and not line.startswith("#"):
                            out += shlex.split(line)
        return out + args

    def _need(self, args: list[str], i: int, what: str) -> str:
        if i + 1 >= len(args):
            raise ParamError(f"{args[i]} requires {what}")
        return args[i + 1]

    # ---- dispatch --------------------------------------------------------
    def _dispatch(self, args: list[str], i: int) -> int:
        a = args[i]
        if a in ("-h", "-help", "--help"):
            print(USAGE)
            return i + 1
        if a in ("-version", "--version"):
            print(__version__)
            return i + 1
        if a == "-v":
            set_verbosity("debug")
            self.search.verbose = True
            self.index.verbose = True
            return i + 1
        if a == "-q":
            set_verbosity("error")
            return i + 1
        if a == "-about":
            self._about()
            return i + 1
        if a == "-args":
            f = self._need(args, i, "a file")
            with open(f) as fh:
                extra = []
                for line in fh:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        extra += shlex.split(line)
            args[i + 2:i + 2] = extra
            return i + 2

        if a.startswith("-p."):
            self.search.set_param(a[3:], self._need(args, i, "a value"))
            return i + 2
        if a.startswith("-i."):
            self.index.set_param(a[3:], self._need(args, i, "a value"))
            return i + 2
        if a in ("-list-params", "-list-search-params"):
            print(self.search.help_text())
            return i + 1
        if a == "-list-index-params":
            print(self.index.help_text())
            return i + 1

        if a == "-use":
            d = self._need(args, i, "a directory")
            if not os.path.isdir(d):
                raise FileNotFoundError(f"directory does not exist: {d}")
            self.index_dir = os.path.abspath(d)
            self._engine = None
            return i + 2
        if a == "-create":
            os.makedirs(os.path.join(self.index_dir, "_index"), exist_ok=True)
            self._engine = Engine(self.index_dir, self.index, self._device)
            info(f"created index in {self.index_dir}")
            return i + 1
        if a == "-update":
            from ..utils.env import set_idle_priority
            set_idle_priority()
            stats = self.engine().update()
            info(f"added {stats['added']}, removed {stats['removed']}, "
                 f"modified {stats['modified']}, errors {len(stats['errors'])}")
            return i + 1
        if a == "-jpeg-repair-script":
            self._jpeg_repair_script = self._need(args, i, "a script")
            return i + 2
        if a == "-vacuum":
            self.engine().db.vacuum()
            return i + 1
        if a == "-updatemd5":
            self._update_md5()
            return i + 1
        if a == "-remove":
            sel = self._need(args, i, "a selector")
            media = self._select(sel)
            self.engine().db.remove([m.id for m in media if m.id])
            info(f"removed {len(media)} items from index")
            return i + 2

        if a == "-verify":
            self._verify()
            return i + 1

        if a == "-similar":
            self.result = self.engine().db.similar(self.search)
            info(f"{len(self.result)} groups")
            return i + 1
        if a == "-similar-to":
            target = os.path.abspath(self._need(args, i, "a file"))
            server = os.environ.get("CBIRD_SERVER")
            if server and not os.path.isdir(target):
                # route to a resident -serve daemon: the index and
                # the kernels stay loaded there
                from .serve import QueryClient, remote_groups_to_media
                c = QueryClient(server)
                try:
                    overrides = {k: v for k, v in self.search.changed_kv()}
                    self.result = remote_groups_to_media(
                        c.query(target, **overrides))
                finally:
                    c.close()
                info(f"{sum(len(g) - 1 for g in self.result)} matches")
                return i + 2
            if os.path.isdir(target):
                # directory needle: query every indexed file under it
                # (reference -similar-to <dir>, src/main.cpp:1104-1263)
                needles = [m for m in self.engine().db.all_media()
                           if m.path.startswith(target + os.sep)]
                self.result = []
                for needle in needles:
                    group = self.engine().query(needle, self.search)
                    if group:
                        self.result.append([needle] + group)
                self.result = self.engine().db.filter_matches(self.search,
                                                              self.result)
            else:
                # prefer the indexed record so the needle carries id/md5/hash
                needle = self.engine().db.media_with_path(target)
                if not needle.is_valid():
                    needle = Media(target)
                group = self.engine().query(needle, self.search)
                self.result = [[needle] + group] if group else []
            info(f"{sum(len(g) - 1 for g in self.result)} matches")
            return i + 2
        if a == "-dups":
            self.result = self.engine().db.dups_by_md5(self.search)
            info(f"{len(self.result)} duplicate groups")
            return i + 1

        if a == "-similar-in":
            d = self._need(args, i, "a directory")
            prefix = os.path.abspath(os.path.join(self.index_dir, d))
            sp = self.search.copy()
            sp.set = [m for m in self.engine().db.all_media()
                      if m.path.startswith(prefix)]
            sp.inSet = True
            self.result = self.engine().db.similar(sp)
            info(f"{len(self.result)} groups")
            return i + 2
        if a == "-dups-in":
            d = self._need(args, i, "a directory")
            prefix = os.path.abspath(os.path.join(self.index_dir, d))
            groups = self.engine().db.dups_by_md5(self.search)
            self.result = [g for g in groups
                           if any(m.path.startswith(prefix) for m in g)]
            info(f"{len(self.result)} duplicate groups")
            return i + 2

        if a in ("-with", "-without", "-or-with", "-or-without"):
            from .commands import filter_groups, filter_selection
            prop = self._need(args, i, "a property")
            if i + 2 >= len(args):
                raise ParamError(f"{a} requires <prop> <expr>")
            expr = args[i + 2]
            neg = "without" in a
            if a in ("-with", "-without"):
                self._prefilter = (list(self.selection), [list(g) for g in self.result])
                if self.selection:
                    self.selection = filter_selection(self.selection, prop,
                                                      expr, negate=neg)
                    self.result = [self.selection] if self.selection else []
                else:
                    self.result = filter_groups(self.result, prop, expr,
                                                negate=neg)
            else:
                if not hasattr(self, "_prefilter"):
                    raise ParamError(f"{a} requires a preceding -with[out]")
                sel0, res0 = self._prefilter
                if sel0:
                    extra = filter_selection(sel0, prop, expr, negate=neg)
                    seen = {m.path for m in self.selection}
                    self.selection += [m for m in extra if m.path not in seen]
                    self.result = [self.selection] if self.selection else []
                else:
                    extra = filter_groups(res0, prop, expr, negate=neg)
                    seen = {tuple(m.path for m in g) for g in self.result}
                    self.result += [g for g in extra
                                    if tuple(m.path for m in g) not in seen]
            return i + 3

        if a == "-rename":
            from .commands import rename
            find = self._need(args, i, "<find> <replace>")
            if i + 2 >= len(args):
                raise ParamError("-rename requires <find> <replace>")
            replace = args[i + 2]
            opts = ""
            used = 3
            if i + 3 < len(args) and not args[i + 3].startswith("-"):
                opts = args[i + 3]
                used = 4
            n = rename(self.engine().db, self.selection, find, replace, opts,
                       dry_run=self.index.dryRun)
            info(f"renamed {n} files")
            return i + used
        if a == "-move":
            d = self._need(args, i, "a directory")
            dst = os.path.join(self.index_dir, d) if not os.path.isabs(d) else d
            os.makedirs(dst, exist_ok=True)
            moved = sum(1 for m in list(self.selection)
                        if self.engine().db.move(m, dst))
            info(f"moved {moved} files to {dst}")
            return i + 2
        if a == "-nuke":
            from .commands import nuke
            n = nuke(self.engine().db, self.selection)
            info(f"nuked {n} files")
            self.selection = []
            return i + 1
        if a == "-nuke-dups-in":
            from .commands import nuke_dups_in
            d = self._need(args, i, "a directory")
            prefix = os.path.abspath(os.path.join(self.index_dir, d))
            groups = self.result or self.engine().db.dups_by_md5(self.search)
            n = nuke_dups_in(self.engine().db, groups, prefix)
            info(f"nuked {n} duplicate files under {prefix}")
            return i + 2
        if a == "-nuke-weeds":
            from .commands import nuke_weeds
            n = nuke_weeds(self.engine().db)
            info(f"nuked {n} weeds")
            return i + 1
        if a == "-weeds":
            db = self.engine().db
            self.selection = [m for m in db.all_media() if db.is_weed(m)]
            self.result = [self.selection] if self.selection else []
            return i + 1

        if a == "-select-type":
            t = self._need(args, i, "a type (i,v,a)")
            tmap = {"i": 1, "v": 2, "a": 3}
            if t not in tmap:
                raise ParamError(f"bad type: {t}")
            self.selection = [m for m in self.engine().db.all_media()
                              if m.type == tmap[t]]
            self.result = [self.selection] if self.selection else []
            return i + 2
        if a == "-select-id":
            mid = int(self._need(args, i, "an id"))
            m = self.engine().db.media_with_id(mid)
            self.selection = [m] if m.is_valid() else []
            self.result = [self.selection] if self.selection else []
            return i + 2
        if a == "-select-one":
            f = self._need(args, i, "a file")
            m = self.engine().db.media_with_path(os.path.abspath(f))
            self.selection = [m] if m.is_valid() else []
            self.result = [self.selection] if self.selection else []
            return i + 2
        if a == "-select-sql":
            # e.g. -select-sql "select * from media where width > 1000"
            query = self._need(args, i, "a sql query")
            if not query.strip().lower().startswith("select"):
                raise ParamError("-select-sql only accepts SELECT statements")
            db = self.engine().db
            try:
                rows = db.connect().execute(query).fetchall()
            except Exception as e:  # sqlite3.Error
                raise ParamError(f"sql error: {e}")
            self.selection = []
            for row in rows:
                if len(row) >= 7:
                    m = db._row_to_media(row)
                    m.path = db._abs(m.path)
                    self.selection.append(m)
                elif len(row) >= 1:
                    m = db.media_with_id(row[0])
                    if m.is_valid():
                        self.selection.append(m)
            self.result = [self.selection] if self.selection else []
            return i + 2
        if a == "-select-files":
            # consume all following non-dash args as file paths
            files = []
            j = i + 1
            while j < len(args) and not args[j].startswith("-"):
                files.append(os.path.abspath(args[j]))
                j += 1
            if not files:
                raise ParamError("-select-files requires at least one file")
            db = self.engine().db
            self.selection = []
            for f in files:
                m = db.media_with_path(f)
                self.selection.append(m if m.is_valid() else Media(f))
            self.result = [self.selection]
            return j
        if a == "-select-none":
            self.selection = []
            return i + 1
        if a == "-select-result":
            self.selection = [m for g in self.result for m in g]
            return i + 1
        if a == "-first":
            self.result = self.result[:1]
            return i + 1
        if a == "-chop":
            # reference: remove the first item (of the selection); on a bare
            # result, drop the first group
            if self.selection:
                self.selection = self.selection[1:]
                self.result = [self.selection] if self.selection else []
            else:
                self.result = self.result[1:]
            return i + 1

        if a == "-complete":
            # emit a bash completion script (reference -complete <shell>,
            # src/main.cpp:150-354); a following "bash" or "zsh" is its
            # shell argument and is consumed, any other argument is left to
            # the next verb — only bash syntax is emitted (usable from zsh
            # via bashcompinit)
            shell = ""
            if i + 1 < len(args) and args[i + 1] in ("bash", "zsh"):
                shell = args[i + 1]
            verbs = sorted(_KNOWN_VERBS)
            p_keys = " ".join(f"-p.{s.key}" for s in self.search.SPECS)
            i_keys = " ".join(f"-i.{s.key}" for s in self.index.SPECS)
            print(f"""# bash completion for cbird (source this file)
_cbird_complete() {{
  local cur="${{COMP_WORDS[COMP_CWORD]}}"
  COMPREPLY=( $(compgen -W "{' '.join(verbs)} {p_keys} {i_keys}" -- "$cur") )
  [ -z "$COMPREPLY" ] && COMPREPLY=( $(compgen -f -- "$cur") )
}}
complete -F _cbird_complete cbird""")
            return i + 2 if shell else i + 1

        if a == "-video-thumbnail":
            f = self._need(args, i, "<file> <frame>")
            if i + 2 >= len(args):
                raise ParamError("-video-thumbnail requires <file> <frame>")
            frame_no = int(args[i + 2])
            self._video_thumbnail(os.path.abspath(f), frame_no)
            return i + 3
        if a == "-compare-videos":
            f1 = self._need(args, i, "<a> <b>")
            if i + 2 >= len(args):
                raise ParamError("-compare-videos requires two files")
            self._compare_videos(os.path.abspath(f1),
                                 os.path.abspath(args[i + 2]))
            return i + 3
        if a == "-select-grid":
            # split a collage/mosaic file into cell images next to it
            f = self._need(args, i, "an image file")
            self._select_grid(os.path.abspath(f))
            return i + 2

        if a == "-qualityscore":
            from ..ops.quality import quality_score
            from ..store.jpeg_quality import estimate_jpeg_quality
            from ..host.scanner import read_bytes
            from PIL import Image as PILImage
            import io as _io
            import numpy as _np
            for m in (self.selection or [x for g in self.result for x in g]):
                try:
                    data = read_bytes(m.path)
                    img = _np.asarray(PILImage.open(_io.BytesIO(data)).convert("RGB"))
                    score = quality_score(img)
                    jq = estimate_jpeg_quality(data)
                    jq_txt = f" jpeg-quality={jq}" if jq is not None else ""
                    print(f"{m.path} quality={score}{jq_txt}")
                except Exception as e:  # noqa: BLE001 — per-file diagnostics
                    warn(f"qualityscore: {m.path}: {e}")
            return i + 1

        if a == "-migrate":
            self._migrate()
            return i + 1

        if a == "-select-all":
            self.selection = self.engine().db.all_media()
            self.result = [self.selection] if self.selection else []
            return i + 1
        if a == "-select-path":
            d = self._need(args, i, "a directory")
            prefix = os.path.abspath(os.path.join(self.index_dir, d))
            self.selection = [m for m in self.engine().db.all_media()
                              if m.path.startswith(prefix)]
            self.result = [self.selection] if self.selection else []
            return i + 2
        if a == "-select-errors":
            errs = self.engine().scanner.errors()
            self.selection = [Media(p) for p in errs]
            self.result = [[Media(p)] for p in sorted(errs)]
            return i + 1

        if a in ("-sort", "-sort-rev"):
            prop = self._need(args, i, "a property")
            rev = a.endswith("-rev") or prop.startswith("^")
            prop = prop.lstrip("^")
            # multisort: another -sort immediately after adds a SECONDARY
            # key (reference usage.txt:88-91) — accumulate and re-apply as
            # stable sorts from least- to most-significant key
            if i >= 2 and args[i - 2] in ("-sort", "-sort-rev"):
                self._sort_chain.append((prop, rev))
            else:
                self._sort_chain = [(prop, rev)]
            if self.selection:
                from ..store.media import sort_group
                for p, r in reversed(self._sort_chain):
                    sort_group(self.selection, [p], reverse=r)
                self.result = [self.selection]
            else:
                sort_group_list(self.result, [prop])
                if rev:
                    self.result.reverse()
            return i + 2
        if a in ("-sort-result", "-sort-result-rev"):
            prop = self._need(args, i, "a property")
            sort_group_list(self.result, [prop])
            if a.endswith("-rev"):
                self.result.reverse()
            return i + 2
        if a == "-sort-similar":
            self._sort_similar()
            return i + 1
        if a == "-merge":
            sel_a = self._need(args, i, "two selectors")
            if i + 2 >= len(args):
                raise ParamError("-merge requires two selectors")
            self._merge(sel_a, args[i + 2])
            return i + 3
        if a == "-first-sibling":
            seen_dirs = set()
            kept = []
            for m in (self.selection or [x for g in self.result for x in g]):
                d = m.dir_path()
                if d not in seen_dirs:
                    seen_dirs.add(d)
                    kept.append(m)
            self.selection = kept
            self.result = [kept] if kept else []
            return i + 1
        if a == "-group-by":
            prop = self._need(args, i, "a property expression")
            flat = [m for g in self.result for m in g] or self.selection
            self.result = group_by(flat, prop)
            return i + 2
        if a == "-head":
            n = int(self._need(args, i, "a number"))
            self.result = self.result[:n]
            return i + 2
        if a == "-tail":
            n = int(self._need(args, i, "a number"))
            self.result = self.result[-n:] if n else []
            return i + 2

        if a == "-show":
            from .report import write_report
            out = os.environ.get("CBIRD_REPORT",
                                 os.path.join(self.index_dir, "cbird-results.html"))
            write_report(self.result, out, title=f"cbird {self.index_dir}")
            return i + 1
        if a == "-serve":
            # resident query daemon: the index and the kernels stay loaded
            # on the engine's device (clients route via CBIRD_SERVER)
            from .serve import parse_hostport, serve_cli
            addr = os.environ.get("CBIRD_SERVE_ADDR", "127.0.0.1:0")
            try:
                host, port = parse_hostport(addr)
            except ValueError as e:
                raise ParamError(str(e)) from None
            serve_cli(self.engine(), host, port)
            return i + 1
        if a == "-browse":
            from .browser import serve_browser
            sel = serve_browser(
                self.engine().db, self.result,
                title=f"cbird {self.index_dir}",
                port=int(os.environ.get("CBIRD_BROWSER_PORT", "0")),
                max_per_page=self._max_per_page,
                engine=self.engine(), mode=self._show_mode,
                exit_on_select=self._exit_on_select)
            if self._exit_on_select:
                # reference: select exits with the index, < 0 if canceled
                self._rc = -1 if sel is None else int(sel)
            return i + 1

        if a in ("-test-csv", "-simtest"):  # -simtest: legacy usage.txt name
            from .testcsv import run_test_csv
            f = self._need(args, i, "a csv file")
            stats = run_test_csv(self.engine(), self.search, f)
            if stats["fail"]:
                raise ParamError(f"test-csv: {stats['fail']} failures")
            return i + 2

        if a == "-dump":
            self._dump_text()
            return i + 1
        if a == "-json":
            self._dump_json()
            return i + 1
        if a == "-count":
            items = sum(len(g) for g in self.result)
            print(f"{len(self.result)} groups, {items} items")
            return i + 1

        if a == "-test-update":
            self._test_update()
            return i + 1
        if a == "-test-image-loader":
            f = self._need(args, i, "an image file")
            import time
            from ..host.scanner import Scanner
            sc = Scanner(self.index, device=self._device)
            t0 = time.monotonic()
            d = sc.decode_image(os.path.abspath(f), want_color=True)
            dt = (time.monotonic() - t0) * 1000
            if d.error:
                raise ParamError(f"decode failed: {d.error}")
            print(f"{f}: {d.width}x{d.height} -> gray {d.gray.shape[1]}x"
                  f"{d.gray.shape[0]} md5={d.md5} {dt:.1f} ms")
            return i + 2
        if a == "-test-image-search":
            self._test_image_search()
            return i + 1
        if a in ("-test-video-decoder", "-test-video"):
            f = self._need(args, i, "a video file")
            import time
            from ..host.video import backend_for
            be = backend_for(os.path.abspath(f))
            if be is None:
                raise ParamError(f"no decode backend for {f}")
            t0 = time.monotonic()
            n = 0
            shape = None
            for frame in be.frames(os.path.abspath(f)):
                n += 1
                shape = frame.shape
            dt = time.monotonic() - t0
            print(f"{f}: {n} frames {shape} in {dt:.2f}s "
                  f"({n / max(dt, 1e-9):.0f} fps)")
            return i + 2
        if a in ("-list-formats", "-list-codecs"):
            from ..host.scanner import ARCHIVE_EXTS, IMAGE_EXTS, VIDEO_EXTS
            from ..host.video import FfmpegBackend
            print("images:", " ".join(sorted(IMAGE_EXTS)))
            print("archives:", " ".join(sorted(ARCHIVE_EXTS)))
            vids = sorted(VIDEO_EXTS) if FfmpegBackend.available() else ["fseq"]
            print("videos:", " ".join(vids),
                  "" if FfmpegBackend.available() else "(ffmpeg not found)")
            return i + 1
        if a in ("-license", "--license"):
            lic = os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))), "LICENSE")
            print(open(lic).read() if os.path.exists(lic)
                  else "Apache License 2.0")
            return i + 1

        # GUI-only verbs: accepted for cbird script compatibility, no-ops in
        # this headless build (the -show HTML report replaces the browser)
        if a == "-slice":
            # scope subsequent searches to a selection (reference -slice,
            # src/main.cpp:1333-1335: params.set + inSet → Index::slice)
            sel = self._need(args, i, "a selector")
            self.search.set = self._select(sel)
            self.search.inSet = True
            return i + 2
        if a == "-add-video":
            # index exactly one video (the reference uses this for forked
            # hw-decode isolation, src/scanner.cpp:1132-1177; here it is a
            # scripting convenience)
            f = os.path.abspath(self._need(args, i, "a video file"))
            from ..host.video import process_video
            eng = self.engine()
            m = process_video(f, self.index, video_dir=eng.db.video_path(),
                              device=eng.device)
            if m is None:
                raise ParamError(f"cannot index video: {f}")
            eng.db.add([m])
            info(f"added {f} ({len(m.videoIndex.frames)} retained frames)")
            return i + 2
        if a == "-install":
            warn("-install: desktop integration is not applicable to this "
                 "headless build")
            return i + 1
        if a in ("-sets", "-folders"):
            # browser view modes (reference MediaBrowser::ShowPairs /
            # ShowFolders, src/gui/mediabrowser.h:30-34)
            self._show_mode = "sets" if a == "-sets" else "folders"
            return i + 1
        if a == "-exit-on-select":
            self._exit_on_select = True
            return i + 1
        _GUI_NOARG = {"-headless",
                      "-no-delete", "-first-sibling", "-focus-first",
                      "-show-results"}
        _GUI_ONEARG = {"-theme"}
        if a == "-max-per-page":
            self._max_per_page = int(self._need(args, i, "a number"))
            return i + 2
        if a in _GUI_NOARG:
            warn(f"{a}: GUI option ignored (headless build; use -show for an "
                 f"HTML report)")
            return i + 1
        if a in _GUI_ONEARG:
            self._need(args, i, "a value")
            warn(f"{a}: GUI option ignored (headless build)")
            return i + 2

        raise ParamError(f"unknown argument: {a} (see -help)")

    # ---- helpers ---------------------------------------------------------
    def _select(self, selector: str) -> list[Media]:
        db = self.engine().db
        if selector == "all":
            return db.all_media()
        path = os.path.abspath(os.path.join(self.index_dir, selector))
        if os.path.isdir(path):
            return [m for m in db.all_media() if m.path.startswith(path)]
        m = db.media_with_path(path)
        return [m] if m.is_valid() else []

    def _about(self) -> None:
        from ..utils.env import process_memory, system_memory
        print(f"cbird-tpu-torch {__version__}")
        dev = "cpu"
        if torch.cuda.is_available():
            dev = (f"{torch.cuda.get_device_name(0)} "
                   f"(x{torch.cuda.device_count()})")
        print(f"torch {torch.__version__}; cuda {torch.version.cuda}; "
              f"device: {dev}")
        print("capacity: 2^31 media ids; 2^24 videos; 2^24 frames/video")
        total, avail = system_memory()
        print(f"memory: process {process_memory() >> 20} MB; "
              f"system {avail >> 20}/{total >> 20} MB available")
        idx = os.path.join(self.index_dir, "_index")
        if os.path.isdir(idx):
            eng = self.engine()
            print(f"index: {idx}")
            print(f"items: {eng.db.count()}")
            algo_names = {0: "dct", 1: "fdct", 2: "orb", 3: "color", 4: "video"}
            for index in eng.db.indexes():
                state = "loaded" if index.is_loaded() else "not loaded"
                print(f"  {algo_names.get(index.id, index.id):>6}: "
                      f"{index.count() if index.is_loaded() else '-'} items, "
                      f"{index.memory_usage()} bytes ({state})")

    def _update_md5(self) -> None:
        """Upgrade legacy sparse video md5s in the selection to full md5s
        (reference -updatemd5, src/main.cpp:1735-1752: only rows whose
        stored md5 still equals the file's SPARSE md5 are upgraded — a
        mismatch means the row already carries a new-style hash, or the
        file changed, and is left alone with a warning)."""
        from ..params import TYPE_VIDEO
        from ..store.ioutil import full_md5_file, sparse_md5_file
        db = self.engine().db
        updated = skipped = 0
        for m in self.selection:
            if m.type != TYPE_VIDEO:
                continue
            try:
                sparse = sparse_md5_file(m.path)
            except OSError as e:
                warn(f"updatemd5: cannot open {m.path}: {e}")
                continue
            if m.md5 != sparse:
                warn(f"updatemd5: no update, hash could be the new version:"
                     f" {m.path} {m.md5}")
                skipped += 1
                continue
            digest = full_md5_file(m.path)
            if not db.set_md5(m, digest) or m.md5 != digest:
                raise ParamError(f"updatemd5: db update failed for {m.path}")
            info(f"updateMd5 {m.path} -> {digest}")
            updated += 1
        info(f"updatemd5: {updated} updated, {skipped} skipped")

    def _test_update(self) -> None:
        """Scripted start/stop/finish update cycle — the headless stand-in
        for the reference's interactive Start/Stop/Finish dialog harness
        (-test-update, src/commands.cpp:1130-1172).  Starts an update,
        requests a graceful stop after the first processed file, verifies
        the database stayed consistent, then finishes the update and
        verifies nothing was lost or double-indexed."""
        eng = self.engine()
        seen = 0

        def stop_after_first(done: int, total: int) -> None:
            nonlocal seen
            seen = done
            if done >= 1:
                eng.stop_update()

        s1 = eng.update(progress=stop_after_first)
        info(f"test-update: start/stop phase added {s1['added']}"
             f" (stopped={s1['stopped']})")
        mid_count = eng.db.count()
        s2 = eng.update()  # finish
        if s2["stopped"]:
            raise ParamError("test-update: finish phase was stopped")
        final = eng.db.count()
        if final < mid_count:
            raise ParamError("test-update: items lost after resume")
        # nothing may remain unindexed or doubly indexed
        s3 = eng.update()
        if s3["added"] or s3["modified"] or s3["removed"]:
            raise ParamError(
                f"test-update: index not stable after finish: {s3}")
        paths = [m.path for m in eng.db.all_media()]
        if len(paths) != len(set(paths)):
            raise ParamError("test-update: duplicate paths indexed")
        info(f"test-update: ok — {final} items, resume added {s2['added']}")

    def _sort_similar(self) -> None:
        """Greedy nearest-neighbor ordering of the selection by dct hash
        (reference -sort-similar)."""
        from ..ops.ref_numpy import hamming64
        items = [m for m in self.selection if m.dctHash]
        if len(items) < 3:
            return
        ordered = [items.pop(0)]
        while items:
            cur = int(ordered[-1].dctHash)
            best = min(range(len(items)),
                       key=lambda j: hamming64(cur, int(items[j].dctHash)))
            ordered.append(items.pop(best))
        self.selection = ordered
        self.result = [ordered]

    def _verify(self) -> None:
        """Re-check stored md5 of every indexed file (reference -verify,
        src/commands.cpp:574-638)."""
        from ..store.ioutil import image_content_md5
        from ..host.scanner import read_bytes
        db = self.engine().db
        bad = 0
        for m in db.all_media():
            try:
                data = read_bytes(m.path)
            except (OSError, KeyError):
                warn(f"missing: {m.path}")
                bad += 1
                continue
            if m.type == Media.TypeImage:
                digest, _, _ = image_content_md5(data)
            else:
                from ..store.ioutil import full_md5
                digest = full_md5(data)
            if digest != m.md5:
                warn(f"md5 mismatch: {m.path}")
                bad += 1
                # optional repair hook for damaged jpegs (reference -verify
                # + -jpeg-repair-script, src/commands.cpp:574-638)
                script = getattr(self, "_jpeg_repair_script", None)
                if script and m.suffix() in ("jpg", "jpeg"):
                    import subprocess
                    try:
                        subprocess.run([script, m.path], timeout=120, check=False)
                    except (OSError, subprocess.SubprocessError) as e:
                        warn(f"repair script failed: {e}")
        info(f"verify: {bad} problems in {db.count()} items")

    def _test_image_search(self) -> None:
        """Self-recall harness (reference -test-image-search): re-decode
        and re-process every selected image as an unindexed needle, query
        each of dct, fdct and orb, and report hit rate and score / rank
        statistics.  A 100% hit rate means the decode -> hash -> search
        path reproduces the index bit for bit."""
        eng = self.engine()
        items = [m for m in (self.selection or eng.db.all_media())
                 if m.type == Media.TypeImage]
        if not items:
            warn("test-image-search: no image selection")
            return
        print("| algo | hit | miss | miss% | score avg/min/max | rank avg/max |")
        failures = 0
        for algo in (0, 1, 2):
            sp = self.search.copy()
            sp.algo = algo
            hit = miss = 0
            scores: list[int] = []
            ranks: list[int] = []
            for m in items:
                fresh = eng.scanner.process_image_file(m.path, 1 << algo)
                if fresh is None:
                    miss += 1
                    continue
                matches = eng.query(fresh, sp)
                rank = next((r for r, x in enumerate(matches)
                             if x.id == m.id or x.path == m.path), -1)
                if rank < 0:
                    miss += 1
                else:
                    hit += 1
                    scores.append(matches[rank].score)
                    ranks.append(rank)
            total = hit + miss
            avg_s = sum(scores) / hit if hit else 0
            avg_r = sum(ranks) / hit if hit else 0
            print(f"| {('dct', 'fdct', 'orb')[algo]:>4} | {hit:3d} | {miss:3d} "
                  f"| {miss * 100.0 / total:5.1f} "
                  f"| {avg_s:.2f}/{min(scores, default=0)}/{max(scores, default=0)} "
                  f"| {avg_r:.2f}/{max(ranks, default=0)} |")
            failures += miss
        if failures:
            warn(f"test-image-search: {failures} misses")

    def _merge(self, sel_a: str, sel_b: str) -> None:
        """Merge selection B into (sorted) selection A by similarity
        (reference -merge): each B item is searched against the merged
        list with per-algo escalation (accept when the best score beats
        the algo's threshold: dct 12, fdct/orb 1000, color always), then
        inserted next to its closest match; before/after is decided by dct
        distance to the neighbors."""
        from ..ops.ref_numpy import hamming64
        merged = self._select(sel_a)
        set_b = self._select(sel_b)
        thresholds = (12, 1000, 1000, 1 << 31)
        eng = self.engine()
        unmatched = 0
        for b in set_b:
            best = None
            for algo in range(4):
                sp = self.search.copy()
                sp.algo = algo
                sp.maxMatches = 2
                sp.set = merged + [b]
                sp.inSet = True
                matches = [m for m in eng.query(b, sp)
                           if any(x.path == m.path for x in merged)]
                if matches and matches[0].score < thresholds[algo]:
                    best = matches[0]
                    break
            if best is None:
                warn(f"merge: no match: {b.path}")
                unmatched += 1
                continue
            pos = next(j for j, x in enumerate(merged) if x.path == best.path)
            if 0 < pos < len(merged) - 1:
                nb = int(b.dctHash or 0)
                before = hamming64(nb, int(merged[pos - 1].dctHash or 0))
                after = hamming64(nb, int(merged[pos + 1].dctHash or 0))
                if after < before:
                    pos += 1
            merged.insert(pos, b)
        if unmatched:
            warn(f"merge: {unmatched} items could not be placed")
        self.selection = merged
        self.result = [merged] if merged else []

    def _select_grid(self, path: str) -> None:
        """Detect a collage grid and write each cell as its own image
        (reference -select-grid / demosaicHough)."""
        import io as _io
        import numpy as _np
        from PIL import Image as PILImage
        from ..host.scanner import read_bytes
        from ..ops.demosaic import brightness_contrast_auto, demosaic_rects
        img = PILImage.open(_io.BytesIO(read_bytes(path))).convert("RGB")
        arr = _np.asarray(img)
        gray = _np.asarray(img.convert("L"))
        rects = demosaic_rects(brightness_contrast_auto(gray))
        if not rects:
            warn(f"no grid detected in {path}")
            return
        stem, _, suffix = os.path.basename(path).rpartition(".")
        outdir = os.path.dirname(path)
        self.selection = []
        for n, (t, b, l, r) in enumerate(rects):
            out = os.path.join(outdir, f"{stem}-cell{n:02d}.{suffix or 'png'}")
            PILImage.fromarray(arr[t:b, l:r]).save(out)
            self.selection.append(Media(out))
        self.result = [self.selection]
        info(f"wrote {len(rects)} cells from {path}")

    def _video_thumbnail(self, path: str, frame_no: int) -> None:
        """Save one decoded frame as <name>-frame<N>.png, and, when an
        index exists, write it as the collection thumbnail
        ``<root>/thumb.png`` with provenance metadata (reference
        -video-thumbnail, src/main.cpp:1790-1800)."""
        from PIL import Image
        from ..host.video import grab_frame
        frame = grab_frame(path, frame_no)
        if frame is None:
            raise ParamError(f"cannot grab frame {frame_no} of {path}")
        img = Image.fromarray(frame)
        out = os.path.splitext(path)[0] + f"-frame{frame_no}.png"
        img.save(out)
        info(f"wrote {out}")
        if os.path.isdir(os.path.join(self.index_dir, "_index")):
            from ..store.thumbnail import save_index_thumb
            # provenance (id/md5/dct) always comes from the index, as the
            # reference's unconditional mediaWithPath (src/main.cpp:1793)
            media = self.engine().db.media_with_path(path)
            rel = os.path.relpath(path, self.index_dir)
            tp = save_index_thumb(self.index_dir, img, rel_path=rel,
                                  frame=frame_no, media=media)
            info(f"wrote {tp}")

    def _compare_videos(self, a: str, b: str) -> None:
        """Align two videos by their hash sequences and export matched frame
        pairs side by side (headless stand-in for the reference
        VideoCompareWidget)."""
        import numpy as np
        from PIL import Image
        from ..host.video import backend_for, grab_frame, make_video_index
        from ..ops.ref_numpy import hamming64
        pair = []
        fps = []
        for p in (a, b):
            be = backend_for(p)
            if be is None:
                raise ParamError(f"no decode backend for {p}")
            fps.append(be.probe(p).get("fps") or 25.0)
            pair.append(make_video_index(be.frames(p),
                                         self.index.videoThreshold,
                                         device=self._device))
        ia, ib = pair
        # best alignment: for a few reference frames of A find nearest in B
        alignments = []
        for k in range(0, len(ia.frames), max(1, len(ia.frames) // 9)):
            ha = int(ia.hashes[k])
            dists = [hamming64(ha, int(h)) for h in ib.hashes]
            j = int(np.argmin(dists))
            alignments.append((int(ia.frames[k]), int(ib.frames[j]), dists[j]))
        offset = int(np.median([bf - af for af, bf, _ in alignments]))
        print(f"alignment offset: {offset:+d} frames "
              f"(median of {len(alignments)} probes)")
        for af, bf, d in alignments:
            print(f"  A frame {af} <-> B frame {bf} (distance {d})")
        # export the middle matched pair for visual check
        mid = alignments[len(alignments) // 2]
        out = os.path.join(os.path.dirname(a) or ".", "compare.png")
        fa = grab_frame(a, mid[0])
        fb = grab_frame(b, mid[1])
        if fa is not None and fb is not None:
            h = max(fa.shape[0], fb.shape[0])
            w = fa.shape[1] + fb.shape[1] + 8
            canvas = np.zeros((h, w), dtype=np.uint8)
            canvas[:fa.shape[0], :fa.shape[1]] = fa
            canvas[:fb.shape[0], fa.shape[1] + 8:] = fb
            Image.fromarray(canvas).save(out)
            info(f"wrote {out}")
        # aligned NLE project for scrubbing both clips in sync (reference
        # "compare in kdenlive", src/gui/videocomparewidget.cpp:723-743)
        from ..host.nle import export_compare
        nle_out = os.path.splitext(out)[0] + ".kdenlive"
        export_compare(a, b, mid[0], mid[1], fps[0], fps[1], nle_out)
        info(f"wrote {nle_out}")

    def _migrate(self) -> None:
        """Upgrade legacy v1 .vdx files to the v2 container, honoring
        -i.dryrun (reference -migrate, src/videoindex.cpp:104-221)."""
        from ..params import TYPE_VIDEO
        from ..store.vdx import migrate
        db = self.engine().db
        ids = [(m.id, m.md5) for m in db.all_media() if m.type == TYPE_VIDEO]
        updated, removed = migrate(ids, db.video_path(),
                                   dry_run=self.index.dryRun)
        info(f"migrate: checked {len(ids)} videos, {updated} updated,"
             f" {removed} removed")

    def _dump_text(self) -> None:
        for n, group in enumerate(self.result):
            if not group:
                continue
            print(f"=== group {n} ({len(group)} items) ===")
            for j, m in enumerate(group):
                score = f" score={m.score}" if m.score >= 0 else ""
                rng = ""
                if m.matchRange.is_valid():
                    rng = f" frames[{m.matchRange.srcIn}->{m.matchRange.dstIn}" \
                          f"+{m.matchRange.len}]"
                weed = " (weed)" if m.isWeed else ""
                tag = "needle" if j == 0 else "match"
                print(f"  {tag}: {m.path}{score}{rng}{weed}")

    def _dump_json(self) -> None:
        out = []
        for group in self.result:
            if not group:
                continue
            def enc(m: Media) -> dict:
                d = {"id": m.id, "path": m.path, "type": m.type,
                     "width": m.width, "height": m.height, "md5": m.md5,
                     "dctHash": f"{int(m.dctHash):016x}" if m.dctHash else None}
                if m.score >= 0:
                    d["score"] = m.score
                if m.matchRange.is_valid():
                    d["range"] = [m.matchRange.srcIn, m.matchRange.dstIn,
                                  m.matchRange.len]
                if m.isWeed:
                    d["isWeed"] = True
                if m.roi is not None:
                    d["roi"] = [[round(float(x), 1), round(float(y), 1)]
                                for x, y in m.roi]
                if m.transform is not None:
                    d["transform"] = m.transform
                return d
            out.append({"needle": enc(group[0]),
                        "matches": [enc(m) for m in group[1:]]})
        print(json.dumps(out, indent=1))


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(USAGE)
        return 0
    try:
        from ..utils.log import profile_mark
        profile_mark("cli start (interpreter+imports)")
        rc = Cli().run(list(argv))
        profile_mark("cli end")
        return rc
    except BrokenPipeError:
        # stdout consumer (e.g. `| head`) closed early — not an error
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
