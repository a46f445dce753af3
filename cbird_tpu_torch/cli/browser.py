"""Interactive result browser — a local web UI over the current result.

A copy of ``cbird_tpu/cli/browser.py`` on the port: its decodes and its
template overlay run on the attached engine's scanner and device (the
default device when it has no engine).

Headless-web rebuild of the reference Qt MediaBrowser/MediaGroupListWidget
(src/gui/mediabrowser.{h,cpp}, mediagrouplistwidget.cpp):
paged match groups with thumbnails and per-item dedup actions.  The actions
write back to the Database exactly like the GUI slots do:

- **delete**: move file to trash + remove from the index
  (MediaGroupListWidget delete action → Database::remove)
- **weed**: record needle/item md5 pair as a weed (Database::addWeed)
- **negative**: record a false-match pair (Database::addNegativeMatch)
- **unweed**: remove a weed record

The dedup workflow is keyboard-driven like the reference list widget
(j/k/h/l select, d delete, f replace, r rename, m move, w weed,
x negative, c compare, g quality, n/p page); image pairs open a
zoom/pan-synced A/B compare with an
absolute-difference overlay (VideoCompareWidget analog for images),
and `g` fills no-reference quality scores into the item cards.

`-folders` / `-sets` open a two-level navigation like the reference
MediaBrowser::showFolders/showSets (src/gui/mediabrowser.cpp:119-275): a
top-level index of folder (or directory-pair) cards, each opening its own
group list; `-exit-on-select` makes Enter/select return the selected group
index as the CLI exit code (< 0 if canceled).

Serves on 127.0.0.1 only; `-browse` blocks until Quit is pressed or the
process is interrupted.  GET endpoints: `/` (app), `/api/groups?page=N[&set=]`,
`/api/index`, `/thumb/<media id>`, `/diff?a=&b=`; POST: `/api/delete`,
`/api/replace`, `/api/rename`, `/api/move`, `/api/weed`, `/api/negative`,
`/api/unweed`, `/api/quality`, `/api/select`, `/api/quit`.
"""

from __future__ import annotations

import base64
import html
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..store.media import Media, MediaGroupList
from ..utils.log import info, warn

_PAGE_CSS = """
body { background:#1e1e24; color:#ddd; font-family:sans-serif; margin:1em; }
.group { border:1px solid #444; border-radius:8px; margin:1em 0; padding:.6em; }
.items { display:flex; flex-wrap:wrap; gap:.8em; }
.item { background:#2a2a33; border-radius:6px; padding:.5em; max-width:280px; }
.item.needle { outline:2px solid #4a9; }
.item.weed { outline:2px solid #a44; }
.item.removed { opacity:.35; }
.item.sel { outline:2px dashed #dd4; }
.item.folder { cursor:pointer; }
.item.folder:hover { background:#3a3a4a; }
.pane { overflow:hidden; width:44vw; height:68vh; background:#000;
        border:1px solid #555; }
.pane img { transform-origin:0 0; max-width:none; display:block; }
.keyhelp { font-size:.7em; color:#888; }
.ftable { border-collapse:collapse; margin:.6em 0; width:100%; }
.ftable th { cursor:pointer; text-align:left; padding:.3em .8em;
             background:#2a2a33; position:sticky; top:0; user-select:none; }
.ftable th:hover { background:#3a3a4a; }
.ftable td { padding:.25em .8em; border-top:1px solid #333; }
.ftable tr { cursor:pointer; }
.ftable tr:hover td { background:#3a3a4a; }
.item img { max-width:256px; max-height:256px; display:block; }
.meta { font-size:.75em; color:#aaa; word-break:break-all; }
.score { color:#4a9; font-weight:bold; }
button { background:#39394a; color:#ddd; border:1px solid #555;
         border-radius:4px; margin:2px; cursor:pointer; }
button:hover { background:#4a4a61; }
nav button { font-size:1em; padding:.3em .8em; }
h1 { font-size:1.2em; }
#overlay { background:#15151a; border:1px solid #666; border-radius:8px;
           padding:1em; margin:1em 0; }
.cmp { display:flex; gap:8px; align-items:flex-start; margin:.5em 0;
       flex-wrap:wrap; }
.cmp img { max-width:320px; }
"""

_PAGE_JS = """
let page = 0, curSet = null;
function esc(s) {
  return String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;')
                  .replace(/>/g,'&gt;').replace(/"/g,'&quot;');
}
async function api(path, body) {
  const r = await fetch(path, body ? {method:'POST', body: JSON.stringify(body),
    headers: {'X-Cbird-Token': TOKEN}} : {});
  return r.json();
}
async function act(action, id, other) {
  const r = await api('/api/' + action, {id: id, other: other});
  if (r.error) alert(r.error); else { await load(page); highlight(); }
}
let lastData = null, selG = 0, selI = 1;
function highlight() {
  document.querySelectorAll('.item.sel').forEach(e => e.classList.remove('sel'));
  const gs = document.querySelectorAll('#groups .group');
  if (!gs.length) return;
  selG = Math.max(0, Math.min(selG, gs.length - 1));
  const its = gs[selG].querySelectorAll('.item');
  selI = Math.max(0, Math.min(selI, its.length - 1));
  if (its.length) { its[selI].classList.add('sel');
    its[selI].scrollIntoView({block: 'nearest'}); }
}
function selected() {
  if (!lastData || !lastData.groups[selG]) return null;
  const g = lastData.groups[selG];
  return {g: g, m: g.items[selI], needle: g.items[0]};
}
async function qualGroup() {
  const s = selected(); if (!s) return;
  for (const m of s.g.items) if (!m.removed) await api('/api/quality', {id: m.id});
  await load(page); highlight();
}
document.addEventListener('keydown', async (e) => {
  if (e.target.tagName === 'INPUT' || e.ctrlKey || e.metaKey) return;
  const k = e.key, ov = document.getElementById('overlay');
  if (k === 'Escape') { ov.style.display = 'none'; return; }
  if (k === 't' && cmpIds && ov.style.display === 'block') {
    await saveThumb(); e.preventDefault(); return; }
  if ((k === 'Backspace' || k === 'u') && MODE !== 'normal') {
    await showIndex(); e.preventDefault(); return; }
  if (k === 't' && MODE !== 'normal' && curSet === null && lastData === null) {
    idxView = idxView === 'table' ? 'cards' : 'table';
    await showIndex(); e.preventDefault(); return; }
  if (k === 'Enter') {
    const s = selected();
    if (s) await selectGroup(s.g.index);
    e.preventDefault(); return; }
  if (k === 'n' || k === 'PageDown') { await load(page + 1); selG = 0; selI = 1; highlight(); }
  else if (k === 'p' || k === 'PageUp') { await load(page - 1); selG = 0; selI = 1; highlight(); }
  else if (k === 'j' || k === 'ArrowDown') { selG++; selI = 1; highlight(); }
  else if (k === 'k' || k === 'ArrowUp') { selG--; selI = 1; highlight(); }
  else if (k === 'l' || k === 'ArrowRight') { selI++; highlight(); }
  else if (k === 'h' || k === 'ArrowLeft') { selI--; highlight(); }
  else {
    const s = selected(); if (!s || !s.m) return;
    if (k === 'd' || k === 'Delete') await act('delete', s.m.id);
    else if (k === 'f') await act('replace', s.m.id);
    else if (k === 'w' && selI > 0) await act('weed', s.m.id, s.needle.id);
    else if (k === 'x' && selI > 0) await act('negative', s.m.id, s.needle.id);
    else if (k === 'o') await act('open', s.m.id);
    else if (k === 'r') {
      const name = prompt('rename to:', s.m.path.split('/').pop());
      if (name) { const r = await api('/api/rename', {id: s.m.id, name: name});
        if (r.error) alert(r.error); else { await load(page); highlight(); } }
    }
    else if (k === 'm') {
      const dir = prompt('move to folder (under index root):');
      if (dir) { const r = await api('/api/move', {id: s.m.id, dir: dir});
        if (r.error) alert(r.error); else { await load(page); highlight(); } }
    }
    else if (k === 'g') await qualGroup();
    else if (k === 'c' && selI > 0) {
      if (s.m.video && s.needle.video) await compare(s.needle.id, s.m.id);
      else await icompare(s.needle.id, s.m.id);
    } else return;
  }
  e.preventDefault();
});
let zoom = 1, panX = 0, panY = 0, diffMode = false;
let cmpIds = null, cropStart = null, cropRect = null;
function applyT() {
  for (const id of ['cmpA', 'cmpB']) {
    const el = document.getElementById(id);
    if (el) el.style.transform =
      'translate(' + panX + 'px,' + panY + 'px) scale(' + zoom + ')';
  }
}
function wirePanZoom() {
  const wrap = document.getElementById('cmpwrap');
  let drag = null;
  wrap.onwheel = (e) => { e.preventDefault();
    zoom = Math.max(0.2, Math.min(16, zoom * (e.deltaY < 0 ? 1.2 : 1 / 1.2)));
    applyT(); };
  wrap.onmousedown = (e) => {
    if (e.shiftKey) {  // crop-rect selection on pane A (reference CropWidget)
      cropStart = [e.clientX, e.clientY]; cropRect = null;
      const r = document.getElementById('croprect');
      r.style.display = 'block'; r.style.borderColor = '#e22';
      r.style.left = e.clientX + 'px'; r.style.top = e.clientY + 'px';
      r.style.width = '0px'; r.style.height = '0px';
    } else drag = [e.clientX - panX, e.clientY - panY];
    e.preventDefault(); };
  window.onmousemove = (e) => {
    if (cropStart) {
      const x0 = Math.min(cropStart[0], e.clientX), y0 = Math.min(cropStart[1], e.clientY);
      const x1 = Math.max(cropStart[0], e.clientX), y1 = Math.max(cropStart[1], e.clientY);
      const r = document.getElementById('croprect');
      r.style.left = x0 + 'px'; r.style.top = y0 + 'px';
      r.style.width = (x1 - x0) + 'px'; r.style.height = (y1 - y0) + 'px';
      const bcr = document.getElementById('cmpA').getBoundingClientRect();
      cropRect = [Math.round((x0 - bcr.left) / zoom), Math.round((y0 - bcr.top) / zoom),
                  Math.round((x1 - x0) / zoom), Math.round((y1 - y0) / zoom)];
    } else if (drag) {
      panX = e.clientX - drag[0]; panY = e.clientY - drag[1]; applyT(); } };
  window.onmouseup = () => { drag = null; cropStart = null; };
}
async function saveThumb() {
  if (!cropRect) { alert('shift+drag a rectangle on the left image first'); return; }
  const r = await api('/api/thumb', {id: cmpIds[0], x: cropRect[0], y: cropRect[1],
                                     w: cropRect[2], h: cropRect[3]});
  const el = document.getElementById('croprect');
  if (r.error) alert(r.error);
  else if (el) { el.style.borderColor = '#2e2';
    setTimeout(() => { el.style.display = 'none'; }, 500); }
}
async function icompare(a, b) {
  zoom = 1; panX = panY = 0; diffMode = false;
  cmpIds = [a, b]; cropRect = null; cropStart = null;
  const ov = document.getElementById('overlay');
  ov.style.display = 'block';
  ov.innerHTML = '<h2>compare <button onclick="toggleDiff(' + a + ',' + b + ')">diff</button> ' +
    '<button onclick="tmatch(' + a + ',' + b + ')">template</button> ' +
    '<button onclick="document.getElementById(\\'overlay\\').style.display=\\'none\\'">close</button>' +
    ' <span class="keyhelp">wheel = zoom, drag = pan (both panes synced); ' +
    'shift+drag = crop rect, t = save as index thumbnail; Esc closes</span></h2>' +
    '<div class="cmp" id="cmpwrap">' +
    '<div class="pane"><img id="cmpA" src="/file/' + a + '"></div>' +
    '<div class="pane"><img id="cmpB" src="/file/' + b + '"></div></div>' +
    '<div id="croprect" style="display:none;position:fixed;border:2px solid #e22;' +
    'pointer-events:none;z-index:30"></div>';
  wirePanZoom();
}
function toggleDiff(a, b) {
  diffMode = !diffMode;
  document.getElementById('cmpB').src =
    diffMode ? ('/diff?a=' + a + '&b=' + b) : ('/file/' + b);
}
async function tmatch(a, b) {
  const r = await fetch('/tmatch?a=' + a + '&b=' + b);
  if (!r.ok) { alert(await r.text()); return; }
  document.getElementById('cmpB').src = URL.createObjectURL(await r.blob());
}
async function quit() { await api('/api/quit', {}); document.body.innerHTML = '<h1>bye</h1>'; }
async function compare(a, b) {
  cmpIds = null;  // crop tool is image-compare only
  const d = await api('/api/compare?a=' + a + '&b=' + b);
  if (d.error) { alert(d.error); return; }
  const ov = document.getElementById('overlay');
  ov.style.display = 'block';
  let rows = '<h2>aligned frames (offset ' + d.offset + ')' +
    ' <button onclick="document.getElementById(\\'overlay\\').style.display=\\'none\\'">close</button></h2>';
  for (const p of d.pairs) {
    rows += '<div class="cmp"><img src="/vframe/' + a + '/' + p.a_frame + '">' +
            '<img src="/vframe/' + b + '/' + p.b_frame + '">' +
            '<div class="meta">A ' + p.a_frame + ' / B ' + p.b_frame +
            ' (distance ' + p.dist + ')</div></div>';
  }
  ov.innerHTML = rows;
}
async function updateIndex() {
  const b = document.getElementById('upd');
  const r = await api('/api/update', {});
  if (r.error) { alert(r.error); return; }
  b.disabled = true; b.textContent = 'Updating...';
  const poll = setInterval(async () => {
    const st = await api('/api/update_status');
    if (st.state === 'done') {
      clearInterval(poll);
      b.disabled = false; b.textContent = 'Update index';
      alert('update: ' + JSON.stringify(st.result));
    }
  }, 1000);
}
async function selectGroup(i) {
  if (!EXIT_ON_SELECT) return;
  await api('/api/select', {index: i});
  document.body.innerHTML = '<h1>selected group ' + i + '</h1>';
}
let idxData = null, idxView = null, idxSort = {col: 'key', asc: true};
function fmtBytes(b) {
  if (b >= 1e9) return (b / 1e9).toFixed(2) + ' GB';
  if (b >= 1e6) return (b / 1e6).toFixed(1) + ' MB';
  return (b / 1e3).toFixed(0) + ' kB';
}
function renderIndexTable(c, d) {
  // sortable folder table (the reference MediaGroupTableWidget workflow:
  // rank folders by count/size/score and triage top-down)
  const cols = [['key', 'folder'], ['groups', 'groups'], ['items', 'items'],
                ['bytes', 'size'], ['mpix', 'avg MP'], ['score', 'best score']];
  const s = idxSort;
  const ents = d.entries.slice().sort((a, b) => {
    const x = a[s.col], y = b[s.col];
    const r = (typeof x === 'string')
      ? x.localeCompare(y) : (x - y);
    return s.asc ? r : -r;
  });
  const t = document.createElement('table');
  t.className = 'ftable';
  const hr = document.createElement('tr');
  for (const [col, label] of cols) {
    const th = document.createElement('th');
    th.textContent = label + (s.col === col ? (s.asc ? ' ▲' : ' ▼') : '');
    th.onclick = () => {
      if (s.col === col) s.asc = !s.asc;
      else { s.col = col; s.asc = (col === 'key'); }
      showIndex();
    };
    hr.appendChild(th);
  }
  t.appendChild(hr);
  for (const en of ents) {
    const tr = document.createElement('tr');
    tr.innerHTML = '<td>' + esc(en.key) + '</td><td>' + en.groups +
      '</td><td>' + en.items + '</td><td data-n="' + en.bytes + '">' +
      fmtBytes(en.bytes) + '</td><td>' + en.mpix.toFixed(2) + '</td><td>' +
      (en.score < 0 ? '—' : en.score) + '</td>';
    tr.onclick = async () => { curSet = en.key; await load(0);
      selG = 0; selI = 1; highlight(); };
    t.appendChild(tr);
  }
  c.appendChild(t);
}
async function showIndex() {
  const d = idxData || (idxData = await api('/api/index'));
  curSet = null;
  lastData = null;  // index cards have no selectable items — destructive
                    // keys must not act on the previous group view
  if (idxView === null) idxView = d.entries.length > 24 ? 'table' : 'cards';
  document.getElementById('title').textContent =
    d.title + ' — ' + d.entries.length + ' ' + d.mode;
  const c = document.getElementById('groups');
  c.innerHTML = '';
  const tog = document.createElement('button');
  tog.textContent = idxView === 'table' ? 'cards view (t)' : 'table view (t)';
  tog.onclick = () => { idxView = idxView === 'table' ? 'cards' : 'table';
    showIndex(); };
  c.appendChild(tog);
  if (idxView === 'table') { renderIndexTable(c, d); }
  else {
    const row = document.createElement('div');
    row.className = 'items';
    for (const en of d.entries) {
      const it = document.createElement('div');
      it.className = 'item folder';
      it.innerHTML = '<img loading="lazy" src="/thumb/' + en.thumb + '">' +
        '<div class="meta">' + esc(en.key) + '<br>' + en.groups +
        ' groups, ' + en.items + ' items, ' + fmtBytes(en.bytes) + '</div>';
      it.onclick = async () => { curSet = en.key; await load(0);
        selG = 0; selI = 1; highlight(); };
      row.appendChild(it);
    }
    c.appendChild(row);
  }
  document.getElementById('prev').disabled = true;
  document.getElementById('next').disabled = true;
}
async function load(p) {
  const d = await api('/api/groups?page=' + p +
    (curSet !== null ? '&set=' + encodeURIComponent(curSet) : ''));
  lastData = d;
  page = d.page;
  document.getElementById('title').textContent =
    d.title + ' — ' + d.total_groups + ' groups, page ' + (d.page+1) + '/' + d.pages;
  const c = document.getElementById('groups');
  c.innerHTML = '';
  for (const g of d.groups) {
    const gd = document.createElement('div');
    gd.className = 'group';
    gd.innerHTML = '<div>group ' + g.index + ' (' + g.items.length + ' items)</div>';
    const row = document.createElement('div');
    row.className = 'items';
    for (const [j, m] of g.items.entries()) {
      const it = document.createElement('div');
      it.className = 'item' + (j==0?' needle':'') + (m.weed?' weed':'') +
                     (m.removed?' removed':'');
      const needleId = g.items[0].id;
      it.innerHTML =
        '<a href="/file/' + m.id + '" target="_blank">' +
        '<img loading="lazy" src="/thumb/' + m.id + '"></a>' +
        '<div class="meta">' + esc(m.name) + '<br>' + esc(m.dims) +
        (m.score>=0 ? ' <span class="score">score ' + m.score + '</span>' : '') +
        (m.quality != null ? ' <span class="score">q=' + m.quality + '</span>' : '') +
        (m.range ? ' ' + m.range : '') + (m.weed ? ' WEED' : '') + '</div>' +
        (m.removed ? '<i>removed</i>' :
         '<button onclick="act(\\'delete\\',' + m.id + ')">delete</button>' +
         (g.items.length == 2 ?
          '<button title="delete, then rename+move the kept file here"' +
          ' onclick="act(\\'replace\\',' + m.id + ')">replace</button>' : '') +
         (j>0 ? '<button onclick="act(\\'weed\\',' + m.id + ',' + needleId + ')">weed</button>' +
                '<button onclick="act(\\'negative\\',' + m.id + ',' + needleId + ')">not a match</button>' +
                (m.video && g.items[0].video ?
                 '<button onclick="compare(' + needleId + ',' + m.id + ')">compare</button>' :
                 '<button onclick="icompare(' + needleId + ',' + m.id + ')">compare</button>')
              : '') +
         (m.weed ? '<button onclick="act(\\'unweed\\',' + m.id + ')">unweed</button>' : '') +
         '<button onclick="act(\\'open\\',' + m.id + ')">open</button>' +
         '<button onclick="act(\\'reveal\\',' + m.id + ')">reveal</button>');
      row.appendChild(it);
    }
    gd.appendChild(row);
    c.appendChild(gd);
  }
  document.getElementById('prev').disabled = page <= 0;
  document.getElementById('next').disabled = page >= d.pages - 1;
}
window.onload = async () => {
  if (MODE !== 'normal') {
    document.getElementById('back').style.display = '';
    await showIndex();
  } else { await load(0); highlight(); }
};
"""


def _page_html(title: str, token: str = "", mode: str = "normal",
               exit_on_select: bool = False) -> str:
    t = html.escape(title)
    return f"""<!doctype html><html><head><meta charset='utf-8'>
<title>{t}</title><style>{_PAGE_CSS}</style></head><body>
<h1 id='title'>{t}</h1>
<nav>
<button id='back' onclick='showIndex()' style='display:none'>&#8962; index</button>
<button id='prev' onclick='load(page-1)'>&laquo; prev</button>
<button id='next' onclick='load(page+1)'>next &raquo;</button>
<button onclick='quit()' style='float:right'>Quit</button>
<button id='upd' onclick='updateIndex()' style='float:right'>Update index</button>
</nav>
<div class='keyhelp'>keys: j/k group &middot; h/l item &middot; n/p page &middot;
d delete &middot; f replace &middot; r rename &middot; m move &middot;
w weed &middot; x not-a-match &middot; c compare &middot; g quality &middot;
o open &middot; u index &middot; t table/cards &middot; Esc close</div>
<div id='overlay' style='display:none'></div>
<div id='groups'></div>
<script>const TOKEN={json.dumps(token)};const MODE={json.dumps(mode)};
const EXIT_ON_SELECT={json.dumps(exit_on_select)};{_PAGE_JS}</script></body></html>"""


UNPAIRED_KEY = "*unpaired*"


def _greatest_path_prefix(paths: list[str]) -> str:
    """Longest common prefix of all paths, trimmed back to a '/' boundary
    (reference Media::greatestPathPrefix)."""
    if not paths:
        return ""
    pre = os.path.commonprefix(paths)
    cut = pre.rfind("/")
    return pre[:cut + 1] if cut >= 0 else ""


def build_index(groups: MediaGroupList, mode: str
                ) -> tuple[list[str], dict[str, MediaGroupList]]:
    """Two-level browser navigation: an index of folder/set cards, each
    opening its own group list (reference MediaBrowser::showFolders /
    showSets, src/gui/mediabrowser.cpp:119-275).

    - "folders": groups keyed by the first item's parent directory
      (videos by file path, like the reference), relative to the greatest
      common prefix; key carries a total item count suffix.
    - "sets"/"pairs": groups keyed by the PAIR of directories they match
      between; groups touching !=2 directories — and sets holding only a
      single match — land in the ``*unpaired*`` entry.

    @return (ordered keys, key -> groups)
    """
    groups = [list(g) for g in groups if g]
    if mode == "folders":
        prefix = _greatest_path_prefix([m.path for g in groups for m in g])
        raw_keys = []
        counts: dict[str, int] = {}
        for g in groups:
            first = g[0]
            key = (first.path if first.type == Media.TypeVideo
                   else first.dir_path() + "/")
            key = key[len(prefix):] if key.startswith(prefix) else key
            key = key.rstrip("/") or "/"
            raw_keys.append(key)
            counts[key] = counts.get(key, 0) + len(g)
        sets: dict[str, MediaGroupList] = {}
        for key, g in zip(raw_keys, groups):
            sets.setdefault(f"{key} [x{counts[key]}]", []).append(g)
        return sorted(sets), sets
    if mode in ("sets", "pairs"):
        sets = {UNPAIRED_KEY: []}
        for g in groups:
            dirs = []
            for m in g:
                d = m.dir_path()
                if d not in dirs:
                    dirs.append(d)
            if len(dirs) != 2:
                sets[UNPAIRED_KEY].append(g)
                continue
            a, b = sorted(dirs)  # pair is unordered: [old,new] == [new,old]
            i = len(os.path.commonprefix([a, b]))
            while i > 0 and (i > len(a) or a[i - 1] != "/"):
                i -= 1
            sets.setdefault(f"{a[i:]}/ ↔ {b[i:]}/", []).append(g)
        for key in [k for k, v in sets.items()
                    if k != UNPAIRED_KEY and len(v) == 1]:
            sets[UNPAIRED_KEY].extend(sets.pop(key))
        if not sets[UNPAIRED_KEY]:
            del sets[UNPAIRED_KEY]
        return sorted(sets), sets
    return [], {}


class BrowserState:
    """Mutable view of the result list shared between requests."""

    def __init__(self, db, groups: MediaGroupList, title: str,
                 max_per_page: int = 12, engine=None, mode: str = "normal"):
        self.db = db
        self.engine = engine
        self.update_thread: threading.Thread | None = None
        self.update_result: dict | None = None
        self.groups = [list(g) for g in groups if g]
        self.title = title
        self.mode = mode if mode in ("folders", "sets", "pairs") else "normal"
        self.index_keys, self.sets = build_index(self.groups, self.mode)
        self.selection: int | None = None  # -exit-on-select result
        self.max_per_page = max(1, max_per_page)
        self.removed: set[int] = set()
        self.lock = threading.Lock()
        self._quality: dict[int, int] = {}
        self._fsize_cache: dict[int, int] = {}
        self._tmatcher = None  # lazy TemplateMatcher, made on first use
        self._media: dict[int, Media] = {}
        for g in self.groups:
            for m in g:
                if m.id:
                    self._media[m.id] = m

    def media(self, mid: int) -> Media | None:
        return self._media.get(mid)

    def _view_groups(self, set_key: str | None) -> MediaGroupList:
        if set_key is not None and set_key in self.sets:
            return self.sets[set_key]
        return self.groups

    def pages(self, set_key: str | None = None) -> int:
        return max(1, (len(self._view_groups(set_key)) + self.max_per_page - 1)
                   // self.max_per_page)

    def index_payload(self) -> dict:
        """Top-level folder/set cards (the reference's showIndex view).

        Entries carry the sortable-table columns of the reference's
        MediaGroupTableWidget workflow (src/gui/mediagrouptablewidget.cpp:
        path/megapixels/score/size columns over a folder's contents):
        total bytes, mean megapixels, and best (lowest) match score per
        folder, so a 500-folder result can be ranked by any of them."""
        entries = []
        for key in self.index_keys:
            glist = self.sets[key]
            members = [m for g in glist for m in g]
            mp = [m.width * m.height for m in members
                  if m.width > 0 and m.height > 0]
            scores = [m.score for m in members if m.score >= 0]
            entries.append({
                "key": key,
                "groups": len(glist),
                "items": len(members),
                "bytes": sum(self._file_size(m) for m in members),
                "mpix": round(sum(mp) / len(mp) / 1e6, 2) if mp else 0.0,
                "score": min(scores) if scores else -1,
                "thumb": glist[0][0].id if glist and glist[0] else 0,
            })
        return {"title": self.title, "mode": self.mode, "entries": entries}

    def _file_size(self, m: Media) -> int:
        sz = self._fsize_cache.get(m.id)
        if sz is None:
            try:
                sz = m.file_size()
            except OSError:
                sz = 0
            self._fsize_cache[m.id] = sz
        return sz

    def page_payload(self, page: int, set_key: str | None = None) -> dict:
        view = self._view_groups(set_key)
        pages = self.pages(set_key)
        page = max(0, min(page, pages - 1))
        lo = page * self.max_per_page
        out = []
        for n, g in enumerate(view[lo:lo + self.max_per_page], start=lo):
            items = []
            for m in g:
                rng = ""
                if m.matchRange.is_valid():
                    rng = (f"frames {m.matchRange.srcIn}→"
                           f"{m.matchRange.dstIn}+{m.matchRange.len}")
                items.append({
                    "id": m.id,
                    "name": m.name(),
                    "path": m.path,
                    "dims": f"{m.width}×{m.height}" if m.width > 0 else "",
                    "score": m.score,
                    "range": rng,
                    "weed": bool(self.db.is_weed(m)),
                    "removed": m.id in self.removed,
                    "video": m.type == Media.TypeVideo,
                    "quality": self._quality.get(m.id),
                })
            out.append({"index": n, "items": items})
        return {"title": (f"{self.title} — {set_key}" if set_key else
                          self.title),
                "page": page, "pages": pages,
                "total_groups": len(view), "groups": out}

    def _decode(self, path: str):
        from ..host.scanner import Scanner
        if not hasattr(self, "_scanner"):
            self._scanner = (self.engine.scanner if self.engine is not None
                             else Scanner())
        return self._scanner.decode_image(path)

    def quality(self, mid: int):
        """No-reference quality score on demand (the reference GUI's
        quality-score column, src/gui/mediagrouplistwidget.cpp)."""
        m = self.media(mid)
        if m is None:
            return "unknown media id"
        if mid not in self._quality:
            from ..ops.quality import quality_score
            d = self._decode(m.path)
            if d.gray is None:
                return f"cannot decode {m.path}"
            self._quality[mid] = int(quality_score(d.gray))
        return {"id": mid, "quality": self._quality[mid]}

    def set_thumbnail(self, mid: int, x: int, y: int, w: int, h: int,
                      frame: int | None = None) -> str | None:
        """Crop a region of a media item into the collection thumbnail
        ``<root>/thumb.png`` (the reference's interactive CropWidget →
        Database::thumbPath flow, src/gui/cropwidget.cpp:30-140; here the
        rectangle comes from shift+drag in the compare view).  Returns an
        error string or None."""
        m = self.media(mid)
        if m is None:
            return "unknown media id"
        from PIL import Image as PILImage

        from ..store.thumbnail import save_index_thumb
        try:
            if m.type == Media.TypeVideo:
                from ..host.video import grab_frame
                fr = grab_frame(m.path, int(frame or 0))
                if fr is None:
                    return f"cannot grab frame {frame} of {m.path}"
                img = PILImage.fromarray(fr)
            else:
                import io as _io

                from PIL import ImageOps

                from ..host.scanner import read_bytes
                img = PILImage.open(_io.BytesIO(read_bytes(m.path)))
                img = ImageOps.exif_transpose(img)
        except (OSError, KeyError) as e:
            return f"cannot load {m.path}: {e}"
        root = self.db.path()
        try:
            rel = os.path.relpath(m.path, root)
            save_index_thumb(root, img, rel_path=rel, crop=(x, y, w, h),
                             frame=frame, media=m)
        except ValueError as e:
            return str(e)
        return None

    def image_diff(self, a: int, b: int):
        """Absolute-difference JPEG of two images at a common size
        (the reference compare view's visual diff)."""
        import io as _io

        import numpy as np
        from PIL import Image as PImage
        ma, mb = self.media(a), self.media(b)
        if ma is None or mb is None:
            return "unknown media id"
        da, db_ = self._decode(ma.path), self._decode(mb.path)
        if da.gray is None or db_.gray is None:
            return "cannot decode"
        h = min(da.gray.shape[0], db_.gray.shape[0])
        w = min(da.gray.shape[1], db_.gray.shape[1])
        pa = np.asarray(PImage.fromarray(da.gray).resize((w, h),
                                                         PImage.BILINEAR),
                        dtype=np.int16)
        pb = np.asarray(PImage.fromarray(db_.gray).resize((w, h),
                                                          PImage.BILINEAR),
                        dtype=np.int16)
        diff = np.abs(pa - pb)
        out = (diff * (255.0 / max(int(diff.max()), 1))).astype(np.uint8)
        buf = _io.BytesIO()
        PImage.fromarray(out).save(buf, "JPEG", quality=85)
        return buf.getvalue()

    # ---- actions (all mirror GUI slots writing to the Database) ----------
    def template_overlay(self, a: int, b: int):
        """Run the TemplateMatcher on the (template=a, candidate=b) pair
        and return candidate's image with the matched template ROI drawn
        (reference MediaGroupListWidget template-match action,
        src/gui/mediagrouplistwidget.cpp — draws the matched region).
        @return JPEG bytes or an error string."""
        import copy
        import io as _io

        from PIL import Image as PImage
        from PIL import ImageDraw

        from ..host.template_matcher import TemplateMatcher
        from ..params import SearchParams
        ma, mb = self.media(a), self.media(b)
        if ma is None or mb is None:
            return "unknown media id"
        with self.lock:
            if self._tmatcher is None:
                self._tmatcher = (self.engine.template_matcher()
                                  if self.engine is not None
                                  else TemplateMatcher())
        cand = copy.copy(mb)  # match() mutates score/roi — keep state clean
        group = [cand]
        self._tmatcher.match(ma, group, SearchParams())
        if not group or cand.roi is None:
            return "no template match (pair exceeds -p.tmthr)"
        try:
            with PImage.open(mb.path) as im:
                img = im.convert("RGB")
        except OSError:
            return "cannot decode"
        draw = ImageDraw.Draw(img)
        pts = [(float(x), float(y)) for x, y in cand.roi]
        draw.line(pts + pts[:1], fill=(80, 255, 120), width=3)
        buf = _io.BytesIO()
        img.save(buf, "JPEG", quality=88)
        return buf.getvalue()

    def delete(self, mid: int) -> str | None:
        from .commands import trash_file
        m = self.media(mid)
        if m is None:
            return "unknown media id"
        with self.lock:
            if mid in self.removed:
                return "already removed"
            if not trash_file(m.path):
                return f"could not trash {m.path}"
            self.db.remove([mid])
            self.removed.add(mid)
        return None

    def replace(self, mid: int) -> str | None:
        """Delete the selected file and move the kept pair member into its
        place — trash + rename to the deleted file's base name (keeping the
        survivor's suffix) + move to its directory (reference
        MediaGroupListWidget::replaceAction → MediaPage::replaceFile,
        src/gui/mediapage.cpp:94-108; pairs only)."""
        m = self.media(mid)
        if m is None:
            return "unknown media id"
        group = next((g for g in self.groups if any(x.id == mid for x in g)),
                     None)
        live = [x for x in (group or []) if x.id not in self.removed]
        if group is None or len(live) != 2:
            return "replace needs a pair (exactly 2 remaining items)"
        other = next(x for x in live if x.id != mid)
        if m.is_archived() or other.is_archived():
            return "delete+replace for archives unsupported"
        old_dir = os.path.dirname(m.path)
        base = os.path.splitext(os.path.basename(m.path))[0]
        suffix = os.path.splitext(other.path)[1]
        err = self.delete(mid)
        if err:
            return err
        new_name = base + suffix
        with self.lock:
            if os.path.basename(other.path) != new_name and \
                    not self.db.rename(other, os.path.join(
                        os.path.dirname(other.path), new_name)):
                return f"cannot rename {other.path} to {new_name}"
            if os.path.dirname(other.path) != old_dir and \
                    not self.db.move(other, old_dir):
                return f"cannot move {other.path} to {old_dir}"
        return None

    def rename(self, mid: int, new_name: str) -> str | None:
        """Rename in place, index preserved (reference
        MediaGroupListWidget::renameFileAction,
        src/gui/mediagrouplistwidget.cpp — same-directory rename)."""
        m = self.media(mid)
        if m is None:
            return "unknown media id"
        new_name = os.path.basename((new_name or "").strip())
        if not new_name:
            return "empty name"
        with self.lock:
            if not self.db.rename(m, os.path.join(os.path.dirname(m.path),
                                                  new_name)):
                return f"cannot rename to {new_name} (exists or archived?)"
        return None

    def move(self, mid: int, new_dir: str) -> str | None:
        """Move to another folder under the index root, index preserved
        (reference MediaGroupListWidget::moveFileAction)."""
        m = self.media(mid)
        if m is None:
            return "unknown media id"
        new_dir = (new_dir or "").strip()
        if not new_dir:
            return "empty directory"
        dst = new_dir if os.path.isabs(new_dir) \
            else os.path.join(self.db.path(), new_dir)
        root = os.path.realpath(self.db.path())
        if os.path.commonpath([root, os.path.realpath(
                os.path.join(dst, "x"))]) != root:
            return "destination must stay under the index root"
        with self.lock:
            if not self.db.move(m, dst):
                return f"cannot move to {new_dir}"
        return None

    def open(self, mid: int) -> str | None:
        """Open with the desktop default app (GUI Open action parity)."""
        from .commands import open_path
        m = self.media(mid)
        if m is None:
            return "unknown media id"
        return None if open_path(m.path) else "no desktop launcher"

    def reveal(self, mid: int) -> str | None:
        """Reveal in the file manager (GUI 'Open location' parity)."""
        from .commands import reveal_path
        m = self.media(mid)
        if m is None:
            return "unknown media id"
        return None if reveal_path(m.path) else "no file manager"

    def weed(self, mid: int, original_id: int) -> str | None:
        m, orig = self.media(mid), self.media(original_id)
        if m is None or orig is None:
            return "unknown media id"
        if not self.db.add_weed(m, orig):
            return "weed pair rejected (same or empty md5)"
        return None

    def unweed(self, mid: int) -> str | None:
        m = self.media(mid)
        if m is None:
            return "unknown media id"
        self.db.unweed(m)
        return None

    def _video_index_of(self, m: Media):
        if m.videoIndex is not None and not m.videoIndex.is_empty():
            return m.videoIndex
        try:
            from ..store.vdx import load_vdx
            return load_vdx(os.path.join(self.db.video_path(), f"{m.id}.vdx"))
        except (OSError, ValueError, AttributeError):
            return None

    def compare(self, a_id: int, b_id: int):
        """Temporal alignment of two indexed videos from their stored hash
        sequences (headless VideoCompareWidget,
        reference src/gui/videocomparewidget.cpp): probe frames of A matched
        to their nearest hash in B.  @return dict or error string"""
        import numpy as np

        from ..ops.ref_numpy import hamming64
        a, b = self.media(a_id), self.media(b_id)
        if a is None or b is None:
            return "unknown media id"
        ia, ib = self._video_index_of(a), self._video_index_of(b)
        if ia is None or ib is None or ia.is_empty() or ib.is_empty():
            return "not an indexed video pair"
        pairs = []
        step = max(1, len(ia.frames) // 9)
        for k in range(0, len(ia.frames), step):
            ha = int(ia.hashes[k])
            dists = [hamming64(ha, int(h)) for h in ib.hashes]
            j = int(np.argmin(dists))
            pairs.append({"a_frame": int(ia.frames[k]),
                          "b_frame": int(ib.frames[j]),
                          "dist": int(dists[j])})
        offset = int(np.median([p["b_frame"] - p["a_frame"] for p in pairs]))
        return {"a": a_id, "b": b_id, "offset": offset, "pairs": pairs}

    def start_update(self) -> str | None:
        """Kick an incremental -update in a worker thread (the headless
        equivalent of the reference's -test-update start/stop dialog,
        src/commands.cpp:1130-1171)."""
        if self.engine is None:
            return "no engine attached (read-only browse)"
        with self.lock:
            if self.update_thread is not None and self.update_thread.is_alive():
                return "update already running"
            self.update_result = None

            def work():
                try:
                    self.update_result = self.engine.update()
                except Exception as e:  # noqa: BLE001 — surfaced via status
                    self.update_result = {"error": str(e)}

            self.update_thread = threading.Thread(target=work, daemon=True)
            self.update_thread.start()
        return None

    def update_status(self) -> dict:
        if self.update_thread is None:
            return {"state": "idle"}
        if self.update_thread.is_alive():
            return {"state": "running"}
        return {"state": "done", "result": self.update_result}

    def select(self, index: int) -> None:
        """Record the selected group index for -exit-on-select (reference
        MediaWidgetOptions::FlagExitOnSelect: 'select' exits with the
        selected index as exit code, < 0 if canceled)."""
        self.selection = int(index)

    def negative(self, mid: int, other_id: int) -> str | None:
        a, b = self.media(mid), self.media(other_id)
        if a is None or b is None:
            return "unknown media id"
        if not self.db.add_negative_match(a, b):
            return "pair rejected (same or empty md5)"
        return None


class _Handler(BaseHTTPRequestHandler):
    state: BrowserState = None  # set by serve_browser
    thumbs: dict[int, bytes] = {}
    token: str = ""  # per-session CSRF token (set by serve_browser)
    exit_on_select: bool = False

    def log_message(self, fmt, *args):  # quiet; cbird logging instead
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802 (http.server API)
        url = urlparse(self.path)
        if url.path == "/":
            self._send(200, _page_html(self.state.title, self.token,
                                       self.state.mode,
                                       self.exit_on_select).encode(),
                       "text/html")
        elif url.path == "/api/groups":
            q = parse_qs(url.query)
            page = int(q.get("page", ["0"])[0])
            set_key = q.get("set", [None])[0]
            self._json(self.state.page_payload(page, set_key))
        elif url.path == "/api/index":
            self._json(self.state.index_payload())
        elif url.path == "/api/update_status":
            self._json(self.state.update_status())
        elif url.path == "/api/compare":
            q = parse_qs(url.query)
            try:
                a = int(q.get("a", ["0"])[0])
                b = int(q.get("b", ["0"])[0])
            except ValueError:
                return self._json({"error": "bad ids"}, 400)
            out = self.state.compare(a, b)
            if isinstance(out, str):
                return self._json({"error": out}, 400)
            self._json(out)
        elif url.path == "/diff":
            q = parse_qs(url.query)
            try:
                a, b = int(q.get("a", ["0"])[0]), int(q.get("b", ["0"])[0])
            except ValueError:
                return self._send(400, b"bad ids", "text/plain")
            out = self.state.image_diff(a, b)
            if isinstance(out, str):
                return self._send(404, out.encode(), "text/plain")
            self._send(200, out, "image/jpeg")
        elif url.path == "/tmatch":
            q = parse_qs(url.query)
            try:
                a, b = int(q.get("a", ["0"])[0]), int(q.get("b", ["0"])[0])
            except ValueError:
                return self._send(400, b"bad ids", "text/plain")
            out = self.state.template_overlay(a, b)
            if isinstance(out, str):
                return self._send(404, out.encode(), "text/plain")
            self._send(200, out, "image/jpeg")
        elif url.path.startswith("/vframe/"):
            # one decoded video frame: /vframe/<media id>/<frame no>
            parts = url.path.split("/")
            try:
                mid, frame_no = int(parts[2]), int(parts[3])
            except (IndexError, ValueError):
                return self._send(404, b"bad vframe", "text/plain")
            m = self.state.media(mid)
            if m is None:
                return self._send(404, b"no media", "text/plain")
            import io as _io

            from PIL import Image

            from ..host.video import grab_frame
            frame = grab_frame(m.path, frame_no, max_side=512)
            if frame is None:
                return self._send(404, b"no frame", "text/plain")
            buf = _io.BytesIO()
            Image.fromarray(frame).convert("RGB").save(buf, "JPEG", quality=80)
            self._send(200, buf.getvalue(), "image/jpeg")
        elif url.path.startswith("/file/"):
            # full-size original (headless analog of DesktopHelper::open)
            try:
                mid = int(url.path.rsplit("/", 1)[1])
            except ValueError:
                return self._send(404, b"bad id", "text/plain")
            m = self.state.media(mid)
            if m is None or mid in self.state.removed:
                return self._send(404, b"gone", "text/plain")
            try:
                from ..host.scanner import read_bytes
                data = read_bytes(m.path)
            except (OSError, KeyError):
                return self._send(404, b"unreadable", "text/plain")
            import mimetypes
            ctype = mimetypes.guess_type(m.path)[0] or "application/octet-stream"
            self._send(200, data, ctype)
        elif url.path.startswith("/thumb/"):
            try:
                mid = int(url.path.rsplit("/", 1)[1])
            except ValueError:
                return self._send(404, b"bad id", "text/plain")
            data = self._thumb(mid)
            if data is None:
                return self._send(404, b"no thumb", "text/plain")
            self._send(200, data, "image/jpeg")
        else:
            self._send(404, b"not found", "text/plain")

    def _thumb(self, mid: int) -> bytes | None:
        if mid in self.thumbs:
            return self.thumbs[mid]
        m = self.state.media(mid)
        if m is None:
            return None
        from .report import _thumb_b64
        b64 = _thumb_b64(m)
        data = base64.b64decode(b64) if b64 else None
        if data:
            self.thumbs[mid] = data
        return data

    def do_POST(self):  # noqa: N802
        url = urlparse(self.path)
        # CSRF guard: state-changing endpoints (delete/weed/open/...) need
        # the per-session token the served page embeds — a cross-origin
        # page can neither read it nor send the custom header without a
        # CORS preflight (which this server never grants)
        if self.token and self.headers.get("X-Cbird-Token") != self.token:
            return self._json({"error": "bad or missing session token"}, 403)
        length = int(self.headers.get("Content-Length") or 0)
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return self._json({"error": "bad json"}, 400)
        mid = int(body.get("id") or 0)
        other = int(body.get("other") or 0)
        s = self.state
        if url.path == "/api/delete":
            err = s.delete(mid)
        elif url.path == "/api/replace":
            err = s.replace(mid)
        elif url.path == "/api/weed":
            err = s.weed(mid, other)
        elif url.path == "/api/unweed":
            err = s.unweed(mid)
        elif url.path == "/api/negative":
            err = s.negative(mid, other)
        elif url.path == "/api/rename":
            err = s.rename(mid, str(body.get("name") or ""))
        elif url.path == "/api/move":
            err = s.move(mid, str(body.get("dir") or ""))
        elif url.path == "/api/open":
            err = s.open(mid)
        elif url.path == "/api/reveal":
            err = s.reveal(mid)
        elif url.path == "/api/thumb":
            err = s.set_thumbnail(
                mid, int(body.get("x") or 0), int(body.get("y") or 0),
                int(body.get("w") or 0), int(body.get("h") or 0),
                frame=(int(body["frame"]) if body.get("frame") is not None
                       else None))
        elif url.path == "/api/quality":
            out = s.quality(mid)
            if isinstance(out, str):
                return self._json({"error": out}, 400)
            return self._json(out)
        elif url.path == "/api/update":
            err = s.start_update()
        elif url.path == "/api/select":
            s.select(int(body.get("index") or 0))
            self._json({"ok": True, "selected": s.selection})
            threading.Thread(target=self.server.shutdown, daemon=True).start()
            return
        elif url.path == "/api/update_status":
            return self._json(s.update_status())
        elif url.path == "/api/quit":
            self._json({"ok": True})
            threading.Thread(target=self.server.shutdown, daemon=True).start()
            return
        else:
            return self._json({"error": "unknown action"}, 404)
        self._json({"error": err} if err else {"ok": True},
                   400 if err else 200)


def serve_browser(db, groups: MediaGroupList, title: str = "cbird results",
                  host: str = "127.0.0.1", port: int = 0,
                  max_per_page: int = 12, block: bool = True, engine=None,
                  mode: str = "normal", exit_on_select: bool = False):
    """Start the browser server.  With block=True (CLI -browse) runs until
    Quit and returns the selected group index (None if not selected);
    otherwise returns (server, thread, url) for embedding/tests."""
    if not groups:
        warn("browse: empty result, nothing to show")
        return None
    import secrets
    state = BrowserState(db, groups, title, max_per_page, engine=engine,
                         mode=mode)
    handler = type("BoundHandler", (_Handler,), {
        "state": state,
        "thumbs": {},
        "token": secrets.token_hex(16),
        "exit_on_select": exit_on_select,
    })
    server = ThreadingHTTPServer((host, port), handler)
    url = f"http://{host}:{server.server_address[1]}/"
    info(f"browse: serving {sum(len(g) for g in groups)} items in "
         f"{len(groups)} groups at {url} (ctrl-c or Quit button to stop)")
    if block:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return state.selection
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, url
