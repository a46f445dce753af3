"""Resident query server (`-serve`) + thin client.

A copy of ``cbird_tpu/cli/serve.py`` on the port's Engine.  The reference
reloads the index on every CLI run (there is no daemon in cbird,
src/main.cpp main() is one-shot), and a fresh process also loads torch,
builds or loads the CUDA kernels and copies the stores to the card before
its first search.  A resident engine pays all of that once: the daemon
holds the loaded Database, the card-resident stores and the loaded
kernels, so a warm query is the search's launches and one readback.
Queries run one at a time on the engine's device.

Protocol: JSON lines over TCP (default 127.0.0.1, ephemeral port).
  request  {"cmd": "query", "path": "/abs/needle", "params": {"alg": "dct"}}
  response {"ok": true, "groups": [[{"path":..., "score":...}, ...]]}
Other commands: ping (liveness + warm check), status (counts, memory),
stop (shut the server down).

CLI:
  cbird -use dir -serve            # run until stopped
  CBIRD_SERVER=host:port cbird -similar-to f ...   # route queries
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time

from .. import _build
from ..params import SearchParams
from ..store.media import Media
from ..utils.log import info, warn


def parse_hostport(addr: str, default_host: str = "127.0.0.1",
                   default_port: int = 0) -> tuple[str, int]:
    """Lenient ``host:port`` parse for CBIRD_SERVE_ADDR/CBIRD_SERVER.

    Accepts bare host (``localhost``), bare port (``8080``), ``host:port``,
    bracketed IPv6 (``[::1]:8080``) and bare IPv6 (``::1``).
    @raises ValueError with a readable message on a non-numeric port."""
    addr = addr.strip()
    if not addr:
        return default_host, default_port
    if addr.startswith("["):
        host, _, rest = addr[1:].partition("]")
        port = rest.lstrip(":")
        if port and not port.isdigit():
            raise ValueError(f"invalid port in address: {addr!r}")
        return host or default_host, int(port) if port else default_port
    host, sep, port = addr.rpartition(":")
    if not sep:
        if addr.isdigit():
            return default_host, int(addr)
        return addr, default_port
    if ":" in host:  # bare IPv6 like ::1 (no port)
        return addr, default_port
    if not port.isdigit():
        raise ValueError(f"invalid port in address: {addr!r}")
    return host or default_host, int(port)


def _group_payload(groups) -> list:
    out = []
    for g in groups:
        out.append([{
            "path": m.path,
            "score": int(getattr(m, "score", 0)),
            "id": int(m.id),
            "md5": m.md5,
            "width": int(m.width),
            "height": int(m.height),
        } for m in g])
    return out


class QueryServer:
    """Holds one Engine; serves queries over JSON-lines TCP, one at a time
    on the engine's device."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self._t0 = time.time()
        self._queries = 0
        self._qlock = threading.Lock()
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                        resp = outer.handle(req)
                    except Exception as e:  # noqa: BLE001 — daemon survives
                        resp = {"ok": False, "error": str(e)}
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()
                    if resp.get("stopping"):
                        threading.Thread(target=outer.server.shutdown,
                                         daemon=True).start()
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.server = Server((host, port), Handler)
        self.address = self.server.server_address

    # ---- request handling -------------------------------------------------
    def handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd == "ping":
            return {"ok": True, "pong": True}
        if cmd == "status":
            db = self.engine.db
            return {"ok": True, "items": db.count(),
                    "memory": db.memory_usage(),
                    "uptime_s": round(time.time() - self._t0, 1),
                    "queries": self._queries}
        if cmd == "stop":
            return {"ok": True, "stopping": True}
        if cmd == "query":
            params = self._params(req.get("params") or {})
            path = req.get("path") or ""
            if not path:
                return {"ok": False, "error": "query needs a path"}
            needle = self.engine.db.media_with_path(path)
            if not needle.is_valid():
                needle = Media(path)
            # lock: the engine/db are not generally thread-safe for
            # concurrent queries; serialize (decode+search is the work)
            with self._qlock:
                matches = self.engine.query(needle, params)
                self._queries += 1
            groups = [[needle] + matches] if matches else []
            return {"ok": True, "groups": _group_payload(groups)}
        return {"ok": False, "error": f"unknown cmd: {cmd}"}

    @staticmethod
    def _params(overrides: dict) -> SearchParams:
        p = SearchParams()
        for k, v in overrides.items():
            p.set_param(k, str(v))
        return p

    # ---- lifecycle --------------------------------------------------------
    def warmup(self) -> float:
        """Build and load every kernel (on a card), load the index and run
        one query of a stored needle, so that the store is on the engine's
        device before the first client connects.  @return seconds"""
        t0 = time.perf_counter()
        if self.engine.device.type == "cuda":
            _build.load_all()
        p = SearchParams()
        index = self.engine.db.load_index(p)
        ids = getattr(getattr(index, "_store", None), "ids", None)
        if ids is not None and len(ids):
            import numpy as np
            live = np.asarray(ids)
            live = live[live != 0]  # id 0 = tombstone (removed media)
            first = int(live[0]) if len(live) else 0
            if first:
                m = self.engine.db.media_with_id(first)
                if m.is_valid():
                    index.find_index_data(m)
                    self.engine.db.search_index(index, m, p)
        return time.perf_counter() - t0

    def serve_forever(self):
        info(f"serve: listening on {self.address[0]}:{self.address[1]} "
             f"({self.engine.db.count()} items resident)")
        try:
            self.server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.server.server_close()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.server.serve_forever, daemon=True)
        t.start()
        return t

    def close(self):
        self.server.shutdown()
        self.server.server_close()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class QueryClient:
    """Thin JSON-lines client for a running -serve daemon."""

    def __init__(self, address: str):
        host, port = parse_hostport(address)
        self.sock = socket.create_connection((host, port), timeout=600)
        self._f = self.sock.makefile("rwb")

    def call(self, req: dict) -> dict:
        self._f.write(json.dumps(req).encode() + b"\n")
        self._f.flush()
        line = self._f.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def query(self, path: str, **params) -> list:
        resp = self.call({"cmd": "query", "path": os.path.abspath(path),
                          "params": params})
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "query failed"))
        return resp["groups"]

    def close(self):
        try:
            self._f.close()
            self.sock.close()
        except OSError:
            pass


def serve_cli(engine, host: str = "127.0.0.1", port: int = 0) -> None:
    """-serve verb body: warm up, then block serving queries."""
    srv = QueryServer(engine, host, port)
    dt = srv.warmup()
    info(f"serve: warm (index loaded, kernels built in {dt:.1f}s)")
    srv.serve_forever()


def remote_groups_to_media(groups: list) -> list:
    """Client-side: JSON group payload → Media lists (for -dump etc.)."""
    out = []
    for g in groups:
        mg = []
        for d in g:
            m = Media(d["path"], width=d.get("width", -1),
                      height=d.get("height", -1), md5=d.get("md5", ""),
                      id=d.get("id", 0))
            m.score = d.get("score", 0)
            mg.append(m)
        out.append(mg)
    return out
