"""Local web server of the port's GUI (port of sarpro_tpu/gui/server.py;
stdlib http.server, no deps), with the JAX server's endpoints. Jobs run on
the worker's device, the card unless the caller asks for the CPU; the
handler threads read the worker's progress and result queue only, and
render previews on the host.

Endpoints:
  GET  /                 — the single-page UI
  GET  /api/state        — GuiState + run status + completion poll
  POST /api/state        — update configuration
  POST /api/process      — start the background worker
  GET  /api/logs         — drain ring-buffer log events (level filter
                           client-side); `?since=N` returns only events past
                           cursor N as {"next", "events"} so pollers never
                           re-render history
  POST /api/export-log   — write a .sarpolog file
  GET  /api/cli          — generated CLI command
  POST /api/preset/save  — save .sarpro preset
  POST /api/preset/load  — load .sarpro preset
  GET  /api/stats        — CPU/RAM footer stats
  GET  /api/listdir      — server-side directory listing (the file-dialog
                           equivalent of the reference's rfd browse buttons,
                           src/gui/processing.rs); includes recently visited
                           directories
  GET  /api/preview      — rendered view of the last completed single-file
                           output (JPEG as-is; TIFF re-rendered to PNG by
                           the port's PNG writer, io/png.py)
"""
from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from . import state as state_mod
from .state import GuiState, Worker, generate_cli_command, load_preset, save_preset

logger = logging.getLogger("sarpro")

_STATIC = Path(__file__).parent / "static"


def list_directory(path: str | None) -> dict:
    """Directory listing for the browse dialog. Local tool semantics (like the
    reference's rfd native dialogs): the server runs as the user, so it lists
    what the user can list. `.SAFE` directories are flagged selectable."""
    p = Path(path).expanduser() if path else Path.cwd()
    p = p.resolve()
    if not p.is_dir():
        raise NotADirectoryError(str(p))
    entries = []
    for child in sorted(p.iterdir(), key=lambda c: (not c.is_dir(), c.name.lower())):
        if child.name.startswith("."):
            continue
        is_dir = child.is_dir()
        entries.append({
            "name": child.name,
            "dir": is_dir,
            "safe": is_dir and child.name.upper().endswith(".SAFE"),
        })
    return {
        "path": str(p),
        "parent": str(p.parent) if p.parent != p else None,
        "entries": entries,
    }


def render_preview(path: Path, max_side: int = 1024) -> tuple[bytes, str]:
    """Preview bytes + content type for a produced output file.

    JPEG outputs are served as-is; (Geo)TIFF outputs (u8/u16, 1 or 2 bands)
    are min-max rendered to an 8-bit PNG thumbnail of band 1. The JAX
    function's Pillow `thumbnail` leaves this image as it is: with
    step = ceil(max(h, w) / max_side) neither decimated side exceeds
    max_side, so no resize follows the decimation."""
    suffix = path.suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        return path.read_bytes(), "image/jpeg"
    if suffix not in (".tif", ".tiff"):
        raise ValueError(f"no preview for {suffix!r}")
    import numpy as np

    from ..io.png import encode_gray8
    from ..io.tiffio import TiffReader

    reader = TiffReader(path)
    try:
        step = max(1, -(-max(reader.height, reader.width) // max_side))
        if reader.tiled:
            # read_strip_range on tiled layouts falls back to a full read —
            # do that ONCE and decimate, never per sampled row
            band = reader.read(1)[::step, ::step]
        else:
            # decimated block reads: each strip decodes at most once and
            # memory stays near thumbnail scale for multi-hundred-MP outputs
            block = 2048
            rows = []
            for r0 in range(0, reader.height, block):
                r1 = min(r0 + block, reader.height)
                first = -(-r0 // step) * step  # first sampled row >= r0
                if first < r1:
                    rows.append(reader.read_strip_range(r0, r1)
                                [first - r0::step, ::step])
            band = np.concatenate(rows)
    finally:
        reader.close()
    band = np.asarray(band).astype(np.float32)
    lo, hi = float(band.min()), float(band.max())
    u8 = np.zeros(band.shape, np.uint8) if hi <= lo else \
        np.clip((band - lo) / (hi - lo) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return encode_gray8(u8), "image/png"


def make_server(host: str = "127.0.0.1", port: int = 8377, device="cuda"):
    """The GUI's HTTP server on (host, port), its jobs on `device`, which is
    resolved at once: RuntimeError when CUDA is asked for and absent."""
    worker = Worker(device)
    gui = GuiState()
    lock = threading.Lock()
    log_events: list[dict] = []
    log_base = [0]  # cursor of log_events[0] (events drop off the front)
    recent_dirs: list[str] = []

    def remember_dir(p: str) -> None:
        if p in recent_dirs:
            recent_dirs.remove(p)
        recent_dirs.insert(0, p)
        del recent_dirs[8:]

    # DNS-rebinding guard: a remote page can point its own hostname at
    # 127.0.0.1 and drive this API from the victim's browser; the browser
    # still sends the attacker hostname in Host, so requiring a local (or
    # explicitly bound) Host header blocks it for every endpoint, including
    # the filesystem-listing /api/listdir. An explicit wildcard bind
    # (--host 0.0.0.0/::) is the operator opting into remote access — the
    # browser then sends the machine's real address, which we cannot
    # enumerate, so the check is skipped for wildcard binds.
    wildcard_bind = host in ("0.0.0.0", "::", "")
    allowed_hosts = {"localhost", "127.0.0.1", "[::1]", host.lower()}

    def drain_result():
        """Move a finished worker result into gui.last_result (call under
        `lock`); both /api/state and /api/preview need it."""
        done = worker.poll()
        if done is not None:
            gui.last_result = done
        return gui.last_result

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _host_ok(self) -> bool:
            if wildcard_bind:
                return True
            raw = (self.headers.get("Host") or "").strip().lower()
            if raw.startswith("["):  # [v6]:port
                name = raw.split("]")[0] + "]"
            else:
                name = raw.split(":")[0]
            return name in allowed_hosts

        def _json(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if not self._host_ok():
                self._json({"error": "forbidden host"}, 403)
                return
            if self.path == "/" or self.path == "/index.html":
                body = (_STATIC / "index.html").read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/api/state":
                with lock:
                    drain_result()
                    gui.running = worker.busy()
                    d = gui.to_dict()
                    d["progress"] = worker.progress if gui.running else None
                    self._json(d)
            elif self.path.startswith("/api/logs"):
                with lock:
                    events = worker.ring.drain()
                    log_events.extend(
                        {"level": e.level, "timestamp": e.timestamp,
                         "message": e.message, "target": e.target}
                        for e in events
                    )
                    dropped = max(0, len(log_events) - 1000)
                    if dropped:
                        del log_events[:dropped]
                        log_base[0] += dropped
                    total = log_base[0] + len(log_events)
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlparse(self.path).query)
                    since = q.get("since")
                    if since is None:
                        self._json(list(log_events))
                    else:
                        try:
                            cur = int(since[0])
                        except ValueError:
                            cur = 0
                        if cur > total:
                            # stale cursor from before a server restart:
                            # resend the full (new) history
                            cur = 0
                        start = max(0, cur - log_base[0])
                        self._json({"next": total,
                                    "events": log_events[start:]})
            elif self.path == "/api/cli":
                with lock:
                    self._json({"command": generate_cli_command(gui)})
            elif self.path == "/api/stats":
                self._json(state_mod.system_stats())
            elif self.path.startswith("/api/crs"):
                # live target-CRS validation (debounced field hint): name +
                # projection method + which backend tier will evaluate it
                q = urllib.parse.urlparse(self.path).query
                args = urllib.parse.parse_qs(q)
                from ..io.geodesy import describe_crs

                self._json(describe_crs(args.get("value", [""])[0]))
            elif self.path.startswith("/api/listdir"):
                q = urllib.parse.urlparse(self.path).query
                args = urllib.parse.parse_qs(q)
                try:
                    listing = list_directory(args.get("path", [None])[0])
                    with lock:
                        remember_dir(listing["path"])
                        listing["recents"] = list(recent_dirs)
                    self._json(listing)
                except (OSError, NotADirectoryError) as e:
                    self._json({"error": str(e)}, 400)
            elif self.path.startswith("/api/preview"):
                with lock:
                    # direct API consumers may hit preview before any
                    # /api/state poll
                    result = drain_result()
                out = (result or {}).get("output") if isinstance(result, dict) \
                    else None
                if not out or not Path(out).is_file():
                    self._json({"error": "no output to preview"}, 404)
                    return
                try:
                    body, ctype = render_preview(Path(out))
                except Exception as e:  # noqa: BLE001 — corrupt/odd output
                    self._json({"error": str(e)}, 415)      # must not kill
                    return                                  # the thread
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if not self._host_ok():
                self._json({"error": "forbidden host"}, 403)
                return
            try:
                data = self._body()
            except (ValueError, json.JSONDecodeError):
                self._json({"error": "bad json"}, 400)
                return
            if self.path == "/api/state":
                with lock:
                    try:
                        gui.apply(data)
                        self._json(gui.to_dict())
                    except (ValueError, KeyError) as e:
                        self._json({"error": str(e)}, 400)
            elif self.path == "/api/process":
                with lock:
                    if worker.start(gui):
                        gui.last_result = None
                        self._json({"started": True})
                    else:
                        self._json({"started": False, "error": "busy"}, 409)
            elif self.path == "/api/export-log":
                path = data.get("path", "sarpro.sarpolog")
                worker.ring.export_log(path)
                self._json({"saved": path})
            elif self.path == "/api/preset/save":
                with lock:
                    try:
                        save_preset(gui, data["path"])
                        self._json({"saved": data["path"]})
                    except (OSError, KeyError) as e:
                        self._json({"error": str(e)}, 400)
            elif self.path == "/api/preset/load":
                with lock:
                    try:
                        load_preset(gui, data["path"])
                        self._json(gui.to_dict())
                    except (OSError, ValueError, KeyError) as e:
                        self._json({"error": str(e)}, 400)
            else:
                self._json({"error": "not found"}, 404)

    server = ThreadingHTTPServer((host, port), Handler)
    # the jobs' worker, for a caller that drives the server in its own
    # process (its device, its last batch progress)
    server.worker = worker
    return server


def main():
    import argparse

    ap = argparse.ArgumentParser(prog="sarpro-gui-torch",
                                 description="SARPRO GUI server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8377)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    srv = make_server(args.host, args.port)
    print(f"sarproUI listening on http://{args.host}:{args.port}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
