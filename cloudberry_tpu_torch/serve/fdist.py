"""cbfdist — the gpfdist analog: a standalone scatter file server.

The reference's gpfdist (src/bin/gpfdist/gpfdist.c, libevent HTTP) serves
delimited files to every segment in parallel, handing each requester a
disjoint slice so the cluster reads the file exactly once. This analog
speaks plain HTTP (stdlib, threaded): ``GET /<relpath>?segment=i&nseg=N``
returns line stripes ``idx % N == i`` — deterministic scatter, so N
segment fetches partition the file with no coordination state on the
server. Without query args the whole file returns.

Run standalone: ``python -m cloudberry_tpu_torch fdist --root DIR --port P``.
External-table scans (plan/planner.py refresh_external_table) fetch their
per-segment stripes from it concurrently.
"""

from __future__ import annotations

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class _Handler(BaseHTTPRequestHandler):
    root = "."

    def log_message(self, *a):  # quiet by default
        pass

    def do_GET(self):
        from cloudberry_tpu_torch.utils.faultinject import fault_point

        fault_point("fdist_get")
        u = urlparse(self.path)
        rel = u.path.lstrip("/")
        # no traversal: the resolved path must stay under root
        full = os.path.realpath(os.path.join(self.root, rel))
        rootr = os.path.realpath(self.root)
        if not (full == rootr or full.startswith(rootr + os.sep)) \
                or not os.path.isfile(full):
            self.send_error(404, "no such file")
            return
        q = parse_qs(u.query)
        with open(full, "rb") as f:
            body = f.read()
        if "nseg" in q:
            nseg = max(int(q["nseg"][0]), 1)
            seg = int(q.get("segment", ["0"])[0]) % nseg
            lines = body.splitlines(keepends=True)
            # a final line without its newline must not merge into the
            # next stripe when the client concatenates segment fetches
            body = b"".join(
                ln if ln.endswith((b"\n", b"\r")) else ln + b"\n"
                for i, ln in enumerate(lines) if i % nseg == seg)
        self.send_response(200)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def serve(root: str, port: int = 0, host: str = "127.0.0.1"):
    """Start the server on a daemon thread; returns (server, port)."""
    handler = type("H", (_Handler,), {"root": root})
    srv = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=srv.serve_forever, name="cbtpu_torch-fdist",
                         daemon=True)
    t.start()
    return srv, srv.server_address[1]


def main(root: str, port: int, host: str = "0.0.0.0") -> None:
    handler = type("H", (_Handler,), {"root": root})
    srv = ThreadingHTTPServer((host, port), handler)
    print(f"cbfdist serving {root} on {host}:{srv.server_address[1]}",
          flush=True)
    srv.serve_forever()
