"""Serve the run viewer for a (possibly in-progress) stream file.

    python -m glim_tpu_torch.tools.watch --stream RUN.jsonl [--port 8080]
        [--commands COMMANDS.jsonl]

Twin of ``glim_tpu/tools/watch.py``. Serves the port's viewer/watch.html
plus the stream file on localhost; the page polls the stream, so an
in-progress run updates live (tail-follow). For offline replay no server
is needed: open watch.html directly and drop the .jsonl on it.

Producing a stream: set ``standard_viewer.stream_path`` in config_viewer
(or pass ``--viewer-stream`` to glim_tpu_torch.tools.glim_runner);
StandardViewer then appends one line per ``stream_interval`` seconds. This
is the watchable-run surface of the reference's OpenGL viewer
(standard_viewer_callbacks.cpp drawables).
"""

from __future__ import annotations

import argparse
import http.server
import json
import os
import sys


def make_server(stream: str, commands=None, host: str = "127.0.0.1", port: int = 8080):
    """The HTTP server (not yet serving): GET / the page, GET /stream the
    stream file, POST /command appends a JSON command to ``commands``."""
    html = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "viewer", "watch.html")
    stream = os.path.abspath(stream)
    commands = os.path.abspath(commands) if commands else None

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path.split("?")[0] != "/command" or commands is None:
                self.send_response(404)
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                cmd = json.loads(body)       # validate before appending
                with open(commands, "a") as f:
                    f.write(json.dumps(cmd) + "\n")
                out, code = b'{"ok": true}', 200
            except ValueError:
                out, code = b'{"ok": false, "error": "bad json"}', 400
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path in ("/", "/watch.html"):
                with open(html, "rb") as f:
                    body = f.read()
                ctype = "text/html"
            elif path == "/stream":
                try:
                    with open(stream, "rb") as f:
                        body = f.read()
                except OSError:
                    body = b""
                ctype = "application/x-ndjson"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # quiet
            pass

    return http.server.ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stream", required=True, help="viewer .jsonl stream")
    ap.add_argument("--commands", default=None, metavar="FILE.jsonl",
                    help="accept POST /command and append it here; pair with "
                         "glim_runner --commands FILE.jsonl for live interactive "
                         "corrections (loop_close etc.)")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)

    srv = make_server(args.stream, args.commands, args.host, args.port)
    print(f"serving http://{args.host}:{args.port}/?stream=/stream "
          f"(stream: {os.path.abspath(args.stream)})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
