"""HTTP caption service (port of ``icee_tpu/serve/app.py``).

Parity target: the Flask app (``app/backend/run.py:16-61``): ``POST
/generate?mode=<m>`` with a multipart ``file`` field returns ``{"nic": ...,
"nic_att": ..., "stylenet": ..., "stylenet_att": ..., "path_img": ...}``
(all ``-`` on bad input), ``GET /images/<f>`` serves uploads, 500 with the
exception text on failure.  Stdlib ``ThreadingHTTPServer`` + a small
multipart parser; CORS headers as the reference's flask-cors setup.
``GET /`` serves the bundled frontend (``serve/static/``: ``/`` is
``index.html``, any other name its file there).

Run: ``python -m icee_tpu_torch.serve [--env .env] [--smoke] [--port N]
[--device cuda]``.
"""

from __future__ import annotations

import argparse
import email.parser
import email.policy
import json
import mimetypes
import os
import re
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from icee_tpu_torch.core.config import MODES
from icee_tpu_torch.serve.config import ServeConfig, load_config

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "static")


def parse_multipart(body: bytes, content_type: str):
    """-> {field_name: (filename, bytes)} for multipart/form-data."""
    msg = email.parser.BytesParser(policy=email.policy.default).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body
    )
    out = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        filename = part.get_filename()
        out[name] = (filename, part.get_payload(decode=True))
    return out


def make_handler(engine, config: ServeConfig):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *fmt_args):  # quiet unless debug
            if config.debug:
                super().log_message(fmt, *fmt_args)

        def do_OPTIONS(self):
            self._send(200, b"")

        def do_GET(self):
            if self.path.startswith("/images/"):
                name = os.path.basename(self.path[len("/images/"):])
                path = os.path.join(config.image_folder, name)
                ctype = "application/octet-stream"
            else:
                # the static frontend: "/" is index.html, any other name
                # its basename in the static folder
                name = ("index.html" if self.path in ("/", "") else
                        os.path.basename(self.path))
                path = os.path.join(STATIC_DIR, name)
                ctype = "text/html"
            if not os.path.isfile(path):
                self._send(404, b'{"error": "not found"}')
                return
            ctype = mimetypes.guess_type(path)[0] or ctype
            with open(path, "rb") as f:
                self._send(200, f.read(), ctype)

        def do_POST(self):
            if not self.path.startswith("/generate"):
                self._send(404, b'{"error": "not found"}')
                return
            m = re.search(r"[?&]mode=([a-z]+)", self.path)
            mode = m.group(1) if m else None
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                parts = parse_multipart(body,
                                        self.headers.get("Content-Type", ""))
            except Exception:  # malformed body: answer like a missing file
                parts = {}
            blank = {v: "-" for v in
                     ("nic", "nic_att", "stylenet", "stylenet_att")}
            blank["path_img"] = "-"
            if "file" not in parts or mode not in MODES:
                self._send(200, json.dumps(blank).encode())
                return
            filename, data = parts["file"]
            os.makedirs(config.image_folder, exist_ok=True)
            path = os.path.join(config.image_folder,
                                os.path.basename(filename or "upload.jpg"))
            try:
                # written under a temporary name and moved in, so that a
                # concurrent request for the same file name never reads a
                # half-written image
                fd, tmp = tempfile.mkstemp(dir=config.image_folder,
                                           prefix=".upload_")
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
                result = engine.caption(path, mode)
                result["path_img"] = "/images/" + os.path.basename(path)
                self._send(200, json.dumps(result).encode())
            except Exception as e:  # reference returns str(e), 500
                self._send(500, str(e).encode(), "text/plain")

    return Handler


def serve(config: Optional[ServeConfig] = None, smoke: bool = False,
          engine=None, device="cuda") -> ThreadingHTTPServer:
    """Build the service (not yet serving).  ``engine`` defaults to a
    :class:`CaptionEngine` on ``device``; ``batch_window_ms > 0`` wraps it
    in a :class:`BatchingEngine`."""
    from icee_tpu_torch.serve.engine import CaptionEngine

    config = config or load_config()
    if engine is None:
        engine = CaptionEngine(config, smoke_mode=smoke, device=device)
    if config.batch_window_ms > 0 and not hasattr(engine, "group_sizes"):
        from icee_tpu_torch.serve.batching import BatchingEngine

        engine = BatchingEngine(engine, window_ms=config.batch_window_ms)
    return ThreadingHTTPServer((config.backend_host, config.backend_port),
                               make_handler(engine, config))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", type=str, default=".env")
    parser.add_argument("--smoke", action="store_true",
                        help="serve with random weights (demo mode)")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device, e.g. cuda, cuda:1 or cpu")
    args = parser.parse_args(argv)
    config = load_config(args.env)
    if args.port:
        config.backend_port = args.port
    httpd = serve(config, smoke=args.smoke, device=args.device)
    print(f"caption service on http://{config.backend_host}:"
          f"{config.backend_port}")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
