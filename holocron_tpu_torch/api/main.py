"""Inference HTTP service (``api/app/main.py``): ``GET /status`` and
``POST /classification`` with an ``X-Process-Time`` header, on the stdlib HTTP server,
which needs no package beyond the standard library.

    HOLOCRON_DEVICE=cpu python -m holocron_tpu_torch.api.main   # the CPU
    python -m holocron_tpu_torch.api.main                       # the card
"""

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import config
from .routes import classification
from .schemas import Status


class Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 keep-alive: every response carries Content-Length, so persistent
    # connections are safe; HTTP/1.0 would close the socket after each response and
    # make concurrent clients reconnect (ECONNRESET under load)
    protocol_version = "HTTP/1.1"
    # keep-alive with Nagle stalls the body's write behind the headers' delayed ACK
    # (~40 ms a request); a socketserver handler attribute (StreamRequestHandler.setup)
    disable_nagle_algorithm = True

    def _send(self, code: int, payload: dict, t0: float, timings: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Process-Time", str(time.time() - t0))
        # per-stage attribution (decode / queue wait / device call / batch size)
        for key, value in (timings or {}).items():
            self.send_header(f"X-{key.replace('_', '-').title()}", f"{value:.3f}")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        t0 = time.time()
        if self.path == "/status":
            payload = Status(status="ok", project=config.PROJECT_NAME, version=config.VERSION)
            self._send(200, payload.model_dump(), t0)
        else:
            self._send(404, {"detail": "Not Found"}, t0)

    def do_POST(self):  # noqa: N802
        t0 = time.time()
        # drain the body before ANY response: under keep-alive an unread body would be
        # parsed as the next request line
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)
        if self.path != "/classification":
            self._send(404, {"detail": "Not Found"}, t0)
            return
        # a raw image body, or multipart (the first file part)
        content_type = self.headers.get("Content-Type", "")
        if content_type.startswith("multipart/form-data"):
            boundary = content_type.split("boundary=")[-1].encode()
            parts = data.split(b"--" + boundary)
            data = b""
            for part in parts:
                if b"\r\n\r\n" in part and b"filename=" in part:
                    data = part.split(b"\r\n\r\n", 1)[1].rstrip(b"\r\n")
                    break
        if not data:
            self._send(422, {"detail": "no image payload"}, t0)
            return
        timings: dict = {}
        try:
            candidate = classification.classify(data, timings)
        except Exception as e:  # decoding or inference failure: answer, keep serving
            self._send(400, {"detail": f"invalid image: {e}"}, t0)
            return
        self._send(200, candidate.model_dump(), t0, timings)

    def log_message(self, fmt, *log_args):  # quiet
        pass


class _Server(ThreadingHTTPServer):
    # a burst of new connections overflows the default listen backlog of 5 and the
    # kernel resets the excess: size it for the batcher's design load
    request_queue_size = 128


def serve(host: str = config.HOST, port: int = config.PORT) -> ThreadingHTTPServer:
    return _Server((host, port), Handler)


if __name__ == "__main__":
    print(f"Serving {config.PROJECT_NAME} on {config.HOST}:{config.PORT}")
    serve().serve_forever()
