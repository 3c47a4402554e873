"""HTTP front for the serving engine (the port's own copy of the JAX
package's ``serving_http.py``), standard library only:

- ``POST /v1/predict`` — JSON body
  ``{"channels": [global channel ids], "images": [[...], ...]}``
  (one image ``(k, H, W)`` or a batch ``(B, k, H, W)`` as nested lists),
  or a raw ``.npy`` body (``Content-Type: application/x-npy``) with the
  channel ids in the ``X-Channels`` header (``"0,2,5"``). Responds JSON
  ``{"outputs": [[...], ...]}`` or ``.npy``, mirroring the request type.
  Single images go through the dynamic micro-batcher (cross-request
  coalescing); batches run through the synchronous bucketed path.
- ``GET /v1/stats`` — the engine's latency/throughput summary.
- ``GET /healthz`` — liveness.

``ThreadingHTTPServer`` runs one thread per connection; the engine runs one
forward at a time, so it is the serialisation point.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .serving import ServingEngine

__all__ = ["ServingHTTPServer"]


class _Handler(BaseHTTPRequestHandler):
    engine: ServingEngine  # set by ServingHTTPServer

    # silence per-request stderr logging (the engine keeps real stats)
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            self._send_json(200, {"status": "ok"})
        elif self.path == "/v1/stats":
            self._send_json(200, self.engine.stats.summary())
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/v1/predict":
            self._send_json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            if ctype == "application/x-npy":
                images = np.load(io.BytesIO(raw), allow_pickle=False)
                channels = [int(c) for c in
                            (self.headers.get("X-Channels") or "").split(",") if c != ""]
                as_npy = True
            else:
                req = json.loads(raw)
                images = np.asarray(req["images"], np.float32)
                channels = [int(c) for c in req["channels"]]
                as_npy = False
            if images.ndim == 3:  # single (k, H, W) image -> micro-batcher
                out = self.engine.submit(images, channels).result(timeout=120)[None]
                squeeze = True
            elif images.ndim == 4:
                out = self.engine.predict(images, channels)
                squeeze = False
            else:
                raise ValueError(f"images must be (k,H,W) or (B,k,H,W), got {images.shape}")
        except Exception as e:  # surfaced to the client, server stays up
            self._send_json(400, {"error": str(e)})
            return
        out = np.asarray(out, np.float32)
        payload = out[0] if squeeze else out
        if as_npy:
            buf = io.BytesIO()
            np.save(buf, payload)
            self._send(200, buf.getvalue(), "application/x-npy")
        else:
            self._send_json(200, {"outputs": payload.tolist()})


class ServingHTTPServer:
    """Bind a ServingEngine to an HTTP port.

    >>> srv = ServingHTTPServer(engine, port=0).start()   # 0 = ephemeral
    >>> srv.port  # actual bound port
    >>> srv.stop()
    """

    def __init__(self, engine: ServingEngine, *, host: str = "127.0.0.1", port: int = 8000):
        self.engine = engine
        handler = type("BoundHandler", (_Handler,), {"engine": engine})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ServingHTTPServer":
        self.engine.start()  # micro-batcher collector
        if self._thread is None:
            self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._httpd.server_close()
        self.engine.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
