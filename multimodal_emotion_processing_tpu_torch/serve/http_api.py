"""HTTP front end of the batching server (serve/http_api.py of the JAX
package): the k-member ensemble over plain HTTP (the standard library's
`ThreadingHTTPServer`, no other dependency).  Every request goes through
`BatchingServer`, so concurrent HTTP clients are micro-batched into one
bucket program, and a lone client pays `max_delay_ms` over batch 1.

Endpoints:

  GET  /healthz   liveness, the member count and the batching stats
  GET  /spec      the feature contract: each key's shape and dtype (one
                  sample, no batch axis), the emotion names, and the binary
                  wire's key order and byte count
  POST /predict   body: a JSON object mapping each feature key to a nested
                  list of floats of exactly the /spec shape (one sample:
                  batching is the server's job).  Response: the ensemble's
                  mean logits, the calibrated per-emotion probabilities
                  (sigmoid(logit − offset), robot_demo.py:609) and the
                  named emotion map.  With `Content-Type:
                  application/octet-stream` the body is instead the raw
                  little-endian float32 buffers of every feature,
                  concatenated in /spec's `binary_order`.

Shape errors are 400s carrying the expected spec, an unknown path a 404,
a failed prediction a 500.  The JSON wire is float32-exact (numpy's tolist
gives each float32 as the double of the same value, and JSON round-trips
it); the binary wire is bit-exact by construction.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Sequence

import numpy as np


class HttpFrontend:
    """Serve a `BatchingServer` over HTTP.

    `sample_spec` maps feature key -> shape tuple (one sample, no batch
    axis); build it from any assembled sample, such as
    `{k: v.shape for k, v in sample.items() if k != "label"}`.
    `port=0` binds an ephemeral port (read `self.port`)."""

    def __init__(self, server, sample_spec: Dict[str, tuple],
                 emotion_names: Sequence[str], *,
                 host: str = "127.0.0.1", port: int = 8000):
        self.server = server
        self.spec = {k: tuple(int(d) for d in v) for k, v in sample_spec.items()}
        self.emotion_names = list(emotion_names)
        self._httpd = _Server((host, port), self._handler_class())
        self.host = host
        self.port = self._httpd.server_port
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "HttpFrontend":
        """Serve on a daemon thread; returns self (stop with close())."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="mep-torch-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Blocking serve (the CLI path); Ctrl-C returns."""
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- request handling ----------------------------------------------------
    def binary_order(self):
        """The binary wire's key order: the spec's keys, sorted."""
        return sorted(self.spec)

    def _parse_binary(self, body: bytes) -> Dict[str, np.ndarray]:
        """Raw little-endian float32 buffers concatenated in
        `binary_order`."""
        order = self.binary_order()
        counts = {k: int(np.prod(self.spec[k], dtype=np.int64)) for k in order}
        expected = 4 * sum(counts.values())
        if len(body) != expected:
            raise _BadRequest(
                f"binary body is {len(body)} bytes, expected {expected} "
                f"(float32 x {sum(counts.values())} values, keys in order "
                f"{order} with shapes "
                f"{ {k: list(self.spec[k]) for k in order} })")
        flat = np.frombuffer(body, dtype="<f4")
        sample, pos = {}, 0
        for k in order:
            n = counts[k]
            sample[k] = flat[pos:pos + n].reshape(self.spec[k])
            pos += n
        return sample

    def _parse_sample(self, body: bytes) -> Dict[str, np.ndarray]:
        try:
            obj = json.loads(body)
        except json.JSONDecodeError as e:
            raise _BadRequest(f"body is not valid JSON: {e}")
        if not isinstance(obj, dict):
            raise _BadRequest("body must be a JSON object of feature arrays")
        missing = sorted(set(self.spec) - set(obj))
        if missing:
            raise _BadRequest(
                f"missing feature keys {missing}; expected spec: "
                f"{ {k: list(v) for k, v in self.spec.items()} }")
        sample = {}
        for key, shape in self.spec.items():
            try:
                arr = np.asarray(obj[key], dtype=np.float32)
            except (TypeError, ValueError) as e:
                raise _BadRequest(f"feature {key!r} is not a numeric array: {e}")
            if arr.shape != shape:
                raise _BadRequest(
                    f"feature {key!r} has shape {list(arr.shape)}, expected "
                    f"{list(shape)} (one sample, no batch axis)")
            sample[key] = arr
        return sample

    def _predict(self, sample: Dict[str, np.ndarray]) -> Dict:
        logits, probs = self.server.predict(sample)
        probs = np.asarray(probs)
        return {
            "logits": np.asarray(logits).tolist(),
            "probs": probs.tolist(),
            "emotions": {name: float(p) for name, p in
                         zip(self.emotion_names, probs)},
        }

    def spec_document(self) -> Dict:
        """The /spec response."""
        order = self.binary_order()
        return {
            "features": {k: list(v) for k, v in self.spec.items()},
            "dtype": "float32",
            "emotions": self.emotion_names,
            # application/octet-stream contract: little-endian float32
            # buffers concatenated in this key order
            "binary_order": order,
            "binary_bytes": 4 * int(sum(
                np.prod(self.spec[k], dtype=np.int64) for k in order)),
        }

    def _handler_class(self):
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            # one keep-alive connection per client thread
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send(self, code: int, payload: Dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok",
                                     "members": int(frontend.server.k),
                                     "stats": frontend.server.stats()})
                elif self.path == "/spec":
                    self._send(200, frontend.spec_document())
                else:
                    self._send(404, {"error": f"unknown path {self.path!r}; "
                                              "try /healthz, /spec, POST /predict"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": f"unknown path {self.path!r}; "
                                              "POST /predict"})
                    return
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                try:
                    if ctype == "application/octet-stream":
                        sample = frontend._parse_binary(body)
                    else:
                        sample = frontend._parse_sample(body)
                except _BadRequest as e:
                    self._send(400, {"error": str(e)})
                    return
                try:
                    self._send(200, frontend._predict(sample))
                except Exception as e:  # surface, don't kill the thread
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: a burst of concurrent
    # clients overflows it and the dropped connections retry on the
    # kernel's timers.  A deep backlog, and daemon handler threads so that
    # close() never hangs on a stuck client.
    request_queue_size = 128
    daemon_threads = True


class _BadRequest(Exception):
    pass
