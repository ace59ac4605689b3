"""Stdlib HTTP front end (counterpart of the JAX package's ``serve/server.py``):

    POST /v1/predict   {"instances": [[...], ...], "deadline_ms": 250}
                    -> {"predictions": {...}, "n": k}
    GET  /healthz      {"ok": true, "status": "ok|draining", ...}
    GET  /metrics      live registry snapshot + bucket hits + queue depth (JSON)

A ``ThreadingHTTPServer``: handler threads block on their request's future
while the micro-batcher's single worker runs the model. Errors are
structured — ``{"error": {"code", "message", "request_id"}}`` with 400
malformed input, 413 over the largest bucket, 429 queue full (with
``Retry-After``), 503 draining, 504 deadline — and every ``/v1/predict``
response echoes ``x-request-id``. ``shutdown()`` drains: intake stops and
accepted requests finish. Ledger windows, request tracing, SLO tracking,
``/admin/profile``, Prometheus text and multi-model registries arrive with
later slices of the port.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import secrets
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from tensorflowdistributedlearning_tpu_torch.serve.batcher import (
    DeadlineExceededError,
    MicroBatcher,
    QueueFullError,
    RequestTooLargeError,
    ServerClosedError,
)
from tensorflowdistributedlearning_tpu_torch.serve.engine import InferenceEngine

logger = logging.getLogger(__name__)

# Retry-After bounds (seconds) and the default with no observed drain yet
_RETRY_AFTER_MIN_S = 1
_RETRY_AFTER_MAX_S = 30
_RETRY_AFTER_DEFAULT_S = 5


def bind_ephemeral(host: str = "127.0.0.1", port: int = 0) -> socket.socket:
    """Bind (without listening) a TCP socket; ``port=0`` picks a free port
    the caller can read back before building the server around it."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        sock.bind((host, port))
    except OSError:
        sock.close()
        raise
    return sock


class ServingServer:
    """Engine + batcher behind a ThreadingHTTPServer."""

    def __init__(
        self,
        engine: InferenceEngine,
        batcher: MicroBatcher,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        result_timeout_s: float = 60.0,
        sock: Optional[socket.socket] = None,
    ):
        self.engine = engine
        self.batcher = batcher
        self.result_timeout_s = float(result_timeout_s)
        self.draining = False
        self._started_t = time.time()
        self._stop = threading.Event()
        self._shutdown_lock = threading.Lock()
        self._shut_down = False
        # (monotonic_t, cumulative completed) samples: the drain rate that
        # Retry-After on 429/503 is derived from
        self._drain_samples: Deque[Tuple[float, int]] = collections.deque(maxlen=64)
        self._drain_lock = threading.Lock()
        handler = type("Handler", (_Handler,), {"ctx": self})
        self._httpd = ThreadingHTTPServer((host, port), handler, bind_and_activate=False)
        self._httpd.request_queue_size = max(128, batcher.max_queue)
        if sock is not None:
            self._httpd.socket.close()
            self._httpd.socket = sock
            bound_host, bound_port = sock.getsockname()[:2]
            self._httpd.server_address = (bound_host, bound_port)
            self._httpd.server_name = socket.getfqdn(bound_host)
            self._httpd.server_port = bound_port
        else:
            self._httpd.allow_reuse_address = True
            self._httpd.server_bind()
        self._httpd.server_activate()
        self._httpd.daemon_threads = True
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingServer":
        self._serve_thread = threading.Thread(target=self._httpd.serve_forever, name="serve-http", daemon=True)
        self._serve_thread.start()
        logger.info("serving on %s (buckets %s)", self.url, self.engine.buckets)
        return self

    def wait(self) -> None:
        """Block until ``shutdown()`` (the CLI foreground)."""
        self._stop.wait()

    def install_signal_handlers(self, signals=None) -> None:
        """SIGTERM/SIGINT drain the server from a helper thread (the handler
        itself must return to the main thread's ``wait``). Main thread only."""
        import signal as signal_lib

        def handle(*_):
            threading.Thread(target=self.shutdown, name="serve-drain", daemon=True).start()

        for sig in signals or (signal_lib.SIGINT, signal_lib.SIGTERM):
            signal_lib.signal(sig, handle)

    @property
    def health_status(self) -> str:
        return "draining" if self.draining else "ok"

    def _completed(self) -> int:
        return self.engine.registry.counter("serve/completed").value

    def note_drain_progress(self) -> None:
        """Sample the completed counter (at most ~5 Hz) for Retry-After."""
        now = time.monotonic()
        with self._drain_lock:
            if self._drain_samples and now - self._drain_samples[-1][0] < 0.2:
                return
            self._drain_samples.append((now, self._completed()))

    def retry_after_s(self) -> int:
        """Queue depth / the drain rate of the last ~10 s, clamped to
        [1, 30] s; a default when nothing has drained yet."""
        depth = self.engine.registry.gauge("serve/queue_depth").value or 0
        now = time.monotonic()
        completed = self._completed()
        rate = 0.0
        with self._drain_lock:
            while self._drain_samples and now - self._drain_samples[0][0] > 10.0:
                self._drain_samples.popleft()
            if self._drain_samples:
                t0, c0 = self._drain_samples[0]
                if now - t0 >= 0.05 and completed > c0:
                    rate = (completed - c0) / (now - t0)
        if rate <= 0.0:
            return _RETRY_AFTER_DEFAULT_S
        return int(min(max(math.ceil(depth / rate), _RETRY_AFTER_MIN_S), _RETRY_AFTER_MAX_S))

    def metrics_snapshot(self) -> Dict:
        """The ``/metrics`` body."""
        reg = self.engine.registry
        return {
            "uptime_s": round(time.time() - self._started_t, 3),
            "draining": self.draining,
            "status": self.health_status,
            "buckets": {str(b): n for b, n in self.engine.bucket_hits.items()},
            "padding_waste": {str(b): w for b, w in self.engine.padding_waste.items()},
            "queue_depth": reg.gauge("serve/queue_depth").value or 0,
            "registry": reg.snapshot(),
        }

    def shutdown(self) -> None:
        """Graceful drain: refuse new work, finish accepted requests, stop
        the listener. Idempotent."""
        with self._shutdown_lock:
            if self._shut_down:
                return
            self._shut_down = True
        self.draining = True
        self.batcher.close(drain=True)
        # BaseServer.shutdown() waits on an event only serve_forever sets
        if self._serve_thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)
        self._stop.set()
        logger.info("serving stopped (drained)")


class _Handler(BaseHTTPRequestHandler):
    ctx: ServingServer  # bound by ServingServer via a subclass attribute
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    _request_id: Optional[str] = None

    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _json(self, status: int, payload: Dict, extra_headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self._request_id:
            self.send_header("x-request-id", self._request_id)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, code: str, message: str, retry_after: Optional[int] = None) -> int:
        error: Dict = {"code": code, "message": message}
        if self._request_id:
            error["request_id"] = self._request_id
        headers = None
        if retry_after is not None:
            error["retry_after_s"] = int(retry_after)
            headers = {"Retry-After": str(int(retry_after))}
        self._json(status, {"error": error}, extra_headers=headers)
        return status

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        self._request_id = None
        path = urllib.parse.urlparse(self.path).path
        if path == "/healthz":
            status = self.ctx.health_status
            self._json(
                503 if self.ctx.draining else 200,
                {
                    "ok": status == "ok",
                    "status": status,
                    "draining": self.ctx.draining,
                    "uptime_s": round(time.time() - self.ctx._started_t, 3),
                    "buckets": list(self.ctx.engine.buckets),
                },
            )
        elif path == "/metrics":
            self._json(200, self.ctx.metrics_snapshot())
        else:
            self._error(404, "not_found", f"no route for GET {self.path}")

    def do_POST(self):  # noqa: N802
        self._request_id = self.headers.get("x-request-id") or secrets.token_hex(8)
        if self.path != "/v1/predict":
            self._error(404, "not_found", f"no route for POST {self.path}")
            return
        t0 = time.perf_counter()
        status = self._predict()
        if status == 200:
            self.ctx.engine.registry.histogram("serve/request").record(time.perf_counter() - t0)
        self.ctx.note_drain_progress()

    def _predict(self) -> int:
        """The /v1/predict body; returns the HTTP status it answered with."""
        ctx = self.ctx
        if ctx.draining:
            return self._error(503, "draining", "server is draining; retry elsewhere", retry_after=ctx.retry_after_s())
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            instances = payload["instances"]
        except (ValueError, KeyError, TypeError) as e:
            return self._error(400, "bad_request", f"expected JSON {{'instances': [...]}}: {e}")
        try:
            x = np.asarray(instances, ctx.engine.input_dtype)
        except (ValueError, TypeError) as e:
            return self._error(400, "bad_request", f"instances not array-like: {e}")
        deadline_ms = payload.get("deadline_ms")
        if deadline_ms is not None and (isinstance(deadline_ms, bool) or not isinstance(deadline_ms, (int, float))):
            return self._error(400, "bad_request", f"deadline_ms must be a number, got {deadline_ms!r}")
        try:
            request = ctx.batcher.submit(x, deadline_ms=deadline_ms)
            out = request.result(timeout=ctx.result_timeout_s)
        except QueueFullError as e:
            return self._error(429, "queue_full", str(e), retry_after=ctx.retry_after_s())
        except RequestTooLargeError as e:
            return self._error(413, "request_too_large", str(e))
        except ServerClosedError as e:
            return self._error(503, "draining", str(e), retry_after=ctx.retry_after_s())
        except DeadlineExceededError as e:
            return self._error(504, "deadline_exceeded", str(e))
        except TimeoutError as e:
            return self._error(504, "result_timeout", str(e))
        except ValueError as e:  # wrong example shape
            return self._error(400, "bad_request", str(e))
        except Exception as e:  # noqa: BLE001 — engine failures still answer structurally
            logger.exception("inference failed")
            return self._error(500, "internal", f"{type(e).__name__}: {e}")
        predictions = {k: np.asarray(v).tolist() for k, v in out.items()}
        self._json(200, {"predictions": predictions, "n": request.n})
        return 200
