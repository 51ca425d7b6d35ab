"""HTTP/REST gateway serving a study's trained surrogate ensemble.

A Merlin study leaves behind bundled training rows and (via
:class:`repro_torch.core.active.SurrogateSnapshot`) a resident deep-ensemble
surrogate.  This module puts a request-serving front end on that
snapshot so *other* tools — steering dashboards, calibration loops,
downstream samplers — can query the ensemble over plain HTTP while the
study keeps running:

    client -> HTTP handler thread -> ContinuousBatcher -> snapshot.predict
                                      (admission heap,      (one fused jit
                                       deadlines, shed)      launch/batch)

Everything is stdlib: ``http.server.ThreadingHTTPServer`` gives one
thread per connection; those threads park on their request's completion
event while the single batcher thread fuses concurrent requests into
bucket-sized device launches (see ``ContinuousBatcher`` in
core/engine.py for the admission policy).  No new dependencies.

Endpoints (JSON bodies in, JSON out):

* ``GET  /healthz``      — liveness + snapshot version (never auth'd)
* ``GET  /v1/stats``     — gateway + batcher + snapshot counters
* ``POST /v1/predict``   — ``{"points": [[...], ...]}`` -> mu/sigma
* ``POST /v1/calibrate`` — ``{"target": y}`` -> top-k candidate inputs
  whose predicted mean lands closest to the target (inverse query)
* ``POST /v1/what-if``   — ``{"point": [...]}`` -> prediction plus a
  local perturbation cloud (sensitivity around an operating point)
* ``POST /v1/refresh``   — fold newly bundled rows into the snapshot

Status mapping is the contract the benchmark and tests pin down:
``429`` (queue at ``--max-inflight``, shed before admission, with
``Retry-After``), ``504`` (per-request deadline passed while queued —
the request never executed), ``503`` (draining/stopped), ``401``
(``REPRO_AUTH_TOKEN`` set but Bearer token missing/wrong), ``400``
(malformed body).

Auth is the same shared secret the broker hello handshake uses
(``REPRO_AUTH_TOKEN``): client sends ``Authorization: Bearer <token>``;
comparison is constant-time.  Deadlines come from ``deadline_ms`` in the
body or an ``X-Deadline-Ms`` header.
"""

from __future__ import annotations

import hmac
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from repro_torch.core.engine import ContinuousBatcher, DeadlineExpired, EngineClosed
from repro_torch.core.queue import BrokerFull


class _BadRequest(ValueError):
    """Malformed request body -> HTTP 400 with the message."""


def _require(body: dict, key: str):
    if key not in body:
        raise _BadRequest(f"missing required field {key!r}")
    return body[key]


def _as_points(value, dims: int, what: str = "points") -> np.ndarray:
    try:
        X = np.asarray(value, np.float32)
    except (TypeError, ValueError) as e:
        raise _BadRequest(f"{what} is not numeric: {e}")
    if X.ndim == 1:
        X = X[None, :]
    if X.ndim != 2 or X.shape[0] == 0:
        raise _BadRequest(f"{what} must be a non-empty (n, d) array, "
                          f"got shape {tuple(X.shape)}")
    if X.shape[1] != dims:
        raise _BadRequest(f"{what} has {X.shape[1]} dims, "
                          f"snapshot expects {dims}")
    if not np.isfinite(X).all():
        raise _BadRequest(f"{what} contains non-finite values")
    return X


class SurrogateGateway:
    """Serve a :class:`SurrogateSnapshot` over HTTP with continuous
    batching, deadlines, load shedding, and graceful drain.

    ``naive=True`` swaps the batcher into its flush-per-request baseline
    mode (same wire protocol, one device launch per request) — the A/B
    arm of ``benchmarks/serve_latency.py``.

    ``refresh_s`` starts a background thread folding newly bundled rows
    into the snapshot every that-many seconds (the snapshot retrains off
    the serving path and swaps the model ref atomically, so inference
    never blocks on a retrain).
    """

    def __init__(self, snapshot, host: str = "127.0.0.1", port: int = 0,
                 max_inflight: int = 64, max_batch_rows: int = 256,
                 naive: bool = False, auth_token: Optional[str] = None,
                 default_deadline_ms: Optional[float] = None,
                 refresh_s: Optional[float] = None):
        self.snapshot = snapshot
        self.host = host
        self._requested_port = int(port)
        self.port: Optional[int] = None
        self.auth_token = (auth_token if auth_token is not None
                           else os.environ.get("REPRO_AUTH_TOKEN"))
        self.default_deadline_ms = default_deadline_ms
        self.refresh_s = refresh_s
        self.batcher = ContinuousBatcher(snapshot.predict,
                                         max_batch_rows=max_batch_rows,
                                         max_inflight=max_inflight,
                                         naive=naive)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._refresh_thread: Optional[threading.Thread] = None
        self._stop_refresh = threading.Event()
        self._draining = False
        self._lock = threading.Lock()
        self._http_stats: Dict[str, object] = {"requests": 0, "status": {}}

    # -- request plumbing ----------------------------------------------------
    def _count(self, status: int) -> None:
        with self._lock:
            self._http_stats["requests"] += 1
            st = self._http_stats["status"]
            st[str(status)] = st.get(str(status), 0) + 1

    def _authorized(self, handler) -> bool:
        if self.auth_token is None:
            return True
        hdr = handler.headers.get("Authorization", "")
        if not hdr.startswith("Bearer "):
            return False
        return hmac.compare_digest(hdr[len("Bearer "):].strip(),
                                   self.auth_token)

    def _deadline_s(self, body: dict, handler) -> Optional[float]:
        ms = body.get("deadline_ms")
        if ms is None:
            hdr = handler.headers.get("X-Deadline-Ms")
            if hdr is not None:
                try:
                    ms = float(hdr)
                except ValueError:
                    raise _BadRequest(f"bad X-Deadline-Ms header {hdr!r}")
        if ms is None:
            ms = self.default_deadline_ms
        if ms is None:
            return None
        ms = float(ms)
        if ms <= 0:
            raise _BadRequest("deadline_ms must be > 0")
        return ms / 1000.0

    def _infer(self, X: np.ndarray, deadline_s: Optional[float]):
        """Route rows through the batcher; returns ``(mu, sigma)``.

        Raises the batcher's typed errors; the dispatcher maps them to
        status codes.  The wait cap is the deadline plus slack for the
        in-flight launch — a request the batcher admitted always
        resolves, so a ``wait`` timeout only guards a wedged backend."""
        req = self.batcher.submit(X, deadline_s=deadline_s)
        cap = (deadline_s + 30.0) if deadline_s is not None else 300.0
        if not req.wait(timeout=cap):
            raise EngineClosed("inference did not complete in time")
        if req.error is not None:
            raise req.error
        return req.result

    # -- endpoint bodies -----------------------------------------------------
    def _do_predict(self, body: dict, handler) -> dict:
        X = _as_points(_require(body, "points"), self.snapshot.dims)
        mu, sd = self._infer(X, self._deadline_s(body, handler))
        return {"mu": np.asarray(mu, float).tolist(),
                "sigma": np.asarray(sd, float).tolist(),
                "n": int(len(X)),
                "version": self.snapshot.version}

    def _do_calibrate(self, body: dict, handler) -> dict:
        """Inverse query: which inputs does the ensemble predict to land
        nearest the target objective?  Candidates are uniform over the
        unit hypercube (the study's normalized input domain)."""
        target = float(_require(body, "target"))
        n_cand = int(body.get("n_candidates", 128))
        top_k = int(body.get("top_k", 4))
        if not 1 <= n_cand <= 4096:
            raise _BadRequest("n_candidates must be in [1, 4096]")
        if not 1 <= top_k <= n_cand:
            raise _BadRequest("top_k must be in [1, n_candidates]")
        rng = np.random.default_rng(int(body.get("seed", 0)))
        cand = rng.random((n_cand, self.snapshot.dims), np.float32)
        mu, sd = self._infer(cand, self._deadline_s(body, handler))
        mu = np.asarray(mu, float)
        sd = np.asarray(sd, float)
        order = np.argsort(np.abs(mu - target), kind="stable")[:top_k]
        return {"target": target,
                "version": self.snapshot.version,
                "candidates": [{"point": cand[i].astype(float).tolist(),
                                "mu": float(mu[i]),
                                "sigma": float(sd[i]),
                                "gap": float(abs(mu[i] - target))}
                               for i in order]}

    def _do_what_if(self, body: dict, handler) -> dict:
        """Local sensitivity: predict at a point and across a clipped
        Gaussian cloud around it, in one fused inference."""
        base = _as_points(_require(body, "point"), self.snapshot.dims,
                          "point")[0]
        radius = float(body.get("radius", 0.02))
        n_pert = int(body.get("n_perturb", 16))
        if not 0 < radius <= 0.5:
            raise _BadRequest("radius must be in (0, 0.5]")
        if not 1 <= n_pert <= 1024:
            raise _BadRequest("n_perturb must be in [1, 1024]")
        rng = np.random.default_rng(int(body.get("seed", 0)))
        cloud = np.clip(base[None, :]
                        + rng.normal(0.0, radius,
                                     (n_pert, self.snapshot.dims)),
                        0.0, 1.0).astype(np.float32)
        X = np.concatenate([base[None, :], cloud])
        mu, sd = self._infer(X, self._deadline_s(body, handler))
        mu = np.asarray(mu, float)
        nb = mu[1:]
        return {"mu": float(mu[0]),
                "sigma": float(np.asarray(sd, float)[0]),
                "radius": radius,
                "n_perturb": n_pert,
                "neighborhood": {"mu_mean": float(nb.mean()),
                                 "mu_std": float(nb.std()),
                                 "mu_min": float(nb.min()),
                                 "mu_max": float(nb.max())},
                "version": self.snapshot.version}

    def _do_refresh(self, body: dict, handler) -> dict:
        refreshed = self.snapshot.refresh()
        return {"refreshed": bool(refreshed),
                "version": self.snapshot.version,
                "rows": self.snapshot.rows}

    def stats(self) -> dict:
        with self._lock:
            http_stats = {"requests": self._http_stats["requests"],
                          "status": dict(self._http_stats["status"])}
        return {"http": http_stats,
                "batcher": self.batcher.stats(),
                "snapshot": {"version": self.snapshot.version,
                             "rows": self.snapshot.rows,
                             "dims": self.snapshot.dims},
                "draining": self._draining}

    # -- HTTP server ---------------------------------------------------------
    def _make_handler(self):
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive: reuse connections
            server_version = "merlin-serve"
            # headers and body leave as separate small writes; without
            # TCP_NODELAY, Nagle holds the body until the client's
            # delayed ACK (~40 ms on Linux) — which in continuous mode
            # gates the whole next batch, not just one client's latency
            disable_nagle_algorithm = True

            def log_message(self, *args):  # quiet: stats() has counters
                pass

            def _reply(self, status: int, payload: dict,
                       extra: Optional[dict] = None) -> None:
                blob = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                try:
                    self.wfile.write(blob)
                except (BrokenPipeError, ConnectionError):
                    pass  # client gave up; reply already counted
                gw._count(status)

            def do_GET(self) -> None:
                if self.path == "/healthz":
                    self._reply(200, {"ok": True,
                                      "draining": gw._draining,
                                      "version": gw.snapshot.version,
                                      "rows": gw.snapshot.rows})
                    return
                if not gw._authorized(self):
                    self._reply(401, {"error": "missing or bad "
                                               "Authorization bearer token"})
                    return
                if self.path == "/v1/stats":
                    self._reply(200, gw.stats())
                    return
                self._reply(404, {"error": f"no route {self.path!r}"})

            def do_POST(self) -> None:
                # drain the body FIRST, even on early-exit replies: with
                # HTTP/1.1 keep-alive an unread body would be parsed as
                # the connection's next request line
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    n = 0
                raw = self.rfile.read(n) if n > 0 else b""
                if not gw._authorized(self):
                    self._reply(401, {"error": "missing or bad "
                                               "Authorization bearer token"})
                    return
                route = {"/v1/predict": gw._do_predict,
                         "/v1/calibrate": gw._do_calibrate,
                         "/v1/what-if": gw._do_what_if,
                         "/v1/refresh": gw._do_refresh}.get(self.path)
                if route is None:
                    self._reply(404, {"error": f"no route {self.path!r}"})
                    return
                if gw._draining:
                    self._reply(503, {"error": "gateway is draining"})
                    return
                try:
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise _BadRequest("body must be a JSON object")
                    self._reply(200, route(body, self))
                except _BadRequest as e:
                    self._reply(400, {"error": str(e)})
                except (json.JSONDecodeError, UnicodeDecodeError) as e:
                    self._reply(400, {"error": f"bad JSON body: {e}"})
                except BrokerFull as e:
                    self._reply(429, {"error": str(e)},
                                extra={"Retry-After": "1"})
                except DeadlineExpired as e:
                    self._reply(504, {"error": str(e)})
                except EngineClosed as e:
                    self._reply(503, {"error": str(e)})
                except Exception as e:  # inference blew up: typed 500
                    self._reply(500, {"error":
                                      f"{type(e).__name__}: {e}"})

        return Handler

    def start(self) -> "SurrogateGateway":
        httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                    self._make_handler())
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name=f"merlin-serve-http-{self.port}")
        self._serve_thread.start()
        if self.refresh_s is not None:
            self._refresh_thread = threading.Thread(
                target=self._refresh_loop, daemon=True,
                name="merlin-serve-refresh")
            self._refresh_thread.start()
        return self

    def _refresh_loop(self) -> None:
        while not self._stop_refresh.wait(self.refresh_s):
            try:
                self.snapshot.refresh()
            except Exception:
                pass  # transient archive read races; next tick retries

    def stop(self, drain: bool = True, timeout: float = 30.0) -> bool:
        """Graceful shutdown: stop admitting (503), let admitted requests
        finish, then tear the listener down.  Returns True when the
        backlog fully drained within the timeout."""
        self._draining = True
        drained = True
        if drain:
            drained = self.batcher.drain(timeout=timeout)
        self.batcher.close()
        self._stop_refresh.set()
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=5.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
        return drained

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "SurrogateGateway":
        if self._httpd is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
