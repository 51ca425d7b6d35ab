"""NetBroker: the shared-filesystem-free broker layer (paper Sec. 2-3).

The paper's producers and consumers on *different batch allocations*
coordinate through a standalone RabbitMQ host — not through a parallel
filesystem.  This module is that host:

* :class:`BrokerServer` fronts ANY :class:`~repro_torch.core.queue.Broker`
  backend (InMemoryBroker or FileBroker) over a length-prefixed JSON TCP
  protocol with one daemon thread per connection.  Blocking ``get``
  requests park in the handler thread on the backend's condition variable,
  so idle consumers cost zero wire traffic — no client polling.
* :class:`NetBroker` is a TCP client implementing the full Broker
  protocol.  Batched leases (``get_many``/``ack_many``) are one round-trip
  each; every calling thread gets its own connection so a WorkerPool
  sharing one NetBroker never serializes a blocking get behind an ack.

Failure model (what makes reconnect safe):

* All queue and lease state is **server-held** (in the backend).  A client
  that vanishes mid-lease simply never acks; the lease expires and the
  task redelivers exactly like a dead in-process worker's.
* Acks are idempotent in every backend, so a client that re-sends an ack
  after a reconnect (request applied, response lost) is a no-op.
* Puts retried across a reconnect may duplicate a task — delivery is
  at-least-once by contract, and the runtime's once-markers make duplicate
  execution a no-op.
* :meth:`NetBroker._call` transparently reconnects with backoff for up to
  ``reconnect_timeout`` seconds, then raises
  :class:`~repro_torch.core.queue.BrokerUnavailable`; workers treat that as
  transient and keep polling, so a broker server restart (same address)
  heals without worker restarts.

URL scheme (``make_broker``): ``mem://`` (fresh InMemoryBroker),
``file:///path`` (FileBroker on a shared directory), ``tcp://host:port``
(NetBroker), ``shard://h1:p1,h2:p2`` or a list of URLs (a
:class:`~repro_torch.core.shardbroker.ShardedBroker` federation).
``MerlinRuntime(broker=...)`` accepts all of these directly.

Server-side errors relay as structured replies carrying the exception
class name, so typed conditions — notably
:class:`~repro_torch.core.queue.BrokerFull` backpressure — survive the wire.
(Keep backends' ``put_timeout`` below the client's ``request_grace``,
default 10 s, or a blocking put times the socket out first.)

Wire codec negotiation (core/wirecodec.py): every connection starts in
JSON — the compatibility floor.  A client that prefers the binary codec
sends ``{"op": "hello", "codecs": ["bin1", "json"]}`` as its first
request; a codec-aware server replies ``{"ok": true, "codec": "bin1",
"codecs": [...]}`` and both sides switch for the rest of the
connection.  An old server answers hello with its normal unknown-op
error — the client just stays on JSON — and an old client never sends
hello, so mixed-codec fleets interoperate and a rolling upgrade never
bricks a federation.  A frame that arrives intact but fails to decode
is *quarantined*: the server replies with a typed ``CodecError``
instead of killing the connection thread (transport-level garbage —
truncated length prefix, oversized frame — still drops the
connection).

Deployment: ``python -m repro_torch.launch.serve broker-serve`` runs a
BrokerServer as a standalone process (see examples/quickstart.py
``--two-process``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac as _hmac
import os
import socket
import struct
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.queue import (Broker, BrokerError, BrokerFull,
                              BrokerUnavailable, FileBroker, InMemoryBroker,
                              Lease, StaleEpochError, Task,
                              _normalize_queues, task_to_wire)
from repro_torch.core.resilience import BackoffPolicy, CircuitBreaker
from repro_torch.core.wirecodec import (CodecError, DEFAULT_PREFERENCE, JSON_CODEC,
                                  get_codec, negotiate_codec)


class AuthError(BrokerError):
    """The hello handshake's HMAC was missing or invalid (shared-secret
    auth, ``REPRO_AUTH_TOKEN``) — or an op arrived before authenticating
    on a server that requires it."""


def hello_mac(token: str, codecs: Sequence[str]) -> str:
    """HMAC-SHA256 over the hello's codec offer, keyed by the shared
    secret.  Binding the offer (not just a constant) means a recorded
    hello cannot be replayed with a different negotiation."""
    msg = ("merlin-hello:" + ",".join(codecs)).encode()
    return _hmac.new(token.encode(), msg, hashlib.sha256).hexdigest()


# structured server errors carry the exception class name; the client maps
# it back to the right BrokerError subclass so e.g. backpressure
# (BrokerFull) is catchable as BrokerFull on the producer's side of the
# wire, not as a generic failure.  CodecError rides along so a
# quarantined frame surfaces typed on the sender's side too.
_ERROR_TYPES = {"BrokerFull": BrokerFull,
                "StaleEpochError": StaleEpochError,
                "CodecError": CodecError,
                "AuthError": AuthError}

# one frame = one request or response; big enough for a 32-task lease batch
# of fat payloads, small enough to reject garbage (e.g. an HTTP client)
_MAX_FRAME = 32 * 1024 * 1024


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _send_frame(sock: socket.socket, obj: dict, codec=JSON_CODEC) -> None:
    # encode failures raise BrokerError, NOT CodecError: an unencodable
    # object is a local bug, and BrokerError is outside the client's
    # retry-on-transport-failure set, so it surfaces instead of looping
    try:
        data = codec.encode(obj)
    except (TypeError, ValueError) as e:
        raise BrokerError(f"unencodable {codec.name} frame: {e}") from e
    if len(data) > _MAX_FRAME:
        raise BrokerError(f"frame of {len(data)} bytes exceeds {_MAX_FRAME}")
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_raw(sock: socket.socket) -> bytes:
    """One intact length-prefixed frame, codec-agnostic.

    Transport-level garbage (truncated prefix, oversized length — e.g.
    an HTTP client) raises ConnectionError: the stream itself is
    unusable.  Whether the *payload* decodes is the caller's problem —
    that split is what lets the server quarantine a corrupt frame
    without dropping the connection."""
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    if n > _MAX_FRAME:
        raise ConnectionError(f"oversized frame ({n} bytes)")
    return _recv_exact(sock, n)


def _recv_frame(sock: socket.socket, codec=JSON_CODEC) -> dict:
    return codec.decode(_recv_raw(sock))


def parse_address(address: str) -> Tuple[str, int]:
    """``tcp://host:port`` or bare ``host:port`` -> (host, port)."""
    if address.startswith("tcp://"):
        address = address[len("tcp://"):]
    host, sep, port = address.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"broker address must be host:port, got {address!r}")
    return host or "127.0.0.1", int(port)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class BrokerServer:
    """Serve any Broker backend to NetBroker clients over TCP.

    One daemon thread per connection; requests on a connection run in
    order (clients parallelize with per-thread connections).  A blocking
    ``get_many`` waits inside the backend for at most ``MAX_BLOCK_S`` per
    request — clients chunk longer timeouts into successive requests, which
    bounds how long a handler thread can be parked and lets ``stop()``
    return promptly.

    ``codecs`` is the preference-ordered list of wire codecs this server
    is willing to speak (advertised in the hello reply); ``("json",)``
    emulates a binary-unaware server for rolling-upgrade testing.  The
    ``shm_path`` option additionally serves the same backend over a
    same-host shared-memory registry (see core/shmring.py).
    """

    MAX_BLOCK_S = 10.0
    # served puts must come back strictly BEFORE the clients' socket
    # timeout (request_grace, 10 s) or the BrokerFull reply loses the race
    # and the client re-sends the batch; half the grace leaves room for
    # request decode + scheduling jitter
    MAX_PUT_BLOCK_S = 5.0

    def __init__(self, backend: Broker, host: str = "127.0.0.1",
                 port: int = 0, codecs: Sequence[str] = DEFAULT_PREFERENCE,
                 shm_path: Optional[str] = None,
                 auth_token: Optional[str] = None):
        self.backend = backend
        self.auth_token = auth_token
        self.codecs = tuple(codecs)
        for name in self.codecs:
            get_codec(name)  # fail fast on a typo'd codec name
        self.shm_path = shm_path
        self._shm_listener = None
        # clamp the backend's backpressure window like MAX_BLOCK_S clamps
        # gets: a put blocking past the clients' request_grace would make
        # them time out mid-put, reconnect, and re-send the batch —
        # duplicating every admitted task and stacking blocked handler
        # threads — instead of receiving the typed BrokerFull
        pt = getattr(backend, "_put_timeout", None)
        if pt is not None and pt > self.MAX_PUT_BLOCK_S:
            backend._put_timeout = self.MAX_PUT_BLOCK_S
        self.host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self._lsock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self.stats = {"connections": 0, "requests": 0, "errors": 0,
                      "codec_errors": 0, "auth_failures": 0,
                      "codecs": {name: 0 for name in self.codecs}}

    @property
    def address(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    def start(self) -> "BrokerServer":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self._requested_port))
        s.listen(128)
        self._lsock = s
        self.port = s.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"netbroker-accept-{self.port}")
        self._accept_thread.start()
        if self.shm_path is not None:
            from repro_torch.core.shmring import ShmListener
            self._shm_listener = ShmListener(
                self.shm_path, self._dispatch,
                max_block_s=self.MAX_BLOCK_S).start()
        return self

    def stop(self) -> None:
        """Close the listener and all client connections.

        Connections are closed abortively (SO_LINGER 0 -> RST): a graceful
        FIN would leave the server side in FIN_WAIT_2 until every client
        closes too, blocking a restart from re-binding this port.  RST
        destroys the kernel state immediately — and clients already treat
        a reset exactly like a crashed server (reconnect, idempotent
        re-ack).  Handler threads parked in a backend wait finish their
        (bounded) wait, fail to write to the closed socket, and exit."""
        self._stopping.set()
        if self._shm_listener is not None:
            self._shm_listener.stop()
            self._shm_listener = None
        if self._lsock is not None:
            # shutdown() first: close() alone does NOT wake a thread blocked
            # in accept()/recv(), and the in-flight syscall would keep the
            # LISTEN socket alive, blocking a restart from re-binding
            try:
                self._lsock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._lsock.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                c.shutdown(socket.SHUT_RDWR)  # wake the handler's recv()
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)

    def serve_forever(self, poll: float = 0.5) -> None:
        while not self._stopping.is_set():
            time.sleep(poll)

    def __enter__(self) -> "BrokerServer":
        if self._lsock is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return  # listener closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
                self.stats["connections"] += 1
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="netbroker-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        codec = JSON_CODEC  # every connection starts on the floor
        counted = False  # stats["codecs"]: one bump per connection
        authed = self.auth_token is None  # no token -> open server
        try:
            while not self._stopping.is_set():
                try:
                    raw = _recv_raw(conn)
                except (ConnectionError, OSError, struct.error):
                    return  # client went away / stream unusable: drop conn
                try:
                    req = codec.decode(raw)
                    if not isinstance(req, dict):
                        raise CodecError("frame is not a request object")
                except CodecError as e:
                    # quarantine: the frame arrived intact but does not
                    # decode in the negotiated codec — reply typed and keep
                    # the connection (and its handler thread) alive
                    self.stats["codec_errors"] += 1
                    try:
                        _send_frame(conn, {"ok": False,
                                           "error_type": "CodecError",
                                           "error": f"CodecError: {e}"},
                                    codec)
                    except OSError:
                        return
                    continue
                if req.get("op") == "hello":
                    if self.auth_token is not None:
                        # the MAC covers the client's codec OFFER as sent,
                        # so verify against that exact list
                        offer = [str(c) for c in (req.get("codecs") or ())]
                        mac = hello_mac(self.auth_token, offer)
                        got = req.get("auth")
                        if not (isinstance(got, str)
                                and _hmac.compare_digest(got, mac)):
                            self.stats["auth_failures"] += 1
                            try:
                                _send_frame(
                                    conn,
                                    {"ok": False,
                                     "error_type": "AuthError",
                                     "error": "AuthError: hello HMAC "
                                              "missing or invalid"},
                                    codec)
                            except OSError:
                                return
                            continue
                        authed = True
                    chosen = negotiate_codec(self.codecs,
                                             req.get("codecs") or ())
                    try:
                        _send_frame(conn, {"ok": True, "codec": chosen,
                                           "codecs": list(self.codecs)},
                                    codec)
                    except OSError:
                        return
                    codec = get_codec(chosen)  # switch AFTER the reply
                    counts = self.stats["codecs"]
                    counts[chosen] = counts.get(chosen, 0) + 1
                    counted = True
                    continue
                if not authed:
                    # ops before a valid authenticated hello are refused
                    # (typed, connection kept) — the client re-hellos with
                    # the right MAC or gives up with AuthError
                    self.stats["auth_failures"] += 1
                    try:
                        _send_frame(
                            conn,
                            {"ok": False, "error_type": "AuthError",
                             "error": "AuthError: server requires "
                                      "REPRO_AUTH_TOKEN hello auth"},
                            codec)
                    except OSError:
                        return
                    continue
                if not counted:
                    # a pre-negotiation client never sends hello: count its
                    # connection under the JSON floor so stats["codecs"]
                    # reflects the whole mixed fleet, not just upgraders
                    counts = self.stats["codecs"]
                    counts["json"] = counts.get("json", 0) + 1
                    counted = True
                try:
                    resp = {"ok": True, **(self._dispatch(req) or {})}
                except Exception as e:  # backend error -> structured reply
                    self.stats["errors"] += 1
                    resp = {"ok": False,
                            "error_type": type(e).__name__,
                            "error": f"{type(e).__name__}: {e}"}
                try:
                    _send_frame(conn, resp, codec)
                except BrokerError as e:  # reply unencodable / oversized
                    self.stats["errors"] += 1
                    try:
                        _send_frame(conn, {"ok": False,
                                           "error_type": "BrokerError",
                                           "error": f"BrokerError: {e}"},
                                    codec)
                    except OSError:
                        return
                except OSError:
                    return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, req: dict) -> Optional[dict]:
        self.stats["requests"] += 1
        op = req.get("op")
        b = self.backend
        if op == "ping":
            return {}
        if op == "put":
            b.put(Task(**req["task"]))
            return {}
        if op == "put_many":
            b.put_many([Task(**t) for t in req["tasks"]])
            return {}
        if op == "get_many":
            timeout = req.get("timeout", 0.0)
            if timeout is None or timeout > self.MAX_BLOCK_S:
                timeout = self.MAX_BLOCK_S
            queues = req.get("queues")
            leases = b.get_many(
                int(req["n"]), timeout=float(timeout),
                queues=tuple(queues) if queues is not None else None)
            return {"leases": [{"task": task_to_wire(l.task),
                                "tag": l.tag} for l in leases]}
        if op == "ack":
            b.ack(req["tag"])
            return {}
        if op == "ack_many":
            b.ack_many(list(req["tags"]))
            return {}
        if op == "nack":
            b.nack(req["tag"])
            return {}
        if op == "qsize":
            queues = req.get("queues")
            return {"n": b.qsize(tuple(queues) if queues is not None
                                 else None)}
        if op == "queue_names":
            return {"names": b.queue_names()}
        if op == "inflight":
            return {"n": b.inflight()}
        if op == "idle":
            return {"idle": bool(b.idle())}
        if op == "stats":
            return {"stats": dict(b.stats)}
        if op == "set_visibility_timeout":
            b.set_visibility_timeout(req["queue"], float(req["timeout"]))
            return {}
        if op == "set_max_queue_depth":
            depth = req.get("depth")
            b.set_max_queue_depth(req["queue"],
                                  None if depth is None else int(depth))
            return {}
        if op == "inflight_tasks":
            return {"tasks": [[task_to_wire(t), age]
                              for t, age in b.inflight_tasks()]}
        if op == "heartbeat":
            queues = req.get("queues")
            b.heartbeat(str(req["consumer_id"]),
                        tuple(queues) if queues is not None else None)
            return {}
        # live-migration protocol ops (drain-and-forward queue handoff;
        # see repro_torch.core.shardbroker.migrate_queue_between)
        if op == "migrate_queue":
            target = req.get("target")
            b.migrate_queue(str(req["queue"]),
                            None if target is None else str(target))
            return {}
        if op == "export_queue":
            return {"tasks": b.export_queue(str(req["queue"]),
                                            int(req.get("max_n", 256)))}
        if op == "import_tasks":
            b.import_tasks(req["tasks"])
            return {"n": len(req["tasks"])}
        raise BrokerError(f"unknown op {op!r}")


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class NetBroker:
    """TCP client implementing the full Broker protocol.

    Thread safety: each calling thread gets its own connection, so one
    worker thread's blocking ``get_many`` never serializes another's acks.
    All lease state lives server-side; any connection may ack any tag.

    ``get(timeout=...)`` blocks **server-side** (the handler parks on the
    backend's condition variable); the client chunks timeouts longer than
    ``block_chunk`` into successive requests so a dead server is detected
    within ``block_chunk + request_grace`` rather than the full timeout.

    ``codec="auto"`` (default) opens every connection with a JSON hello
    preferring the binary codec and transparently falls back to JSON
    when the server predates negotiation; ``"json"`` skips the hello
    entirely (byte-identical to the legacy client); ``"bin1"`` insists
    on offering only bin1 (still lands on JSON against an old server —
    JSON is the floor, never an error).
    """

    def __init__(self, address: str, connect_timeout: float = 5.0,
                 reconnect_timeout: float = 10.0,
                 request_grace: float = 10.0, block_chunk: float = 5.0,
                 breaker: Optional[CircuitBreaker] = None,
                 codec: str = "auto",
                 auth_token: Optional[str] = None):
        self.host, self.port = parse_address(address)
        self.auth_token = (auth_token if auth_token is not None
                           else os.environ.get("REPRO_AUTH_TOKEN"))
        if codec == "auto":
            self._codec_pref: Tuple[str, ...] = DEFAULT_PREFERENCE
        elif codec == "json":
            self._codec_pref = ()  # legacy wire: no hello at all
        else:
            get_codec(codec)  # fail fast on a typo'd codec name
            self._codec_pref = (codec,)
        self._negotiated = "json"  # last handshake outcome, for stats
        self.connect_timeout = connect_timeout
        self.reconnect_timeout = reconnect_timeout
        self.request_grace = request_grace
        self.block_chunk = block_chunk
        # per-endpoint circuit breaker: once a few calls have each burned a
        # full reconnect window, later calls fail fast (the endpoint is
        # DOWN) until a half-open probe heals it.  reset_timeout is short
        # so a restarted server is re-adopted within ~0.5 s, preserving the
        # pre-breaker restart-survival behavior.  Transient blips that
        # recover *within* a reconnect window never count as failures.
        self.breaker = breaker or CircuitBreaker(failure_threshold=3,
                                                 reset_timeout=0.5)
        self._backoff = BackoffPolicy(base=0.05, cap=1.0)
        self._tls = threading.local()
        # sock -> owning thread; pruned when that thread exits, else a
        # long-lived client shared by successive WorkerPools would pin one
        # fd (and one parked server handler thread) per dead worker thread
        self._socks: Dict[socket.socket, threading.Thread] = {}
        self._socks_lock = threading.Lock()
        self._reconnects = 0
        self._closed = False

    @property
    def address(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    # -- connection management ----------------------------------------------
    def _connected(self) -> socket.socket:
        sock = getattr(self._tls, "sock", None)
        if sock is not None:
            return sock
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._tls.codec = JSON_CODEC
        # an auth token forces a hello even on the legacy-JSON wire: the
        # handshake is the only place the shared-secret MAC can travel
        if self._codec_pref or self.auth_token is not None:
            # hello travels in JSON (the floor).  An old server answers
            # with its unknown-op error — that's a valid "json" outcome,
            # not a failure; only transport errors propagate (and the
            # _call retry loop treats them like any connect failure).
            try:
                hello = {"op": "hello", "codecs": list(self._codec_pref)}
                if self.auth_token is not None:
                    hello["auth"] = hello_mac(self.auth_token,
                                              hello["codecs"])
                _send_frame(sock, hello)
                resp = _recv_frame(sock)
                chosen = resp.get("codec", "json") if resp.get("ok") \
                    else "json"
            except CodecError:
                chosen = "json"  # unintelligible reply: stay on the floor
            except (OSError, ConnectionError, struct.error):
                try:
                    sock.close()
                except OSError:
                    pass
                raise
            if chosen not in self._codec_pref:
                chosen = "json"  # never adopt a codec we didn't offer
            self._tls.codec = get_codec(chosen)
            self._negotiated = chosen
        self._tls.sock = sock
        with self._socks_lock:
            dead = [s for s, t in self._socks.items() if not t.is_alive()]
            for s in dead:
                del self._socks[s]
            self._socks[sock] = threading.current_thread()
        for s in dead:
            try:
                s.close()
            except OSError:
                pass
        return sock

    def _drop_conn(self) -> None:
        sock = getattr(self._tls, "sock", None)
        if sock is None:
            return
        self._tls.sock = None
        self._tls.codec = JSON_CODEC  # renegotiated on the next connect
        with self._socks_lock:
            self._socks.pop(sock, None)
            self._reconnects += 1
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        self._closed = True
        with self._socks_lock:
            socks, self._socks = list(self._socks), {}
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self) -> "NetBroker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- RPC core ------------------------------------------------------------
    def _call(self, op: str, _timeout_hint: float = 0.0, **payload) -> dict:
        """One request/response with transparent reconnect.

        Retries transport failures (send/recv) until ``reconnect_timeout``
        elapses, then raises BrokerUnavailable.  Retrying is safe for every
        op: gets whose response was lost leave leases that expire
        server-side, acks are idempotent, puts are at-least-once."""
        if self._closed:
            raise BrokerError("NetBroker is closed")
        if not self.breaker.allow():
            # endpoint known-dead: fail fast instead of burning another
            # caller's full reconnect window (half-open probes re-test it)
            raise BrokerUnavailable(
                f"broker at {self.address}: circuit open (failing fast)")
        deadline = time.monotonic() + self.reconnect_timeout
        attempt = 0
        while True:
            try:
                sock = self._connected()
                sock.settimeout(_timeout_hint + self.request_grace)
                codec = getattr(self._tls, "codec", JSON_CODEC)
                _send_frame(sock, {"op": op, **payload}, codec)
                resp = _recv_frame(sock, codec)
                if not isinstance(resp, dict):
                    raise CodecError("response frame is not an object")
            # CodecError here means the response STREAM desynced (not a
            # quarantined request — those come back as structured replies):
            # reconnect and retry like any transport failure
            except (OSError, ConnectionError, struct.error,
                    CodecError) as e:
                self._drop_conn()
                now = time.monotonic()
                if now >= deadline or self._closed:
                    self.breaker.record_failure()
                    raise BrokerUnavailable(
                        f"broker at {self.address} unreachable: {e}") from e
                time.sleep(min(self._backoff.delay(attempt),
                               max(0.0, deadline - now)))
                attempt += 1
                continue
            # any response — success or a structured error like BrokerFull
            # — proves the endpoint is alive
            self.breaker.record_success()
            if not resp.get("ok"):
                exc = _ERROR_TYPES.get(resp.get("error_type"), BrokerError)
                raise exc(resp.get("error", "remote broker error"))
            return resp

    def ping(self) -> bool:
        try:
            self._call("ping")
            return True
        except BrokerUnavailable:
            return False

    def wait_ready(self, timeout: float = 30.0) -> bool:
        """Poll until the server answers (for just-spawned server procs)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.ping():
                return True
            time.sleep(0.05)
        return False

    # -- Broker protocol ------------------------------------------------------
    def put(self, task: Task) -> None:
        task.enqueued_at = time.time()
        self._call("put", task=task_to_wire(task))

    def put_many(self, tasks: List[Task]) -> None:
        now = time.time()
        for t in tasks:
            t.enqueued_at = now
        self._call("put_many", tasks=[task_to_wire(t) for t in tasks])

    def get(self, timeout: Optional[float] = 0.0,
            queues: Optional[Sequence[str]] = None) -> Optional[Lease]:
        leases = self.get_many(1, timeout=timeout, queues=queues)
        return leases[0] if leases else None

    def get_many(self, n: int, timeout: Optional[float] = 0.0,
                 queues: Optional[Sequence[str]] = None) -> List[Lease]:
        qsel = _normalize_queues(queues)
        qlist = None if qsel is None else list(qsel)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if deadline is None:
                chunk = self.block_chunk
            else:
                chunk = max(0.0, min(self.block_chunk,
                                     deadline - time.monotonic()))
            resp = self._call("get_many", _timeout_hint=chunk, n=n,
                              timeout=chunk, queues=qlist)
            leases = [Lease(Task(**d["task"]), d["tag"])
                      for d in resp["leases"]]
            if leases:
                return leases
            if deadline is not None and time.monotonic() >= deadline:
                return []

    def ack(self, tag: str) -> None:
        self._call("ack", tag=tag)

    def ack_many(self, tags: Iterable[str]) -> None:
        tags = list(tags)
        if tags:
            self._call("ack_many", tags=tags)

    def nack(self, tag: str) -> None:
        self._call("nack", tag=tag)

    def qsize(self, queues: Optional[Sequence[str]] = None) -> int:
        qsel = _normalize_queues(queues)
        return int(self._call(
            "qsize", queues=None if qsel is None else list(qsel))["n"])

    def queue_names(self) -> List[str]:
        return list(self._call("queue_names")["names"])

    def inflight(self) -> int:
        return int(self._call("inflight")["n"])

    def idle(self) -> bool:
        return bool(self._call("idle")["idle"])

    def set_visibility_timeout(self, queue: str, timeout: float) -> None:
        self._call("set_visibility_timeout", queue=queue,
                   timeout=float(timeout))

    def set_max_queue_depth(self, queue: str, depth: Optional[int]) -> None:
        """Override one queue's backpressure bound in the server backend
        (None clears it); subsequent puts from ANY client honor it."""
        self._call("set_max_queue_depth", queue=queue,
                   depth=None if depth is None else int(depth))

    def heartbeat(self, consumer_id: str,
                  queues: Optional[Sequence[str]] = None) -> None:
        """Register/refresh this consumer in the server backend's heartbeat
        registry; surfaces in ``stats["consumers"]`` for every client."""
        qsel = _normalize_queues(queues)
        self._call("heartbeat", consumer_id=consumer_id,
                   queues=None if qsel is None else list(qsel))

    def inflight_tasks(self) -> List[Tuple[Task, float]]:
        return [(Task(**d), float(age))
                for d, age in self._call("inflight_tasks")["tasks"]]

    # -- live-migration protocol ops (both codecs: plain dict payloads) ------
    def migrate_queue(self, queue: str, target: Optional[str]) -> None:
        """Mark/clear ``queue`` migrating on the server backend (while
        marked: consumers see it empty, puts forward to ``target``)."""
        self._call("migrate_queue", queue=queue,
                   target=None if target is None else str(target))

    def export_queue(self, queue: str, max_n: int = 256) -> List[Dict[str, Any]]:
        """Atomically pop up to ``max_n`` pending tasks as wire dicts."""
        return list(self._call("export_queue", queue=queue,
                               max_n=int(max_n))["tasks"])

    def import_tasks(self, tasks: List[Dict[str, Any]]) -> None:
        """Enqueue exported task dicts, exempt from the depth bound."""
        self._call("import_tasks",
                   tasks=[t if isinstance(t, dict) else task_to_wire(t)
                          for t in tasks])

    @property
    def stats(self) -> Dict[str, int]:
        s = dict(self._call("stats")["stats"])
        s["net_reconnects"] = self._reconnects
        s["circuit"] = self.breaker.state
        s["wire_codec"] = self._negotiated
        return s


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

def make_broker(url, **kwargs) -> Broker:
    """Build a broker from a URL (or a list of endpoint URLs).

    * ``mem://``               fresh in-process InMemoryBroker
    * ``file:///shared/dir``   FileBroker on a shared directory
    * ``tcp://host:port``      NetBroker client to a BrokerServer
    * ``shm://<registry>``     ShmBroker: same-host shared-memory channel
      to a BrokerServer started with ``shm_path=<registry>``
    * ``shard://h1:p1,h2:p2``  ShardedBroker federating N endpoints
      (comma-separated; entries without a scheme default to ``tcp://``;
      ``|``-separated replicas per shard — ``shard://h1:p1|h1r:p1r,...``
      — fail over under a fenced per-shard epoch when a primary dies)
    * ``shard+file://<path>``  ShardedBroker assembled from an endpoint
      discovery file published by ``broker-serve --announce <path>``
      (waits for the declared federation size; ``expect=`` overrides it,
      ``discover_timeout=`` bounds the wait)
    * ``ring+file://<path>``   ELASTIC ShardedBroker following the
      membership registry at ``<path>`` (``broker-serve --join <path>``):
      routing re-resolves on membership version bumps, so shards can
      join and leave while this client runs
    * ``["tcp://...", ...]``   a list/tuple of URLs == a ShardedBroker

    Extra kwargs go to the chosen constructor (e.g. ``visibility_timeout``
    for local backends, ``reconnect_timeout`` for NetBroker); for sharded
    brokers, ``queue_shards=`` and ``poll_slice=`` are consumed by
    ShardedBroker and the rest forwarded to every endpoint client.
    """
    if isinstance(url, (list, tuple)):
        from repro_torch.core.shardbroker import ShardedBroker
        return ShardedBroker(list(url), **kwargs)
    if url.startswith("shard+file://"):
        from repro_torch.core.shardbroker import discover_shards
        path = url[len("shard+file://"):]
        if not path:
            raise ValueError("shard+file:// broker URL needs the announce "
                             "file path")
        return discover_shards(path,
                               expect=kwargs.pop("expect", None),
                               timeout=kwargs.pop("discover_timeout", 10.0),
                               **kwargs)
    if url.startswith("ring+file://"):
        from repro_torch.core.shardbroker import ShardedBroker
        path = url[len("ring+file://"):]
        if not path:
            raise ValueError("ring+file:// broker URL needs the "
                             "membership file path")
        return ShardedBroker.from_membership(path, **kwargs)
    if url.startswith("shard://"):
        from repro_torch.core.shardbroker import ShardedBroker
        # each comma-separated shard entry may carry |-separated replica
        # endpoints: "shard://h1:p1|h1r:p1r,h2:p2" — the first endpoint is
        # the initial primary, the rest are failover candidates
        endpoints = []
        for entry in url[len("shard://"):].split(","):
            if not entry:
                continue
            cands = [e if "://" in e else f"tcp://{e}"
                     for e in entry.split("|") if e]
            if not cands:
                continue
            endpoints.append(cands[0] if len(cands) == 1 else cands)
        if not endpoints:
            raise ValueError("shard:// broker URL needs at least one "
                             "comma-separated endpoint")
        return ShardedBroker(endpoints, **kwargs)
    if url.startswith("tcp://"):
        return NetBroker(url, **kwargs)
    if url.startswith("shm://"):
        from repro_torch.core.shmring import ShmBroker
        path = url[len("shm://"):]
        if not path:
            raise ValueError("shm:// broker URL needs the registry file "
                             "path published by the server")
        return ShmBroker(path, **kwargs)
    if url.startswith("mem://"):
        return InMemoryBroker(**kwargs)
    if url.startswith("file://"):
        path = url[len("file://"):]
        if not path:
            raise ValueError("file:// broker URL needs a directory path")
        return FileBroker(path, **kwargs)
    raise ValueError(f"unsupported broker URL {url!r} (expected mem://, "
                     "file://<dir>, tcp://host:port, shm://<registry>, "
                     "or shard://h:p,h:p)")
