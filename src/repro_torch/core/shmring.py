"""Same-host shared-memory broker transport (``shm://``) and bundle ring.

The paper's producers and consumers often land on the SAME node — a
WorkerPool and a learner sharing one allocation — yet until now their
traffic still crossed either the filesystem (FileBroker / bundle files)
or the TCP loopback (NetBroker).  This module gives co-resident peers a
zero-syscall-per-byte path: fixed shared-memory segments
(:mod:`multiprocessing.shared_memory`) carrying the same bin1-encoded
frames the TCP wire speaks (core/wirecodec.py), coordinated by a JSON
registry file managed with the repo's one locked-JSON implementation
(core/jsonstore.py — slot directory + epoch live there, not in a new
ad-hoc path).

Pieces:

* :class:`ShmRing` — a single-producer/single-consumer byte ring in one
  segment.  Header = two little-endian u64 cursors (head: reader-owned,
  tail: writer-owned); records are ``u32 length + payload`` written
  contiguously (a ``0xFFFFFFFF`` wrap marker skips the tail fragment).
  The payload is fully written *before* the tail cursor is published,
  which is the whole visibility story on x86/CPython — no locks on the
  cross-process path.  A process-local mutex serializes producers in
  the same process; multiple producer *processes* on one ring are not
  supported.
* :class:`ShmListener` — server side.  ``BrokerServer(...,
  shm_path=REG)`` starts one: it bumps the registry epoch (disowning
  any channels a dead predecessor left behind, unlinking their
  segments best-effort), then watches the registry for client channels
  and serves each with its own thread — the exact per-connection
  threading model of the TCP wire, so a blocking ``get_many`` parks
  one channel, not the transport.
* :class:`ShmBroker` — client side (``make_broker("shm://REG")``).
  Each calling thread registers its own channel (a req ring + a resp
  ring it creates and owns), mirroring NetBroker's
  connection-per-thread rule and keeping every ring strictly SPSC.
  Requests are serial per channel, so responses match requests by
  position — no correlation ids.
* :class:`BundleRing` — the Bundler's pluggable write sink: fused
  ``sub_ranges`` bundles ride the ring to a same-host consumer as raw
  ndarray bytes.  ``push_bundle`` never blocks — a full ring drops the
  handoff because the bundle FILE remains the durable source of truth
  (and of ``load_since`` cursors); the ring is a latency optimization,
  not a durability layer.

Durability caveats versus ``file://``: segments are RAM, scoped to the
host, and vanish on reboot; a crashed client leaks its segments until
the next server start reclaims them via the epoch bump.  Anything that
must survive belongs in the FileBroker directory or bundle files.

Python 3.10 wart: attaching to an existing segment registers it with
the resource tracker, which would unlink it when the *attaching*
process exits (no ``track=False`` until 3.13) — :func:`_untrack`
undoes that immediately after every attach.
"""
from __future__ import annotations

import os
import select
import socket
import struct
import threading
import time
import uuid
from multiprocessing import shared_memory
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import jsonstore
from repro_torch.core.queue import (BrokerError, BrokerUnavailable, Lease, Task,
                              _normalize_queues, task_to_wire)
from repro_torch.core.netbroker import _ERROR_TYPES
from repro_torch.core.wirecodec import BIN_CODEC, CodecError

_HDR = 16                    # u64 head + u64 tail
_WRAP = 0xFFFFFFFF           # length marker: skip to start of ring
_REQ_CAPACITY = 1 << 20      # 1 MiB per client->server ring
_RESP_CAPACITY = 1 << 22     # 4 MiB: lease batches are the fat direction
# wait strategy: a few sched_yield passes (fast path when the peer is
# runnable on another core), then fixed short sleeps.  Tunable because
# the right point depends brutally on core count: on an oversubscribed
# single-CPU host every spinning waiter steals cycles from the peer it
# is waiting FOR, so fewer spins and a coarser sleep win; on a roomy
# multi-core node more spinning cuts latency.  (These read the environment
# once at import.)
_SPINS = int(os.environ.get("REPRO_SHM_SPINS", "50"))
_POLL_S = float(os.environ.get("REPRO_SHM_POLL_US", "200")) * 1e-6
# default consumer-prefetch pipeline depth (see ShmBroker docstring)
_PREFETCH = int(os.environ.get("REPRO_SHM_PREFETCH", "2"))


# segment names THIS process created: their tracker registration is the
# legitimate one (balanced by unlink's unregister), so an attach in the
# same process must not strip it — the tracker cache is a set, and a
# second register from the attach dedups into the creator's entry
_created_here: set = set()


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """Keep the resource tracker from unlinking a segment we merely
    attached to (3.10 registers attaches too; see module docstring)."""
    if shm._name in _created_here:
        return
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _unlink_segment(name: str) -> None:
    try:
        shm = shared_memory.SharedMemory(name=name)
    except (FileNotFoundError, OSError):
        return
    try:
        shm.unlink()
    except (FileNotFoundError, OSError):
        pass
    finally:
        try:
            shm.close()
        except (OSError, BufferError):
            pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError, TypeError, ValueError):
        pass  # exists but not ours / unknowable: assume alive
    return True


class ShmRing:
    """SPSC byte ring over one shared-memory segment.

    ``create=True`` allocates a fresh segment (``capacity`` data bytes);
    ``name=`` attaches to an existing one.  ``try_push``/``try_pop`` are
    non-blocking; ``push``/``pop`` poll with a short spin-then-sleep
    escalation.  Records must fit the ring (``len + 4 <= capacity``) or
    ``push`` raises ValueError so callers can fall back to a durable
    path instead of deadlocking on an impossible write.
    """

    def __init__(self, name: Optional[str] = None, capacity: int = _REQ_CAPACITY,
                 create: bool = False):
        if create:
            self._shm = shared_memory.SharedMemory(create=True,
                                                   size=_HDR + int(capacity))
            self._shm.buf[:_HDR] = b"\x00" * _HDR
            _created_here.add(self._shm._name)
        else:
            if not name:
                raise ValueError("attaching to a ring needs its segment name")
            self._shm = shared_memory.SharedMemory(name=name)
            _untrack(self._shm)
        self._buf = self._shm.buf
        self._cap = self._shm.size - _HDR
        self._push_lock = threading.Lock()  # intra-process producer guard
        self._closed = False
        # True when the last try_push found the consumer fully caught up
        # (it may be about to block): the producer must ring its wakeup
        # doorbell.  False means unconsumed records predate ours, and the
        # byte that announced the empty->non-empty transition is still
        # un-consumed — a wakeup is already guaranteed, skip the syscall.
        self.consumer_was_caught_up = True

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def capacity(self) -> int:
        return self._cap

    def _cursor(self, off: int) -> int:
        return struct.unpack_from("<Q", self._buf, off)[0]

    def _publish(self, off: int, v: int) -> None:
        struct.pack_into("<Q", self._buf, off, v)

    def try_push(self, data: bytes) -> bool:
        n = len(data)
        if n + 4 > self._cap:
            raise ValueError(f"record of {n} bytes exceeds ring capacity "
                             f"{self._cap}")
        with self._push_lock:
            if self._closed:
                raise BrokerError("ring is closed")
            head = self._cursor(0)
            tail = self._cursor(8)
            pos = tail % self._cap
            contig = self._cap - pos
            pad = contig if contig < n + 4 else 0
            if self._cap - (tail - head) < pad + n + 4:
                return False
            if pad:
                if contig >= 4:
                    struct.pack_into("<I", self._buf, _HDR + pos, _WRAP)
                tail += pad
                pos = 0
            base = _HDR + pos
            self._buf[base + 4:base + 4 + n] = data   # payload first,
            struct.pack_into("<I", self._buf, base, n)
            start = tail - pad  # tail as the consumer last saw it
            self._publish(8, tail + 4 + n)            # cursor last
            # Re-read head *after* publishing: if the consumer has drained
            # everything that preceded this record it may be blocking (or
            # about to), so the producer must ring the doorbell.  Otherwise
            # older records — whose empty->non-empty transition already sent
            # a byte that is still unconsumed — guarantee a wakeup.
            self.consumer_was_caught_up = self._cursor(0) >= start
            return True

    def try_peek(self) -> bool:
        """True if a record is (probably) available: a cheap cursor
        compare with no side effects, for spin-wait loops."""
        if self._closed:
            raise BrokerError("ring is closed")
        return self._cursor(0) != self._cursor(8)

    def try_pop(self) -> Optional[bytes]:
        if self._closed:
            raise BrokerError("ring is closed")
        head = self._cursor(0)
        tail = self._cursor(8)
        while head != tail:
            pos = head % self._cap
            contig = self._cap - pos
            if contig >= 4:
                (n,) = struct.unpack_from("<I", self._buf, _HDR + pos)
                if n != _WRAP:
                    data = bytes(self._buf[_HDR + pos + 4:
                                           _HDR + pos + 4 + n])
                    self._publish(0, head + 4 + n)
                    return data
            head += contig  # tail fragment (padded or too small): skip
            self._publish(0, head)
        return None

    def _poll(self, step: Callable[[], Optional[Any]],
              timeout: float) -> Optional[Any]:
        deadline = time.monotonic() + timeout
        spins = 0
        while True:
            out = step()
            if out is not None:
                return out
            if time.monotonic() >= deadline:
                return None
            if spins < _SPINS:
                os.sched_yield()
            else:
                time.sleep(_POLL_S)
            spins += 1

    def push(self, data: bytes, timeout: float = 0.0) -> bool:
        if self.try_push(data):  # uncontended fast path: no _poll setup
            return True
        return bool(self._poll(
            lambda: True if self.try_push(data) else None, timeout))

    def pop(self, timeout: float = 0.0) -> Optional[bytes]:
        out = self.try_pop()
        if out is not None:
            return out
        return self._poll(self.try_pop, timeout)

    def close(self) -> None:
        with self._push_lock:
            if self._closed:
                return
            self._closed = True
        self._buf = None
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        _created_here.discard(self._shm._name)
        try:
            self._shm.unlink()
        except (FileNotFoundError, OSError):
            pass


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

class _ServedChannel:
    """Server-side per-channel state: rings, doorbell, worker thread."""

    __slots__ = ("cid", "req", "resp", "thread", "dead", "retired",
                 "doorbell")

    def __init__(self, cid: str, req: ShmRing, resp: ShmRing):
        self.cid = cid
        self.req = req
        self.resp = resp
        self.thread: Optional[threading.Thread] = None
        self.dead = False
        self.retired = False
        self.doorbell: Optional[socket.socket] = None


class ShmListener:
    """Serve a broker backend over shared-memory channels.

    ``dispatch`` is the server's request handler
    (:meth:`BrokerServer._dispatch`): channels carry the same op dicts
    as the TCP wire, always bin1-encoded (both ends are this codebase —
    there is no legacy shm peer to stay compatible with, so no
    negotiation).  Starting the listener bumps the registry epoch:
    channels registered under an older epoch belong to a dead server's
    clients and their segments are reclaimed.

    Threading: each channel gets a worker thread that blocks in
    ``recv`` on a per-channel unix-domain *doorbell* socket (payloads
    never touch it — each side writes a single wakeup byte after
    pushing to a ring, so the data plane stays in shared memory while
    waiting happens in the kernel, exactly like a blocked TCP
    ``recv``).  On wakeup the worker drains its request ring with
    ``try_pop`` and answers each frame.  A single poller thread only
    accepts doorbell connections, reads the ``<cid>\\n`` hello line,
    and rescans the registry for new channels.  Two earlier designs
    lost to loopback TCP on an oversubscribed host and are worth
    recording: thread-per-channel *spin-polling* its own ring
    serialized N pollers' Python bytecode on the GIL against the one
    handler doing real work (~2x drop at 4 channels), and a central
    poller feeding worker inboxes added a thread hop (select wakeup ->
    queue put -> worker wakeup) to every request, which on one CPU is
    an extra GIL handoff per op.  The doorbell keeps the rings as the
    source of truth — bytes are level-style wakeup hints, spurious or
    coalesced ones are harmless, and a channel whose hello has not
    arrived yet degrades to timeout polling.  Blocking backend ops (a
    ``get_many`` long-poll) only park that channel's worker.
    """

    def __init__(self, path: str, dispatch: Callable[[dict], Optional[dict]],
                 max_block_s: float = 10.0,
                 req_capacity: int = _REQ_CAPACITY,
                 resp_capacity: int = _RESP_CAPACITY,
                 scan_interval: float = 0.05):
        self.path = path
        self.dispatch = dispatch
        self.max_block_s = max_block_s
        self.req_capacity = int(req_capacity)
        self.resp_capacity = int(resp_capacity)
        self.scan_interval = scan_interval
        self.epoch: Optional[int] = None
        self.stats = {"channels": 0, "requests": 0, "errors": 0,
                      "codec_errors": 0}
        self._stopping = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self._served: Dict[str, "_ServedChannel"] = {}

    def start(self) -> "ShmListener":
        stale: List[str] = []
        sock_path = self.path + ".sock"

        def init(doc: dict) -> None:
            for ch in (doc.get("channels") or {}).values():
                stale.extend(n for n in (ch.get("req"), ch.get("resp")) if n)
            doc["epoch"] = int(doc.get("epoch", 0)) + 1
            doc["channels"] = {}
            doc["server"] = {"pid": os.getpid()}
            doc["capacity"] = {"req": self.req_capacity,
                               "resp": self.resp_capacity}
            doc["doorbell"] = sock_path

        doc = jsonstore.update_json(self.path, init, strict=True)
        self.epoch = int(doc["epoch"])
        for name in stale:
            _unlink_segment(name)
        try:
            os.unlink(sock_path)  # a dead predecessor's socket file
        except OSError:
            pass
        self._listener_sock = socket.socket(socket.AF_UNIX,
                                            socket.SOCK_STREAM)
        self._listener_sock.bind(sock_path)
        self._listener_sock.listen(64)
        self._listener_sock.setblocking(False)
        self._sock_path = sock_path
        self._hello: Dict[str, socket.socket] = {}
        self._greeting: Dict[socket.socket, bytes] = {}  # cid not read yet
        self._cfg = jsonstore.SharedJsonConfig(self.path)
        self._poll_thread = threading.Thread(
            target=self._poll_loop, daemon=True,
            name=f"shmbroker-poll-{os.path.basename(self.path)}")
        self._poll_thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=2.0)
        for ch in list(self._served.values()):
            self._retire(ch)
            ch.thread.join(timeout=2.0)
        for s in ([self._listener_sock] + list(self._greeting)
                  + list(self._hello.values())):
            try:
                s.close()
            except OSError:
                pass
        try:
            os.unlink(self._sock_path)
        except OSError:
            pass

    def _rescan(self) -> None:
        doc = self._cfg.load_if_changed()
        if doc is None:
            return
        channels = doc.get("channels") or {}
        # deregistered channels: wake the worker so it closes its rings
        for cid in set(self._served) - set(channels):
            self._retire(self._served[cid])
        for cid, ch in channels.items():
            if cid in self._served or ch.get("epoch") != self.epoch:
                continue
            try:
                req = ShmRing(name=ch["req"])
                resp = ShmRing(name=ch["resp"])
            except (KeyError, FileNotFoundError, OSError):
                continue  # client vanished between register/attach
            served = _ServedChannel(cid, req, resp)
            served.doorbell = self._hello.pop(cid, None)
            served.thread = threading.Thread(
                target=self._serve_channel, args=(served,), daemon=True,
                name=f"shmbroker-chan-{cid}")
            self._served[cid] = served
            self.stats["channels"] += 1
            served.thread.start()

    def _retire(self, served: "_ServedChannel") -> None:
        """Ask a worker to exit: flag it and shut its doorbell down so a
        blocked ``recv`` returns EOF immediately."""
        self._served.pop(served.cid, None)
        served.retired = True
        db = served.doorbell
        if db is not None:
            try:
                db.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _on_readable(self, s: socket.socket) -> None:
        if s is self._listener_sock:
            while True:
                try:
                    conn, _ = self._listener_sock.accept()
                except (BlockingIOError, OSError):
                    return
                conn.setblocking(False)
                self._greeting[conn] = b""
            return
        if s in self._greeting:  # awaiting the "<cid>\n" hello line
            try:
                data = s.recv(256)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                data = b""
            if not data:
                del self._greeting[s]
                s.close()
                return
            buf = self._greeting[s] + data
            if b"\n" not in buf:
                self._greeting[s] = buf
                return
            del self._greeting[s]
            cid = buf.split(b"\n", 1)[0].decode("ascii", "replace")
            served = self._served.get(cid)
            if served is not None:
                served.doorbell = s  # worker picks it up next iteration
            else:
                self._hello[cid] = s
                self._rescan()  # the client registered before connecting

    def _poll_loop(self) -> None:
        """Accept doorbell connections and track registry changes.

        The data path never goes through here — workers block on their
        own doorbell sockets — so this loop wakes only for new
        connections and the periodic registry rescan."""
        last_scan = 0.0
        while not self._stopping.is_set():
            socks = [self._listener_sock] + list(self._greeting)
            try:
                readable, _, _ = select.select(socks, [], [],
                                               self.scan_interval)
            except (OSError, ValueError):  # a socket died mid-select
                readable = []
            for s in readable:
                self._on_readable(s)
            now = time.monotonic()
            if now - last_scan >= self.scan_interval:
                self._rescan()
                # reap workers that exited on their own (client EOF)
                for cid, ch in list(self._served.items()):
                    if ch.dead:
                        del self._served[cid]
                last_scan = now

    def _handle_frame(self, served: "_ServedChannel", raw: bytes) -> bool:
        """Answer one request frame; False means abandon the channel.

        Frames flagged ``_noreply`` (the client's pipelined acks) get NO
        reply on success — the ring is reliable, in-order shared memory
        and the ops are idempotent, so a success reply would only cost
        both sides encode/push/wakeup/decode work.  Their *failures*
        still travel back, marked ``oob`` (out-of-band) so the client
        can tell them apart from the strict FIFO replies of synchronous
        ops.  A frame that does not even decode also answers ``oob``
        (its FIFO position is unknowable), which keeps the quarantine
        contract: a corrupt record yields a typed error, not a dead
        channel."""
        self.stats["requests"] += 1
        noreply = False
        resp: Optional[dict]
        try:
            request = BIN_CODEC.decode(raw)
            if not isinstance(request, dict):
                raise CodecError("frame is not a request object")
        except CodecError as e:
            self.stats["codec_errors"] += 1
            resp = {"ok": False, "oob": "frame", "error_type": "CodecError",
                    "error": f"CodecError: {e}"}
        else:
            noreply = bool(request.pop("_noreply", False))
            try:
                resp = {"ok": True, **(self.dispatch(request) or {})}
            except Exception as e:
                self.stats["errors"] += 1
                resp = {"ok": False,
                        "error_type": type(e).__name__,
                        "error": f"{type(e).__name__}: {e}"}
                if noreply:
                    resp["oob"] = str(request.get("op") or "op")
            if noreply and resp.get("ok"):
                return True  # reply elided
        try:
            payload = BIN_CODEC.encode(resp)
        except (TypeError, ValueError) as e:
            payload = BIN_CODEC.encode(
                {"ok": False, "error_type": "BrokerError",
                 "error": f"BrokerError: unencodable reply: {e}"})
        try:
            pushed = served.resp.push(payload, timeout=self.max_block_s)
        except ValueError:
            # reply bigger than the response ring (a huge lease batch):
            # a typed error beats a dead channel — the leases time out
            # and requeue on the backend as usual
            pushed = served.resp.push(BIN_CODEC.encode(
                {"ok": False, "error_type": "BrokerError",
                 "error": f"BrokerError: reply of {len(payload)} bytes "
                          "exceeds the shm response ring; request a "
                          "smaller batch"}), timeout=self.max_block_s)
        if not pushed:
            return False  # consumer gone or wedged: abandon the channel
        db = served.doorbell
        if db is not None and served.resp.consumer_was_caught_up:
            # Same elision as the client side: unconsumed earlier replies
            # imply an unconsumed wakeup byte, and the client drains the
            # ring to empty before blocking on the doorbell.
            try:
                db.send(b"\x01")
            except (BlockingIOError, socket.timeout):
                pass  # unread wakeups queued: client will wake anyway
            except OSError:
                return False  # client gone
        return True

    def _serve_channel(self, served: "_ServedChannel") -> None:
        try:
            while not self._stopping.is_set() and not served.retired:
                drained = False
                while True:
                    try:
                        raw = served.req.try_pop()
                    except BrokerError:
                        return  # ring closed under us
                    if raw is None:
                        break
                    drained = True
                    if not self._handle_frame(served, raw):
                        return
                if drained:
                    continue  # more may have landed while we worked
                db = served.doorbell
                if db is None:
                    # hello not in yet: fall back to polling the ring
                    try:
                        raw = served.req.pop(timeout=self.scan_interval)
                    except BrokerError:
                        return
                    if raw is not None and not self._handle_frame(served,
                                                                  raw):
                        return
                    continue
                try:
                    db.settimeout(0.2)  # bounded so retire/stop is seen
                    data = db.recv(4096)
                    if not data:
                        return  # client closed its doorbell: channel dead
                except socket.timeout:
                    continue
                except OSError:
                    return
        except BrokerError:
            pass  # ring closed under us
        finally:
            served.dead = True  # poller reaps the entry on its next scan
            served.req.close()
            served.resp.close()


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

class _Channel:
    def __init__(self, cid: str, req: ShmRing, resp: ShmRing, epoch: int):
        self.cid = cid
        self.req = req
        self.resp = resp
        self.epoch = epoch
        # sync ops whose replies we abandoned after an out-of-band error
        # raise; the next call discards them to stay in FIFO step
        self.pending: List[str] = []
        self.doorbell: Optional[socket.socket] = None
        self.db_timeout: Optional[float] = None  # cached settimeout value
        # consumer prefetch state: ``prefetch_n`` speculative get_many
        # requests are in flight, all for the selector ``prefetch_key``;
        # ``stash`` is (key, wire-lease dicts) already received but not
        # yet claimed by a caller
        self.prefetch_n: int = 0
        self.prefetch_key: Optional[Tuple] = None
        self.prefetch_frame: Optional[Tuple[Tuple, bytes]] = None
        self.stash: Optional[Tuple[Tuple, List[dict]]] = None


class ShmBroker:
    """Same-host Broker client over shared-memory channels.

    Mirrors NetBroker's contract: full Broker protocol, per-thread
    channels (one blocking ``get_many`` never serializes another
    thread's acks), server-held lease state, chunked blocking gets, and
    typed error relay.  A channel that stops answering (server restart)
    is torn down and re-registered once before ``BrokerUnavailable``.

    One deliberate divergence (``pipeline_acks=True``, the default):
    ``ack``/``ack_many``/``nack`` are fire-and-forget — the request is
    pushed with a ``_noreply`` flag and the call returns immediately.
    The server elides the reply entirely when the op succeeds (the ring
    is reliable, in-order shared memory and acks are idempotent, so a
    success reply would be pure overhead: encode + push + wakeup on one
    side, pop + decode on the other).  The claim+ack drain loop then
    pays one round trip per batch instead of two, which on an
    oversubscribed host is the difference between the shm path beating
    loopback TCP and losing to it.  Consequence: a *rejected* ack (e.g.
    :class:`StaleEpochError` after a shard failover) comes back as an
    out-of-band error frame and raises its typed error from the NEXT
    synchronous call on the same thread, one op late.  Delivery is
    at-least-once, so correctness is unaffected — an ack lost to a torn
    channel just means redelivery.  Pass ``pipeline_acks=False`` for
    strict call-site errors.

    The second divergence (``prefetch``, default 2) is AMQP-style
    consumer prefetch with a pipeline depth: while a drain loop is hot
    (non-empty batches coming back), the client keeps up to ``prefetch``
    speculative ``get_many`` requests in flight for the same queue
    selector (each with a zero timeout hint, so the server never parks
    on one and frames queued behind it — acks — are not delayed).  The
    point on an oversubscribed host is not overlap but *wakeup
    batching*: when the client finally blocks, the server wakes once
    and answers every queued request, and the client then claims a
    window of batches with local ring pops — the context-switch pair
    is amortized over ``prefetch`` batches instead of paid per batch,
    which request-reply TCP cannot do.  Prefetched leases the caller
    never claims (selector change, clean close) are nacked back — or,
    after a crash, redelivered by the visibility timeout like any dead
    consumer's leases.  Per-lease delivery stays at-least-once; a lease
    simply spends a little of its visibility window in the client-side
    stash, so keep ``prefetch * batch * per-task-seconds`` well under
    the queue's visibility timeout (the same sizing rule as AMQP
    ``basic.qos``).  ``prefetch=0`` disables speculation entirely.
    """

    def __init__(self, path: str, connect_timeout: float = 5.0,
                 request_grace: float = 10.0, block_chunk: float = 5.0,
                 pipeline_acks: bool = True, prefetch: int = _PREFETCH):
        self.path = path
        self.connect_timeout = connect_timeout
        self.request_grace = request_grace
        self.block_chunk = block_chunk
        self.pipeline_acks = pipeline_acks
        self.prefetch = int(prefetch)  # bool compat: True -> depth 1
        self._tls = threading.local()
        self._channels: Dict[str, _Channel] = {}
        self._lock = threading.Lock()
        self._closed = False

    @property
    def address(self) -> str:
        return f"shm://{self.path}"

    # -- channel management ---------------------------------------------------
    def _channel(self) -> _Channel:
        ch = getattr(self._tls, "ch", None)
        if ch is not None:
            return ch
        deadline = time.monotonic() + self.connect_timeout
        while True:
            doc = jsonstore.load_json(self.path, default=None)
            if (isinstance(doc, dict) and "epoch" in doc
                    and _pid_alive((doc.get("server") or {}).get("pid", -1))):
                break
            if time.monotonic() >= deadline:
                raise BrokerUnavailable(
                    f"no live shm broker server behind {self.path}")
            time.sleep(0.02)
        cap = doc.get("capacity") or {}
        req = ShmRing(create=True,
                      capacity=int(cap.get("req", _REQ_CAPACITY)))
        resp = ShmRing(create=True,
                       capacity=int(cap.get("resp", _RESP_CAPACITY)))
        cid = uuid.uuid4().hex[:12]
        epoch = int(doc["epoch"])

        def register(d: dict) -> None:
            d.setdefault("channels", {})[cid] = {
                "req": req.name, "resp": resp.name,
                "epoch": epoch, "pid": os.getpid()}

        jsonstore.update_json(self.path, register, strict=True)
        ch = _Channel(cid, req, resp, epoch)
        sock_path = doc.get("doorbell")
        if sock_path:
            try:
                db = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                db.settimeout(self.connect_timeout)
                db.connect(sock_path)
                db.sendall(cid.encode("ascii") + b"\n")
                ch.doorbell = db
            except OSError:
                ch.doorbell = None  # degrade to timeout polling
        self._tls.ch = ch
        with self._lock:
            self._channels[cid] = ch
        return ch

    def _drop_channel(self) -> None:
        ch = getattr(self._tls, "ch", None)
        if ch is None:
            return
        self._tls.ch = None
        with self._lock:
            self._channels.pop(ch.cid, None)

        def deregister(d: dict) -> None:
            (d.get("channels") or {}).pop(ch.cid, None)

        try:
            jsonstore.update_json(self.path, deregister)
        except OSError:
            pass
        if ch.doorbell is not None:
            try:
                ch.doorbell.close()
            except OSError:
                pass
        for ring in (ch.req, ch.resp):
            ring.close()
            ring.unlink()  # we created these segments; reclaim the RAM

    def close(self) -> None:
        self._closed = True
        with self._lock:
            channels, self._channels = list(self._channels.values()), {}
        if channels:
            cids = {c.cid for c in channels}

            def deregister(d: dict) -> None:
                chs = d.get("channels") or {}
                for cid in cids:
                    chs.pop(cid, None)

            try:
                jsonstore.update_json(self.path, deregister)
            except OSError:
                pass
        for ch in channels:
            if ch.prefetch_n:
                # settle in-flight speculative get_manys into the stash
                # (bounded: the server answers timeout-0 gets promptly) so
                # their leases are handed back below rather than waiting
                # out the visibility timeout
                try:
                    self._settle_all(ch)
                except (BrokerError, ValueError, OSError):
                    pass
            if ch.stash is not None:
                # best-effort: hand unclaimed speculative leases back now
                # instead of waiting out their visibility timeout
                _key, wires = ch.stash
                ch.stash = None
                for d in wires:
                    try:
                        self._push_req(ch, BIN_CODEC.encode(
                            {"op": "nack", "tag": d["tag"],
                             "_noreply": True}))
                    except (BrokerError, ValueError, OSError):
                        break
            if ch.doorbell is not None:
                try:
                    ch.doorbell.close()
                except OSError:
                    pass
            for ring in (ch.req, ch.resp):
                ring.close()
                ring.unlink()

    def __enter__(self) -> "ShmBroker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- RPC core ------------------------------------------------------------
    def _push_req(self, ch: _Channel, frame: bytes) -> bool:
        """Push a request and ring the doorbell; False = channel dead."""
        if not ch.req.push(frame, timeout=1.0):
            return False  # server not draining: assume dead
        if ch.doorbell is not None and ch.req.consumer_was_caught_up:
            # Ring only when the server had drained everything ahead of this
            # frame (it may be parked in recv); otherwise the byte for the
            # earlier frames is still pending and will wake it — the server
            # drains the ring to empty per wakeup, so frames pushed while it
            # is awake are picked up in the same sweep.
            try:
                if ch.db_timeout != 1.0:  # settimeout is a syscall; cache
                    ch.doorbell.settimeout(1.0)
                    ch.db_timeout = 1.0
                ch.doorbell.sendall(b"\x01")
            except OSError:
                return False  # server gone (fast failure detection)
        return True

    def _pop_resp(self, ch: _Channel, timeout: float) -> Optional[bytes]:
        """Wait for a response record, blocking on the doorbell socket
        (zero CPU) rather than polling; the ring stays the source of
        truth — doorbell bytes are only wakeup hints.  (A yield-spin
        fast path was tried here and made latency 15x WORSE on a
        one-CPU host: two spinning peers hand the CPU back and forth in
        scheduler-quantum steps instead of parking one of them.)"""
        if ch.doorbell is None:
            return ch.resp.pop(timeout=timeout)
        deadline = time.monotonic() + timeout
        while True:
            raw = ch.resp.try_pop()
            if raw is not None:
                return raw
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                t = remaining if remaining < 0.2 else 0.2
                if ch.db_timeout != t:
                    ch.doorbell.settimeout(t)
                    ch.db_timeout = t
                data = ch.doorbell.recv(4096)
                if not data:
                    return None  # server closed the doorbell
            except socket.timeout:
                continue  # re-check the ring, keep waiting
            except OSError:
                return None

    def _next_reply(self, ch: _Channel, timeout: float) -> Optional[dict]:
        """Pop + decode the next reply; None means timeout or garbage
        (both leave the channel unusable: the caller drops it)."""
        raw = self._pop_resp(ch, timeout)
        if raw is None:
            return None
        try:
            resp = BIN_CODEC.decode(raw)
            if not isinstance(resp, dict):
                raise CodecError("response frame is not an object")
        except CodecError:
            return None
        return resp

    @staticmethod
    def _raise_oob(resp: dict) -> None:
        exc = _ERROR_TYPES.get(resp.get("error_type"), BrokerError)
        raise exc(f"deferred {resp.get('oob')} reply: "
                  + resp.get("error", "remote broker error"))

    def _read_reply(self, ch: _Channel, op: str,
                    timeout: float) -> Optional[dict]:
        """Read the next reply owed to ``op``, first discarding replies
        owed to sync ops abandoned after an earlier out-of-band raise —
        they precede ours in FIFO order, and their callers already saw
        an error.  None = timeout or garbage: the channel is desynced
        and the caller must drop it."""
        while ch.pending:
            dresp = self._next_reply(ch, self.request_grace)
            if dresp is None:
                return None
            if dresp.get("oob"):
                ch.pending.append(op)  # op's reply is now owed too
                self._raise_oob(dresp)
            ch.pending.pop(0)
        resp = self._next_reply(ch, timeout)
        if resp is None:
            return None
        if resp.get("oob"):
            ch.pending.append(op)  # op's own reply is still in flight
            self._raise_oob(resp)
        return resp

    def _settle_prefetch(self, ch: _Channel) -> bool:
        """Read ONE in-flight speculative get_many's reply into the
        stash, then opportunistically settle any further replies
        already sitting in the ring (no extra waits).  True = channel
        in FIFO sync (or nothing to settle); False = desynced, caller
        drops the channel (the speculative leases then redeliver via
        their visibility timeout).  An out-of-band error raise
        propagates to the sync caller per the pipelined-ack contract;
        _read_reply has already recorded that the speculative reply is
        still owed."""
        while ch.prefetch_n:
            ch.prefetch_n -= 1
            resp = self._read_reply(ch, "get_many", self.request_grace)
            if resp is None:
                return False
            if resp.get("ok") and resp.get("leases"):
                if ch.stash is not None:
                    ch.stash[1].extend(resp["leases"])
                else:
                    ch.stash = (ch.prefetch_key, list(resp["leases"]))
            # a failed speculative get leased nothing: nothing to keep.
            # only block for the FIRST settle; drain the rest for free
            if not (ch.prefetch_n and not ch.pending
                    and ch.resp.try_peek()):
                break
        return True

    def _settle_all(self, ch: _Channel) -> bool:
        while ch.prefetch_n:
            if not self._settle_prefetch(ch):
                return False
        return True

    def _claim_stash(self, ch: _Channel, qkey: Tuple,
                     n: int) -> List[Lease]:
        """Hand out stashed speculative leases matching the caller's
        queue selector; on a selector mismatch (the consumer
        re-subscribed) nack them back to the server instead."""
        if ch.stash is None:
            return []
        skey, wires = ch.stash
        if skey != qkey:
            ch.stash = None
            for d in wires:
                self._call("nack", tag=d["tag"], _defer=True)
            return []
        take, rest = wires[:n], wires[n:]
        ch.stash = (skey, rest) if rest else None
        return [Lease(Task(**d["task"]), d["tag"]) for d in take]

    def _maybe_prefetch(self, n: int, qlist: Optional[List[str]],
                        qkey: Tuple) -> None:
        """Top the speculative-get_many pipeline up to ``prefetch``
        deep for the selector we just drained from.  Zero server-side
        timeout on each: the server must never park on one, or acks
        queued behind it in the ring would stall.  Best-effort — a
        push failure just means the channel is dying and the next sync
        op will rebuild it."""
        if self.prefetch <= 0:
            return
        ch = getattr(self._tls, "ch", None)
        if ch is None or (ch.prefetch_n and ch.prefetch_key != qkey):
            return
        if ch.prefetch_frame is None or ch.prefetch_frame[0] != (n, qkey):
            ch.prefetch_frame = ((n, qkey), BIN_CODEC.encode(
                {"op": "get_many", "n": n, "timeout": 0.0, "queues": qlist}))
        frame = ch.prefetch_frame[1]
        while ch.prefetch_n < self.prefetch:
            if not self._push_req(ch, frame):
                return
            ch.prefetch_n += 1
            ch.prefetch_key = qkey

    def _call(self, op: str, _timeout_hint: float = 0.0,
              _defer: bool = False, **payload) -> dict:
        if self._closed:
            raise BrokerError("ShmBroker is closed")
        msg = {"op": op, **payload}
        if _defer:
            msg["_noreply"] = True
        frame = BIN_CODEC.encode(msg)
        for _attempt in range(2):  # second pass = one fresh channel
            ch = self._channel()
            # a sync op reads a reply, so outstanding speculative
            # get_manys must be settled first to stay in FIFO step;
            # deferred ops read nothing and skip straight to the push
            if not _defer and not self._settle_all(ch):
                self._drop_channel()
                continue
            if not self._push_req(ch, frame):
                self._drop_channel()
                continue
            if _defer:
                # fire-and-forget: the server elides the reply on
                # success; a failure comes back marked ``oob`` and is
                # raised by the next synchronous call on this thread
                return {}
            resp = self._read_reply(ch, op, _timeout_hint
                                    + self.request_grace)
            if resp is None:
                self._drop_channel()  # timed out or desynced: rebuild
                continue
            if not resp.get("ok"):
                exc = _ERROR_TYPES.get(resp.get("error_type"), BrokerError)
                raise exc(resp.get("error", "remote broker error"))
            return resp
        raise BrokerUnavailable(f"shm broker behind {self.path} "
                                "not responding")

    def ping(self) -> bool:
        try:
            self._call("ping")
            return True
        except BrokerUnavailable:
            return False

    def wait_ready(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.ping():
                return True
            time.sleep(0.05)
        return False

    # -- Broker protocol ------------------------------------------------------
    def put(self, task: Task) -> None:
        # via _put_many_wire for its oversized-frame translation: a task
        # that cannot fit the ring raises BrokerError, not a raw ValueError
        task.enqueued_at = time.time()
        self._put_many_wire([task_to_wire(task)])

    def put_many(self, tasks: List[Task]) -> None:
        now = time.time()
        for t in tasks:
            t.enqueued_at = now
        self._put_many_wire([task_to_wire(t) for t in tasks])

    def _put_many_wire(self, wires: List[Dict[str, Any]]) -> None:
        """put_many with bisection on ring overflow: a batch whose frame
        exceeds the request ring splits in half until chunks fit (TCP
        has no such limit, so NetBroker callers never see this)."""
        if not wires:
            return
        try:
            self._call("put_many", tasks=wires)
        except CodecError:
            raise
        except ValueError:  # frame exceeds ring capacity
            if len(wires) == 1:
                raise BrokerError(
                    "task too large for the shm request ring; use a "
                    "tcp:// or file:// broker for payloads this big")
            mid = len(wires) // 2
            self._put_many_wire(wires[:mid])
            self._put_many_wire(wires[mid:])

    def get(self, timeout: Optional[float] = 0.0,
            queues: Optional[Sequence[str]] = None) -> Optional[Lease]:
        leases = self.get_many(1, timeout=timeout, queues=queues)
        return leases[0] if leases else None

    def get_many(self, n: int, timeout: Optional[float] = 0.0,
                 queues: Optional[Sequence[str]] = None) -> List[Lease]:
        qsel = _normalize_queues(queues)
        qlist = None if qsel is None else list(qsel)
        qkey: Tuple = ("*",) if qlist is None else tuple(qlist)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # the prefetch pipeline first: a hot drain loop usually
            # finds its next batch already sitting in the response ring
            ch = self._channel()
            if ch.prefetch_n or ch.stash is not None:
                while ch.stash is None and ch.prefetch_n:
                    if not self._settle_prefetch(ch):
                        self._drop_channel()
                        break
                if getattr(self._tls, "ch", None) is not ch:
                    continue  # desynced mid-settle: fresh channel
                leases = self._claim_stash(ch, qkey, n)
                if leases:
                    self._maybe_prefetch(n, qlist, qkey)
                    return leases
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
                self._maybe_prefetch(n, qlist, qkey)
                return leases
            if deadline is not None and time.monotonic() >= deadline:
                return []

    def ack(self, tag: str) -> None:
        self._call("ack", tag=tag, _defer=self.pipeline_acks)

    def ack_many(self, tags: Iterable[str]) -> None:
        tags = list(tags)
        if tags:
            self._call("ack_many", tags=tags, _defer=self.pipeline_acks)

    def nack(self, tag: str) -> None:
        self._call("nack", tag=tag, _defer=self.pipeline_acks)

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
        self._call("set_max_queue_depth", queue=queue,
                   depth=None if depth is None else int(depth))

    def heartbeat(self, consumer_id: str,
                  queues: Optional[Sequence[str]] = None) -> None:
        qsel = _normalize_queues(queues)
        self._call("heartbeat", consumer_id=consumer_id,
                   queues=None if qsel is None else list(qsel))

    def inflight_tasks(self) -> List[Tuple[Task, float]]:
        return [(Task(**d), float(age))
                for d, age in self._call("inflight_tasks")["tasks"]]

    @property
    def stats(self) -> Dict[str, Any]:
        s = dict(self._call("stats")["stats"])
        s["wire_codec"] = BIN_CODEC.name
        s["transport"] = "shm"
        return s


# ---------------------------------------------------------------------------
# bundle handoff ring (the Bundler's pluggable sink)
# ---------------------------------------------------------------------------

class BundleRing:
    """Same-host bundle handoff: fused result bundles as raw ndarray bytes.

    The consumer (learner side) creates the ring and owns its lifetime;
    producers attach by registry path and push with
    :meth:`push_bundle`, which NEVER blocks — when the consumer lags and
    the ring fills, the handoff is simply dropped because the bundle
    file just written by the Bundler remains the durable record (and the
    ``load_since`` cursor source).  One producer process at a time
    (SPSC ring); threads within that process are serialized by the
    ring's producer lock.
    """

    def __init__(self, path: str, capacity: int = 1 << 24,
                 create: bool = False, connect_timeout: float = 5.0):
        self.path = path
        if create:
            self._ring = ShmRing(create=True, capacity=int(capacity))
            self._owner = True
            seg = self._ring.name

            def init(doc: dict) -> None:
                doc["segment"] = seg
                doc["capacity"] = int(capacity)
                doc["epoch"] = int(doc.get("epoch", 0)) + 1
                doc["pid"] = os.getpid()

            jsonstore.update_json(self.path, init, strict=True)
        else:
            deadline = time.monotonic() + connect_timeout
            while True:
                doc = jsonstore.load_json(self.path, default=None)
                if isinstance(doc, dict) and doc.get("segment"):
                    break
                if time.monotonic() >= deadline:
                    raise BrokerUnavailable(
                        f"no bundle ring registry at {self.path}")
                time.sleep(0.02)
            self._ring = ShmRing(name=doc["segment"])
            self._owner = False

    def push_bundle(self, lo: int, hi: int,
                    results: Dict[str, Any]) -> bool:
        """Non-blocking handoff; False when the ring is full or the
        bundle exceeds its capacity (the file write already happened)."""
        frame = BIN_CODEC.encode(
            {"lo": int(lo), "hi": int(hi),
             "arrays": {k: np.asarray(v) for k, v in results.items()}})
        try:
            return self._ring.try_push(frame)
        except ValueError:
            return False  # bundle bigger than the ring: file-only handoff

    def pop_bundle(self, timeout: float = 0.0
                   ) -> Optional[Tuple[int, int, Dict[str, np.ndarray]]]:
        raw = self._ring.pop(timeout=timeout)
        if raw is None:
            return None
        doc = BIN_CODEC.decode(raw)
        return int(doc["lo"]), int(doc["hi"]), dict(doc["arrays"])

    def drain(self) -> List[Tuple[int, int, Dict[str, np.ndarray]]]:
        out = []
        while True:
            item = self.pop_bundle(timeout=0.0)
            if item is None:
                return out
            out.append(item)

    def close(self) -> None:
        self._ring.close()
        if self._owner:
            self._ring.unlink()

    def __enter__(self) -> "BundleRing":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
