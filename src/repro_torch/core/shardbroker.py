"""ShardedBroker: queue-name federation over N broker endpoints.

The paper's deployment (Sec. 2.2) funnels every allocation's producers and
surge consumers through ONE RabbitMQ host — exactly the single-server
bottleneck a :class:`~repro_torch.core.netbroker.BrokerServer` becomes once
ensemble throughput outgrows one process.  :class:`ShardedBroker` is the
federation layer: it implements the full
:class:`~repro_torch.core.queue.Broker` protocol over N independent endpoints
by routing **whole queues** to shards.

Routing model (why by queue, not by task):

* Every queue name maps to exactly one shard — resolved on a
  deterministic consistent-hash ring (:mod:`repro_torch.core.hashring`) over
  the member set, overridable per queue with an explicit
  ``queue_shards`` map (or membership ``pins``) for operators who want,
  say, the simulation queue pinned to the big box.  The ring — not
  ``crc32 % N`` — is what makes the federation *elastic*: a member
  joining or leaving moves only ~K/N queues instead of rehashing all of
  them.
* Because a queue never spans shards, *all* per-queue semantics the rest
  of the system relies on survive federation unchanged: strict
  ``(priority, seq)`` order within a queue, visibility timeouts, weighted
  fairness inside a shard, lease/ack idempotency.  Global cross-queue
  priority becomes best-effort across shards (as with any federation) —
  exact within each shard.
* ``get_many(queues=...)`` fans out only to the shards that own those
  queues; a subscription that lives entirely on one shard degenerates to
  a single pass-through call (no fan-out tax for pinned workers).

Lease tags are wrapped as ``"<member-slot>:<epoch>:<backend-tag>"`` so
``ack``, ``ack_many`` (grouped per shard: one call each), and ``nack``
route back to the owning shard without keeping client-side lease state —
a ShardedBroker is as stateless as a NetBroker, so any instance (any
process) can ack any other instance's tags.  For a static federation the
slot IS the shard index; under elastic membership slots are allocated
monotonically and never reused.  The epoch fences replica failover,
and the slot generalizes the same fence to membership changes:
tags minted against a member that has since left the ring raise
:class:`~repro_torch.core.queue.StaleEpochError` on ack/nack (silently dropped
and counted for ``ack_many``) instead of completing work another member
has already redelivered.

**Elastic membership**: :meth:`ShardedBroker.from_membership` builds a
client from the versioned membership registry a ``broker-serve --join``
federation maintains in its announce file.  The client re-reads the file
(signature-cached, throttled) and re-resolves routing whenever the
membership *version* bumps — joins/leaves/evictions/pins propagate to
every live client without restarts.  Live queue handoff between members
is the drain-and-forward protocol in :func:`migrate_queue_between`.

Introspection merges the shard views: ``qsize``/``inflight`` sum,
``queue_names`` unions, ``stats`` sums the counters, merges the
per-queue ``consumers`` heartbeat views, and keeps the per-shard
breakdown under ``"shards"``.  ``BrokerFull`` backpressure raised by one
shard propagates to the producer exactly like a local backend's.

Construction: pass broker instances, or URLs (resolved through
:func:`~repro_torch.core.netbroker.make_broker`), or use the ``shard://`` URL
scheme — ``shard://host1:p1,host2:p2`` — or hand ``make_broker`` /
``MerlinRuntime(broker=...)`` a list of ``tcp://`` endpoints directly.
``ring+file://<path>`` builds the elastic (membership-following) client.
"""
from __future__ import annotations

import json
import os
import time
from typing import (Any, Dict, Iterable, List, Optional, Sequence, Tuple,
                    Union)

import threading

from repro_torch.core import jsonstore
from repro_torch.core.hashring import (DEFAULT_VNODES, HashRing, Membership,
                                 join_membership, leave_membership,
                                 read_membership)
from repro_torch.core.queue import (Broker, BrokerUnavailable, Lease,
                              StaleEpochError, Task, _normalize_queues,
                              validate_queue_name)

_DEFAULT_RINGS: Dict[int, HashRing] = {}


def _static_keys(n: int) -> List[str]:
    return [f"shard-{i}" for i in range(n)]


def shard_index(queue: str, n_shards: int) -> int:
    """The stable default queue->shard mapping for a *static* federation
    of ``n_shards`` positional members: owner position on the default
    consistent-hash ring (deterministic across processes and runs, unlike
    Python ``hash()``)."""
    ring = _DEFAULT_RINGS.get(n_shards)
    if ring is None:
        ring = _DEFAULT_RINGS.setdefault(n_shards,
                                         HashRing(_static_keys(n_shards)))
    return int(ring.owner(queue)[len("shard-"):])


# ---------------------------------------------------------------------------
# endpoint discovery file
# ---------------------------------------------------------------------------
# ``broker-serve --announce <path>`` publishes each server's bound endpoint
# into ONE shared JSON file; ``make_broker("shard+file://<path>")`` reads it
# and assembles the shard list — launchers stop hand-building URL lists and
# stop caring which server bound which ephemeral port.  Format:
#
#     {"endpoints": {"0": "tcp://h1:p1", "1": "tcp://h2:p2"}, "n": 2}
#
# Keys are shard indices (from ``--shard-of I/N``, which also sets "n", the
# expected federation size discovery waits for) or the URL itself for
# unindexed servers.  Writers merge through jsonstore.update_json (fcntl
# lock sidecar + atomic rename), so concurrent servers on a shared
# filesystem cannot tear or drop each other's entries.
#
# ``broker-serve --join <path>`` upgrades the same file into the live
# membership registry (see repro_torch.core.hashring): a versioned member set
# with heartbeats, TTL eviction, and per-queue pins, with the legacy
# ``endpoints``/``n`` keys kept mirrored for old readers.

def announce_endpoint(path: str, url: str, index: Optional[int] = None,
                      total: Optional[int] = None) -> None:
    """Merge ``url`` into the announce file at ``path`` (atomic, locked)."""
    def _apply(doc: Dict[str, Any]) -> None:
        eps = doc.setdefault("endpoints", {})
        eps[url if index is None else str(index)] = url
        if total is not None:
            doc["n"] = int(total)
    # strict: a server that cannot announce is invisible to discovery —
    # better to fail its startup loudly than hang join_shards at the client
    jsonstore.update_json(path, _apply, strict=True)


def read_endpoints(path: str) -> Tuple[List[str], Optional[int]]:
    """The announced (ordered) endpoint URLs plus the declared federation
    size, if any.  Indexed entries come first in shard-index order — the
    order MUST be stable across every reader, or the queue->shard hash
    disagrees between producers and consumers."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return [], None
    eps = doc.get("endpoints", {})
    indexed = sorted((int(k), u) for k, u in eps.items()
                     if k.lstrip("-").isdigit())
    rest = sorted(u for k, u in eps.items() if not k.lstrip("-").isdigit())
    n = doc.get("n")
    return [u for _, u in indexed] + rest, None if n is None else int(n)


def _endpoint_alive(url: str, timeout: float = 1.0) -> bool:
    """Best-effort liveness probe: one raw TCP connect, no protocol, no
    retries (a refused port answers instantly — NetBroker.ping would burn
    its whole reconnect window on it).  Non-tcp URLs — mem://, file:// —
    have no server to probe and count as alive."""
    if not url.startswith("tcp://"):
        return True
    import socket

    from repro_torch.core.netbroker import parse_address
    try:
        sock = socket.create_connection(parse_address(url), timeout=timeout)
    except OSError:
        return False
    try:
        sock.close()
    except OSError:
        pass
    return True


def discover_shards(path: str, expect: Optional[int] = None,
                    timeout: float = 10.0, poll: float = 0.05,
                    settle: float = 0.5,
                    **endpoint_kwargs) -> "ShardedBroker":
    """Build a ShardedBroker from an announce file, waiting (up to
    ``timeout``) until the declared federation size — ``expect`` or the
    file's own "n" — has announced.

    Candidate sets are liveness-probed (dead endpoints dropped) before
    acceptance, not on every poll: entries persist across federation
    restarts (nothing ever un-announces — an indexed restart replaces its
    slot, an unindexed one on a fresh ephemeral port cannot), so without
    the probe a reader racing a relaunch would assemble the PREVIOUS
    run's dead shard list — with a declared "n", a fully-stale file would
    even satisfy the count immediately.

    With NO declared size, membership is inherently ambiguous while
    servers are still announcing: a client reading between two
    announcements would build a smaller federation than one reading after
    — and the queue->shard routing would split brains.  Discovery
    therefore waits until the file has been *stable* for ``settle``
    seconds before accepting an undeclared set.  Declaring N via
    ``--shard-of`` / ``expect=`` is still the recommended mode: it pins
    membership and the shard ORDER every client must agree on."""
    deadline = time.monotonic() + timeout
    last_sig: Any = ()
    sig_since = time.monotonic()
    while True:
        try:
            st = os.stat(path)
            sig: Any = (st.st_mtime_ns, st.st_size)
        except OSError:
            sig = None
        now = time.monotonic()
        if sig != last_sig:
            last_sig, sig_since = sig, now
        urls, declared = read_endpoints(path)
        want = expect if expect is not None else declared
        settled = want is not None or now - sig_since >= settle
        if urls and settled and (want is None or len(urls) >= want):
            live = [u for u in urls if _endpoint_alive(u)]
            if live and (want is None or len(live) >= want):
                return ShardedBroker(live if want is None else live[:want],
                                     **endpoint_kwargs)
        if time.monotonic() >= deadline:
            raise BrokerUnavailable(
                f"announce file {path!r} published {len(urls)} endpoint(s) "
                f"(live subset insufficient) within {timeout}s "
                f"(wanted {want or 'at least 1, settled'})")
        time.sleep(poll)


class ShardedBroker:
    """Implements the Broker protocol over N shard endpoints.

    ``shards``: Broker instances or broker URLs (``tcp://...`` etc.).
    ``queue_shards``: explicit ``{queue: shard_index}`` overrides; every
    other queue routes on the consistent-hash ring.
    ``poll_slice``: when a blocking ``get_many`` spans multiple shards,
    the wait rotates across them in slices of this many seconds (one
    shard parks server-side per slice; the others are polled
    non-blocking each rotation).
    ``ring_vnodes``: virtual nodes per member on the routing ring.
    """

    def __init__(self, shards: Sequence[Union[Broker, str, Sequence]],
                 queue_shards: Optional[Dict[str, int]] = None,
                 poll_slice: float = 0.05,
                 ring_vnodes: int = DEFAULT_VNODES, **endpoint_kwargs):
        if not shards:
            raise ValueError("ShardedBroker needs at least one shard")
        self._endpoint_kwargs = dict(endpoint_kwargs)
        # each shard entry may name REPLICA candidates: a list of
        # brokers/URLs, or a "url1|url2" pipe-string.  The first candidate
        # is the initial primary; on primary death queue ownership fails
        # over to the next live candidate under a bumped per-shard epoch.
        self._candidates: List[List[Union[Broker, str]]] = []
        for s in shards:
            if isinstance(s, str) and "|" in s:
                cands: List[Union[Broker, str]] = \
                    [c for c in s.split("|") if c]
            elif isinstance(s, (list, tuple)):
                cands = list(s)
            else:
                cands = [s]
            if not cands:
                raise ValueError("shard entry names no endpoints")
            self._candidates.append(cands)
        resolved: List[Broker] = []
        for cands in self._candidates:
            primary = self._resolve(cands[0])
            if primary is None:
                raise BrokerUnavailable(
                    f"cannot construct primary endpoint {cands[0]!r}")
            cands[0] = primary  # resolve once; failover reuses the instance
            resolved.append(primary)
        self.shards: List[Broker] = resolved
        self._active_cand = [0] * len(resolved)
        self._epochs = [0] * len(resolved)
        self._fo_lock = threading.Lock()
        self._failovers = 0
        self._stale_acks_rejected = 0
        self.queue_shards = dict(queue_shards or {})
        for q, i in self.queue_shards.items():
            validate_queue_name(q)
            if not 0 <= int(i) < len(self.shards):
                raise ValueError(f"queue_shards[{q!r}] = {i} out of range "
                                 f"for {len(self.shards)} shards")
        self.poll_slice = poll_slice
        self._rr_offset = 0  # rotates blocking waits across shards
        # -- ring routing state.  Static construction: ring keys are the
        # positional "shard-i" names and slot == index, which makes the
        # lease-tag format identical to the pre-elastic one.
        self._ring_vnodes = int(ring_vnodes)
        self._ring_keys: List[str] = _static_keys(len(resolved))
        self._slots: List[int] = list(range(len(resolved)))
        self._slot2idx: Dict[int, int] = {i: i for i in
                                          range(len(resolved))}
        self._retired_slots: Dict[int, str] = {}  # slot -> former member
        self._next_slot = len(resolved)  # membership slot watermark
        self._ring = HashRing(self._ring_keys, vnodes=self._ring_vnodes)
        self._key2idx: Dict[str, int] = {k: i for i, k in
                                         enumerate(self._ring_keys)}
        self._pins: Dict[str, str] = {}  # queue -> member key (elastic)
        self._ring_version = 0
        # elastic membership-following state (None = static federation)
        self._members_conf: Optional[jsonstore.SharedJsonConfig] = None
        self._refresh_interval = 0.25
        self._last_refresh = 0.0

    # -- elastic construction ------------------------------------------------
    @classmethod
    def from_membership(cls, path: str, *,
                        refresh_interval: float = 0.25,
                        ring_vnodes: int = DEFAULT_VNODES,
                        poll_slice: float = 0.05,
                        **endpoint_kwargs) -> "ShardedBroker":
        """Build an elastic client that follows the membership registry at
        ``path``: routing re-resolves whenever the membership version
        bumps (join/leave/eviction/pin), moving only the affected ~K/N
        queues.  Lease tags carry the member *slot*, so a membership
        change fences tags minted against departed members exactly like a
        replica failover fences a dead primary's."""
        m = read_membership(path)
        if m is None or not m.members:
            raise BrokerUnavailable(
                f"membership file {path!r} names no members")
        sb = cls(m.urls(), poll_slice=poll_slice, ring_vnodes=ring_vnodes,
                 **endpoint_kwargs)
        sb._members_conf = jsonstore.SharedJsonConfig(path)
        # prime the signature cache; a write that landed between
        # read_membership and here surfaces in the primed doc
        doc = sb._members_conf.load_if_changed()
        if isinstance(doc, dict) and "membership" in doc:
            m2 = Membership.from_doc(doc["membership"])
            if m2.members:
                m = m2
        sb._refresh_interval = float(refresh_interval)
        with sb._fo_lock:
            sb._install_membership_locked(m)
            # the pre-install static placeholder slots never minted a
            # lease, so retiring them is construction residue, not
            # fencing state (the next_slot watermark still fences any
            # historic membership slot)
            sb._retired_slots.clear()
        return sb

    def _maybe_refresh(self) -> None:
        """Elastic mode: re-read the membership file (throttled, and only
        when its on-disk signature moved) and re-resolve routing on a
        version bump.  Static federations no-op."""
        conf = self._members_conf
        if conf is None:
            return
        now = time.monotonic()
        if now - self._last_refresh < self._refresh_interval:
            return
        self._last_refresh = now
        doc = conf.load_if_changed()
        if doc is None:
            return
        m = Membership.from_doc(doc.get("membership", {})) \
            if isinstance(doc, dict) and "membership" in doc else None
        if m is None or m.version == self._ring_version or not m.members:
            return
        with self._fo_lock:
            if m.version != self._ring_version:
                self._install_membership_locked(m)

    def _install_membership_locked(self, m: Membership) -> None:
        """Swap routing to membership ``m``.  Members carry over their
        broker client, candidates, and failover epoch; departed members'
        slots are retired (their outstanding lease tags fence); new
        members get freshly resolved clients.  The positional lists are
        REPLACED wholesale (not mutated), so an operation that captured
        an index against the old arrays stays internally consistent."""
        old_idx = {k: i for i, k in enumerate(self._ring_keys)}
        urls = m.urls()
        shards: List[Broker] = []
        cands: List[List[Union[Broker, str]]] = []
        active: List[int] = []
        epochs: List[int] = []
        slots: List[int] = []
        keys: List[str] = []
        for url in urls:
            slot = m.slot_of(url)
            i = old_idx.get(url)
            if i is not None and self._slots[i] == slot:
                shards.append(self.shards[i])
                cands.append(self._candidates[i])
                active.append(self._active_cand[i])
                epochs.append(self._epochs[i])
            else:
                b = self._resolve(url)
                if b is None:
                    continue  # unresolvable member: route around it
                shards.append(b)
                cands.append([b])
                active.append(0)
                epochs.append(0)
            slots.append(slot)
            keys.append(url)
        if not shards:
            return  # never swap to an empty federation
        kept = set(keys)
        for i, k in enumerate(self._ring_keys):
            if k not in kept or self._slots[i] not in slots:
                self._retired_slots[self._slots[i]] = k
                if k not in kept:
                    old = self.shards[i]
                    if all(old is not s for s in shards):
                        close = getattr(old, "close", None)
                        if close is not None:
                            try:
                                close()
                            except Exception:
                                pass
        self.shards = shards
        self._candidates = cands
        self._active_cand = active
        self._epochs = epochs
        self._slots = slots
        self._ring_keys = keys
        self._slot2idx = {s: i for i, s in enumerate(slots)}
        self._ring = HashRing(keys, vnodes=self._ring_vnodes)
        self._key2idx = {k: i for i, k in enumerate(keys)}
        self._pins = {q: u for q, u in m.pins.items() if u in self._key2idx}
        self._ring_version = m.version
        self._next_slot = max(self._next_slot, m.next_slot,
                              max(slots) + 1)
        # index pins from the static constructor may now be out of range
        self.queue_shards = {q: i for q, i in self.queue_shards.items()
                             if 0 <= int(i) < len(shards)}

    def _resolve(self, cand: Union[Broker, str]) -> Optional[Broker]:
        if not isinstance(cand, str):
            return cand
        from repro_torch.core.netbroker import make_broker
        try:
            return make_broker(cand, **self._endpoint_kwargs)
        except (ValueError, OSError, BrokerUnavailable):
            return None

    # -- failover ------------------------------------------------------------
    def _failover(self, idx: int, seen_epoch: int) -> bool:
        """Swap shard ``idx`` to its next live replica candidate and bump
        the shard epoch (fencing every lease tag minted before the swap).
        Returns True when the shard now points at a (possibly new) live
        endpoint; False when no candidate answered."""
        with self._fo_lock:
            if idx >= len(self.shards):
                return False
            if self._epochs[idx] != seen_epoch:
                return True  # a concurrent caller already failed over
            cands = self._candidates[idx]
            start = self._active_cand[idx]
            for off in range(1, len(cands) + 1):
                j = (start + off) % len(cands)
                cand = cands[j]
                if isinstance(cand, str) and not _endpoint_alive(cand):
                    continue
                broker = self._resolve(cand)
                if broker is None:
                    continue
                if isinstance(cand, str):
                    cands[j] = broker  # cache the client for future cycles
                old = self.shards[idx]
                self.shards[idx] = broker
                self._active_cand[idx] = j
                self._epochs[idx] += 1
                self._failovers += 1
                if old is not broker:
                    close = getattr(old, "close", None)
                    if close is not None:
                        try:
                            close()
                        except Exception:
                            pass
                return True
            return False

    def _call_shard(self, idx: int, fn):
        """Run ``fn(shard)`` with one failover-and-retry on endpoint death."""
        if idx >= len(self.shards):
            raise BrokerUnavailable(
                f"shard index {idx} no longer exists "
                f"({len(self.shards)} members)")
        seen = self._epochs[idx]
        try:
            return fn(self.shards[idx])
        except BrokerUnavailable:
            if not self._failover(idx, seen):
                raise
        return fn(self.shards[idx])

    def shard_health(self) -> List[Dict[str, Any]]:
        """Per-shard view for merlin-status: active endpoint, epoch, and a
        liveness probe of every replica candidate."""
        out: List[Dict[str, Any]] = []
        for i, cands in enumerate(self._candidates):
            ents = []
            for j, c in enumerate(cands):
                url = c if isinstance(c, str) else \
                    getattr(c, "address", type(c).__name__)
                ents.append({"endpoint": url,
                             "alive": _endpoint_alive(url)
                             if isinstance(url, str) else True,
                             "active": j == self._active_cand[i]})
            active = self.shards[i]
            out.append({"shard": i, "slot": self._slots[i],
                        "member": self._ring_keys[i],
                        "epoch": self._epochs[i],
                        "endpoint": getattr(active, "address",
                                            type(active).__name__),
                        "candidates": ents})
        return out

    def ring_info(self) -> Dict[str, Any]:
        """The merlin-status --ring view: membership version, per-member
        owned-queue counts, in-flight migrations, candidate health."""
        self._maybe_refresh()
        try:
            queues = self.queue_names()
        except BrokerUnavailable:
            queues = []
        owned: Dict[int, List[str]] = {}
        for q in queues:
            owned.setdefault(self.shard_for(q), []).append(q)
        health = self.shard_health()
        members: List[Dict[str, Any]] = []
        for i in range(len(self.shards)):
            migrating: List[str] = []
            try:
                st = self._call_shard(i, lambda b: b.stats)
                migrating = list(st.get("migrating", []))
            except BrokerUnavailable:
                pass
            members.append({**health[i],
                            "queues_owned": len(owned.get(i, [])),
                            "queues": sorted(owned.get(i, [])),
                            "migrating": migrating})
        return {"version": self._ring_version,
                "vnodes": self._ring_vnodes,
                "elastic": self._members_conf is not None,
                "members": members,
                "pins": dict(self._pins),
                "queue_pins": dict(self.queue_shards),
                "retired_slots": dict(self._retired_slots)}

    # -- routing -------------------------------------------------------------
    def shard_for(self, queue: str) -> int:
        """The shard index owning ``queue`` (index override map, then
        membership pins, then the consistent-hash ring)."""
        self._maybe_refresh()
        idx = self.queue_shards.get(queue)
        if idx is not None:
            return int(idx)
        pin = self._pins.get(queue)
        if pin is not None:
            hit = self._key2idx.get(pin)
            if hit is not None:
                return hit
        return self._key2idx[self._ring.owner(queue)]

    def _shard_selectors(self, queues: Optional[Tuple[str, ...]]
                         ) -> Dict[int, Optional[List[str]]]:
        """shard index -> the queue subset it owns (None = all queues)."""
        if queues is None:
            return {i: None for i in range(len(self.shards))}
        sel: Dict[int, List[str]] = {}
        for q in queues:
            sel.setdefault(self.shard_for(q), []).append(q)
        return sel

    def _wrap(self, idx: int, lease: Lease) -> Lease:
        # the member slot + shard epoch ride in the tag: after a failover
        # (epoch bump) or a membership change (slot retired), tags minted
        # against the previous owner are FENCED — their ack/nack raises
        # StaleEpochError instead of silently completing against a broker
        # that no longer owns the queue
        return Lease(lease.task,
                     f"{self._slots[idx]}:{self._epochs[idx]}:{lease.tag}")

    def _unwrap(self, tag: str) -> Tuple[int, int, str]:
        slot_s, _, rest = tag.partition(":")
        epoch_s, _, inner = rest.partition(":")
        try:
            slot = int(slot_s)
            epoch = int(epoch_s)
        except ValueError:
            raise ValueError(f"not a sharded lease tag: {tag!r}") from None
        return slot, epoch, inner

    def _idx_for_slot(self, slot: int, tag: str) -> Optional[int]:
        """Map a tag's member slot to the current shard index.  None =
        the slot was retired by a membership change (the caller fences);
        a slot this federation never allocated is a malformed tag.
        Slots below the membership's monotonic watermark fence even when
        this instance never saw them active — a rebuilt client must
        fence a historic tag, not reject it as malformed."""
        idx = self._slot2idx.get(slot)
        if idx is not None:
            return idx
        if slot in self._retired_slots or 0 <= slot < self._next_slot:
            return None
        raise ValueError(f"not a sharded lease tag: {tag!r}")

    def _fence(self, tag: str, why: str) -> None:
        with self._fo_lock:
            self._stale_acks_rejected += 1
        raise StaleEpochError(
            f"lease tag {tag!r} {why} — the task redelivers on the "
            f"current owner")

    def _check_epoch(self, idx: int, epoch: int, tag: str) -> None:
        if epoch != self._epochs[idx]:
            self._fence(tag, f"was minted under epoch {epoch}; the shard "
                             f"is now at epoch {self._epochs[idx]} "
                             f"(primary failed over)")

    # -- producer side -------------------------------------------------------
    def put(self, task: Task) -> None:
        self._call_shard(self.shard_for(task.queue), lambda b: b.put(task))

    def put_many(self, tasks: List[Task]) -> None:
        by_shard: Dict[int, List[Task]] = {}
        for t in tasks:
            by_shard.setdefault(self.shard_for(t.queue), []).append(t)
        # sequential, one batched call per shard; a BrokerFull from one
        # shard propagates after earlier shards were fed — at-least-once
        # delivery makes retrying the whole batch safe
        for idx, ts in by_shard.items():
            self._call_shard(idx, lambda b, ts=ts: b.put_many(ts))

    # -- consumer side -------------------------------------------------------
    def get(self, timeout: Optional[float] = 0.0,
            queues: Optional[Sequence[str]] = None) -> Optional[Lease]:
        leases = self.get_many(1, timeout=timeout, queues=queues)
        return leases[0] if leases else None

    def get_many(self, n: int, timeout: Optional[float] = 0.0,
                 queues: Optional[Sequence[str]] = None) -> List[Lease]:
        """Claim up to ``n`` leases from the shards owning the subscription.

        Single-shard subscriptions on a *static* federation pass straight
        through (the blocking wait parks on that shard, server-side for
        NetBroker shards).  Multi-shard subscriptions — and every elastic
        subscription — poll the owning shards non-blocking, then rotate a
        ``poll_slice`` blocking wait across them until the deadline; the
        elastic loop re-resolves membership between rotations, so a queue
        that migrates mid-wait is claimed from its NEW owner within one
        rotation instead of parking on the old one until timeout.
        """
        qsel = _normalize_queues(queues)
        self._maybe_refresh()
        elastic = self._members_conf is not None
        sel = self._shard_selectors(qsel)
        if len(sel) == 1 and not elastic:
            idx, qs = next(iter(sel.items()))
            leases = self._call_shard(
                idx, lambda b: b.get_many(n, timeout=timeout, queues=qs))
            return [self._wrap(idx, l) for l in leases]
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Lease] = []
        while True:
            # fast pass: drain whatever is claimable right now, rotating
            # the start shard so one busy shard cannot monopolize batches
            order = sorted(sel)
            self._rr_offset = (self._rr_offset + 1) % max(len(order), 1)
            for k in range(len(order)):
                idx = order[(self._rr_offset + k) % len(order)]
                want = n - len(out)
                got = self._call_shard(
                    idx, lambda b, want=want, qs=sel[idx]:
                    b.get_many(want, timeout=0.0, queues=qs))
                out.extend(self._wrap(idx, l) for l in got)
                if len(out) >= n:
                    return out
            if out:
                return out
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return out
                slice_t = min(self.poll_slice, remaining)
            else:
                slice_t = self.poll_slice
            # blocking slice on one shard; next rotation polls the rest
            idx = order[self._rr_offset % len(order)]
            got = self._call_shard(
                idx, lambda b, qs=sel[idx]:
                b.get_many(n, timeout=slice_t, queues=qs))
            out.extend(self._wrap(idx, l) for l in got)
            if out:
                return out
            if elastic:
                self._maybe_refresh()
                sel = self._shard_selectors(qsel)

    def ack(self, tag: str) -> None:
        slot, epoch, inner = self._unwrap(tag)
        idx = self._idx_for_slot(slot, tag)
        if idx is None:
            self._fence(tag, f"was minted against member slot {slot}, "
                             f"which has left the ring")
        self._check_epoch(idx, epoch, tag)
        self._call_shard(idx, lambda b: b.ack(inner))

    def ack_many(self, tags: Iterable[str]) -> None:
        """Batch ack with slot + epoch fencing.  Unlike single ``ack``,
        stale tags are silently DROPPED (and counted in
        ``stale_acks_rejected``) — ack_many is the worker's
        retried-forever flush path, and a raise would wedge every fresh
        tag in the batch behind one zombie."""
        by_shard: Dict[int, List[str]] = {}
        stale = 0
        for tag in tags:
            slot, epoch, inner = self._unwrap(tag)
            idx = self._idx_for_slot(slot, tag)
            if idx is None or epoch != self._epochs[idx]:
                stale += 1
                continue
            by_shard.setdefault(idx, []).append(inner)
        if stale:
            with self._fo_lock:
                self._stale_acks_rejected += stale
        for idx, inner_tags in by_shard.items():
            self._call_shard(
                idx, lambda b, ts=inner_tags: b.ack_many(ts))

    def nack(self, tag: str) -> None:
        slot, epoch, inner = self._unwrap(tag)
        idx = self._idx_for_slot(slot, tag)
        if idx is None:
            self._fence(tag, f"was minted against member slot {slot}, "
                             f"which has left the ring")
        self._check_epoch(idx, epoch, tag)
        self._call_shard(idx, lambda b: b.nack(inner))

    # -- migration (drain-and-forward protocol ops) --------------------------
    def migrate_queue(self, queue: str, target: Optional[str]) -> None:
        """Mark/clear ``queue`` migrating on its owning shard (see
        :func:`migrate_queue_between` for the full handoff)."""
        self._call_shard(self.shard_for(queue),
                         lambda b: b.migrate_queue(queue, target))

    def export_queue(self, queue: str, max_n: int = 256) -> List[Dict]:
        return self._call_shard(
            self.shard_for(queue), lambda b: b.export_queue(queue, max_n))

    def import_tasks(self, tasks: List[Dict]) -> None:
        by_shard: Dict[int, List[Dict]] = {}
        for t in tasks:
            by_shard.setdefault(self.shard_for(t["queue"]), []).append(t)
        for idx, ts in by_shard.items():
            self._call_shard(idx, lambda b, ts=ts: b.import_tasks(ts))

    # -- introspection (merged views) ----------------------------------------
    def qsize(self, queues: Optional[Sequence[str]] = None) -> int:
        qsel = _normalize_queues(queues)
        self._maybe_refresh()
        return sum(self._call_shard(idx, lambda b, qs=qs: b.qsize(qs))
                   for idx, qs in self._shard_selectors(qsel).items())

    def queue_names(self) -> List[str]:
        self._maybe_refresh()
        names = set()
        for idx in range(len(self.shards)):
            names.update(self._call_shard(idx, lambda b: b.queue_names()))
        return sorted(names)

    def inflight(self) -> int:
        return sum(self._call_shard(idx, lambda b: b.inflight())
                   for idx in range(len(self.shards)))

    def inflight_tasks(self) -> List[Tuple[Task, float]]:
        out: List[Tuple[Task, float]] = []
        for idx in range(len(self.shards)):
            out.extend(self._call_shard(idx, lambda b: b.inflight_tasks()))
        return out

    def idle(self) -> bool:
        self._maybe_refresh()
        return all(self._call_shard(idx, lambda b: b.idle())
                   for idx in range(len(self.shards)))

    def set_visibility_timeout(self, queue: str, timeout: float) -> None:
        self._call_shard(self.shard_for(queue),
                         lambda b: b.set_visibility_timeout(queue, timeout))

    def set_max_queue_depth(self, queue: str, depth: Optional[int]) -> None:
        """Per-queue backpressure bound, applied on the queue's owning
        shard (queues never span shards, so one shard is enough)."""
        self._call_shard(self.shard_for(queue),
                         lambda b: b.set_max_queue_depth(queue, depth))

    def heartbeat(self, consumer_id: str,
                  queues: Optional[Sequence[str]] = None) -> None:
        """Register with every shard the subscription touches (all shards
        for a None subscription), so each shard's ``stats["consumers"]``
        reflects the consumers that can actually drain it."""
        qsel = _normalize_queues(queues)
        self._maybe_refresh()
        for idx, qs in self._shard_selectors(qsel).items():
            self._call_shard(
                idx, lambda b, qs=qs: b.heartbeat(consumer_id, qs))

    @property
    def stats(self) -> Dict[str, Any]:
        """Counters summed across shards; per-queue ``consumers`` views
        merged (max per queue — the same consumer heartbeats every shard
        it subscribes on); dict-of-number counters (``acked_by_queue``)
        summed per key; raw per-shard dicts under ``"shards"``."""
        merged: Dict[str, Any] = {}
        consumers: Dict[str, int] = {}
        per_shard: List[Dict[str, Any]] = []
        for idx in range(len(self.shards)):
            st = dict(self._call_shard(idx, lambda b: b.stats))
            per_shard.append(st)
            for q, c in (st.get("consumers") or {}).items():
                consumers[q] = max(consumers.get(q, 0), int(c))
            for k, v in st.items():
                if k == "consumers":
                    continue
                if isinstance(v, (int, float)):
                    merged[k] = merged.get(k, 0) + v
                elif isinstance(v, dict):
                    # per-queue counter maps: each queue lives on exactly
                    # one shard, but sum anyway (robust to resharding)
                    sub = merged.setdefault(k, {})
                    for q, c in v.items():
                        if isinstance(c, (int, float)):
                            sub[q] = sub.get(q, 0) + c
        merged["consumers"] = consumers
        merged["shards"] = per_shard
        merged["epochs"] = list(self._epochs)
        merged["failovers"] = self._failovers
        merged["stale_acks_rejected"] = self._stale_acks_rejected
        merged["ring_version"] = self._ring_version
        return merged

    def close(self) -> None:
        seen = set()
        for s in list(self.shards) + [c for cands in self._candidates
                                      for c in cands
                                      if not isinstance(c, str)]:
            if id(s) in seen:
                continue
            seen.add(id(s))
            close = getattr(s, "close", None)
            if close is not None:
                close()

    def __enter__(self) -> "ShardedBroker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# live queue migration (drain-and-forward) + federation join/leave
# ---------------------------------------------------------------------------

def _queue_inflight(broker: Broker, queue: str) -> int:
    try:
        return sum(1 for t, _ in broker.inflight_tasks()
                   if t.queue == queue)
    except BrokerUnavailable:
        return 0


def migrate_queue_between(src: Broker, dst: Broker, queue: str,
                          dst_url: Optional[str] = None, *,
                          batch: int = 256, drain_timeout: float = 30.0,
                          poll: float = 0.05) -> Dict[str, Any]:
    """Drain-and-forward handoff of one queue from ``src`` to ``dst``.

    Protocol: ``src`` marks the queue *migrating* — its consumers see an
    empty queue, new puts arriving at ``src`` (from producers still on
    the old membership version) forward to ``dst_url`` — then pending
    tasks are exported/imported in batches while in-flight leases drain
    in place under the old owner's epoch (their acks still land on
    ``src``; expiry/nack redelivery re-enters pending and is exported on
    the next sweep).  When the queue is empty and quiet, the mark clears.
    Exactly-once is preserved by the existing once-marker/ack-idempotency
    machinery; task *loss* cannot occur because every task is either
    exported+imported, forwarded, or still leased on ``src``.
    """
    moved = 0
    src.migrate_queue(queue, dst_url)
    deadline = time.monotonic() + drain_timeout
    while True:
        tasks = src.export_queue(queue, batch)
        if tasks:
            dst.import_tasks(tasks)
            moved += len(tasks)
            continue
        if _queue_inflight(src, queue) == 0:
            break
        if time.monotonic() >= deadline:
            break
        time.sleep(poll)
    # final sweep (a lease may have expired between the last export and
    # the inflight check), then clear the mark
    tasks = src.export_queue(queue, batch)
    while tasks:
        dst.import_tasks(tasks)
        moved += len(tasks)
        tasks = src.export_queue(queue, batch)
    src.migrate_queue(queue, None)
    return {"queue": queue, "moved": moved}


def _owner_url(m: Membership, ring: HashRing, queue: str) -> str:
    pin = m.pins.get(queue)
    if pin is not None and pin in m.members:
        return pin
    return ring.owner(queue)


def join_federation(path: str, url: str, *,
                    vnodes: int = DEFAULT_VNODES, batch: int = 256,
                    drain_timeout: float = 30.0,
                    **endpoint_kwargs) -> Dict[str, Any]:
    """Add ``url`` to the federation at ``path`` and rebalance: pull the
    queues the new ring assigns to ``url`` from their previous owners
    (drain-and-forward), and push out any queues parked on ``url`` that
    belong elsewhere — the latter is what lets a replacement server adopt
    a dead member's durable root and re-home its stranded queues.
    Returns ``{"version", "moved": [...]}``."""
    from repro_torch.core.netbroker import make_broker
    before = read_membership(path)
    m = join_membership(path, url)
    ring = m.ring(vnodes)
    moved: List[str] = []
    clients: Dict[str, Broker] = {}

    def client(u: str) -> Broker:
        if u not in clients:
            clients[u] = make_broker(u, **endpoint_kwargs)
        return clients[u]

    try:
        others = [u for u in m.urls() if u != url]
        was_member = bool(before and url in before.members)
        if others and not was_member:
            dst = client(url)
            for owner in others:
                try:
                    src = client(owner)
                    queues = src.queue_names()
                except BrokerUnavailable:
                    continue  # dead member: sweep_membership evicts it
                for q in sorted(queues):
                    if _owner_url(m, ring, q) == url:
                        migrate_queue_between(
                            src, dst, q, url, batch=batch,
                            drain_timeout=drain_timeout)
                        moved.append(q)
            # push out stranded queues (adopted root) owned by others
            for q in sorted(dst.queue_names()):
                target = _owner_url(m, ring, q)
                if target != url:
                    migrate_queue_between(
                        dst, client(target), q, target, batch=batch,
                        drain_timeout=drain_timeout)
                    moved.append(q)
    finally:
        for c in clients.values():
            close = getattr(c, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
    return {"version": m.version, "moved": moved}


def leave_federation(path: str, url: str, *,
                     vnodes: int = DEFAULT_VNODES, batch: int = 256,
                     drain_timeout: float = 30.0,
                     **endpoint_kwargs) -> Dict[str, Any]:
    """Remove ``url`` from the federation at ``path`` after migrating
    every queue it owns to the post-leave ring owner.  The membership
    version bumps (the ownership flip) only AFTER the drain — in-flight
    leases complete in place under the old epoch; leases still open at
    the flip are fenced on ack and redeliver on the new owner."""
    from repro_torch.core.netbroker import make_broker
    m = read_membership(path)
    if m is None or url not in m.members:
        return {"version": m.version if m else 0, "moved": []}
    others = [u for u in m.urls() if u != url]
    moved: List[str] = []
    if others:
        ring_after = HashRing(others, vnodes=vnodes)
        clients: Dict[str, Broker] = {}
        try:
            src = make_broker(url, **endpoint_kwargs)
            clients[url] = src
            for q in sorted(src.queue_names()):
                pin = m.pins.get(q)
                target = pin if pin in others else ring_after.owner(q)
                if target not in clients:
                    clients[target] = make_broker(target, **endpoint_kwargs)
                migrate_queue_between(src, clients[target], q, target,
                                      batch=batch,
                                      drain_timeout=drain_timeout)
                moved.append(q)
        finally:
            for c in clients.values():
                close = getattr(c, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
    m = leave_membership(path, url)
    return {"version": m.version, "moved": moved}
