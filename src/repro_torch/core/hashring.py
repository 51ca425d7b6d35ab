"""Consistent-hash ring + versioned federation membership.

The static federation hashed ``crc32(queue) % N``: correct while N never
changes, catastrophic the moment it does — every queue's owner moves, so
a shard join/leave means restarting every producer and consumer.  This
module replaces that substrate with the two pieces elastic membership
needs:

* :class:`HashRing` — a deterministic, seedless consistent-hash ring
  with virtual nodes.  Each member key is hashed onto ``vnodes`` points
  of a 64-bit circle; a queue is owned by the member whose point follows
  the queue's hash.  Adding or removing ONE member moves only the keys
  that fall between the affected points — ~K/N of them — instead of all
  of them.  blake2b (not Python ``hash()``) keeps the mapping identical
  across processes, runs, and PYTHONHASHSEED values.

* :class:`Membership` — the versioned membership record persisted into
  the ``shard+file://`` announce file.  Members carry a *slot* (a
  monotonically increasing integer that is never reused), a join
  timestamp and a heartbeat timestamp; the record carries a version that
  bumps on every join/leave/eviction/pin change — clients re-resolve
  routing when the version moves, and lease tags minted under a retired
  slot are fenced exactly like the replica failover epochs.  All writers go
  through :func:`jsonstore.update_json` (fcntl lock sidecar + atomic
  rename), so concurrent joiners/leavers/sweepers on a shared filesystem
  serialize instead of dropping each other's version bumps.

The membership record LAYERS onto the legacy announce format — the
``endpoints``/``n`` keys are kept mirrored (slot -> url), so old readers
(``read_endpoints``, static ``shard+file://`` discovery) keep working on
a membership-managed file.
"""
from __future__ import annotations

import bisect
import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import jsonstore

DEFAULT_VNODES = 64


def _hash64(key: str) -> int:
    """Deterministic 64-bit point on the ring (stable across processes)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring over member keys with virtual nodes.

    Construction is pure: same members (any order) + same ``vnodes`` =>
    same ring on every process, which is the whole routing contract —
    producers and consumers resolve queue ownership independently and
    must agree.
    """

    def __init__(self, members: Iterable[str],
                 vnodes: int = DEFAULT_VNODES):
        self.members: Tuple[str, ...] = tuple(sorted(set(members)))
        self.vnodes = int(vnodes)
        if self.vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        points: List[Tuple[int, str]] = []
        for m in self.members:
            for v in range(self.vnodes):
                points.append((_hash64(f"{m}#{v}"), m))
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]

    def owner(self, key: str) -> str:
        """The member owning ``key`` (first ring point at/after its hash)."""
        if not self._points:
            raise ValueError("empty ring has no owners")
        i = bisect.bisect_right(self._keys, _hash64(key))
        return self._points[i % len(self._points)][1]

    def owners(self, keys: Sequence[str]) -> Dict[str, str]:
        return {k: self.owner(k) for k in keys}

    def spread(self, keys: Sequence[str]) -> Dict[str, int]:
        """Per-member owned-key counts (every member present, even at 0)."""
        out = {m: 0 for m in self.members}
        for k in keys:
            out[self.owner(k)] += 1
        return out


def moved_keys(old: "HashRing", new: "HashRing",
               keys: Sequence[str]) -> List[str]:
    """The keys whose owner differs between two rings — the movement a
    membership change actually causes.  For a single join/leave on a
    balanced ring this is ~K/N of ``keys`` (the elastic-rebalance bar
    asserts <= 2/N)."""
    return [k for k in keys if not (old.members and new.members)
            or old.owner(k) != new.owner(k)]


# ---------------------------------------------------------------------------
# versioned membership record
# ---------------------------------------------------------------------------

@dataclass
class Membership:
    """A parsed membership record.

    ``members`` maps member url -> {"slot", "joined_at", "heartbeat_at"}.
    Slots are never reused: a member that leaves and rejoins gets a fresh
    slot, so lease tags minted against its previous incarnation stay
    fenced.  ``pins`` maps queue -> member url (operator overrides that
    win over the ring).  ``version`` bumps on every membership or pin
    change — never on heartbeats.
    """
    version: int = 0
    members: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    pins: Dict[str, str] = field(default_factory=dict)
    next_slot: int = 0

    def urls(self) -> List[str]:
        """Member urls in slot order — the stable positional order every
        client derives shard indices from."""
        return [u for u, _ in sorted(self.members.items(),
                                     key=lambda kv: kv[1]["slot"])]

    def slot_of(self, url: str) -> int:
        return int(self.members[url]["slot"])

    def ring(self, vnodes: int = DEFAULT_VNODES) -> HashRing:
        return HashRing(self.members.keys(), vnodes=vnodes)

    def to_doc(self) -> Dict[str, Any]:
        return {"version": self.version, "next_slot": self.next_slot,
                "members": self.members, "pins": self.pins}

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "Membership":
        return cls(version=int(doc.get("version", 0)),
                   members=dict(doc.get("members", {})),
                   pins=dict(doc.get("pins", {})),
                   next_slot=int(doc.get("next_slot", 0)))


def _membership_from_file_doc(doc: Dict[str, Any]) -> Optional[Membership]:
    if "membership" in doc:
        return Membership.from_doc(doc["membership"])
    eps = doc.get("endpoints")
    if not eps:
        return None
    # legacy announce-only file: synthesize a static membership (version
    # 0, slots = announce indices) so elastic clients can read it too
    indexed = sorted((int(k), u) for k, u in eps.items()
                     if k.lstrip("-").isdigit())
    rest = sorted(u for k, u in eps.items() if not k.lstrip("-").isdigit())
    members: Dict[str, Dict[str, Any]] = {}
    slot = 0
    for _, u in indexed:
        members.setdefault(u, {"slot": slot, "joined_at": 0.0,
                               "heartbeat_at": 0.0})
        slot += 1
    for u in rest:
        if u not in members:
            members[u] = {"slot": slot, "joined_at": 0.0,
                          "heartbeat_at": 0.0}
            slot += 1
    return Membership(version=0, members=members, pins={}, next_slot=slot)


def read_membership(path: str) -> Optional[Membership]:
    """Parse the membership record at ``path`` (None when the file is
    missing/empty).  Legacy announce-only files synthesize a version-0
    static membership, so ``ShardedBroker.from_membership`` works against
    federations that never ran a single ``--join``."""
    doc = jsonstore.load_json(path)
    if not isinstance(doc, dict):
        return None
    return _membership_from_file_doc(doc)


def _mirror_endpoints(doc: Dict[str, Any], m: Membership) -> None:
    """Keep the legacy ``endpoints``/``n`` keys in sync so pre-elastic
    readers (read_endpoints, static shard+file:// discovery) see the
    membership-managed federation."""
    doc["endpoints"] = {str(meta["slot"]): url
                        for url, meta in m.members.items()}
    doc["n"] = len(m.members)


def _update_membership(path: str, fn) -> Membership:
    """Locked read-modify-write of the membership section.  ``fn`` gets
    the parsed Membership (synthesized from a legacy announce file on
    first touch) and mutates it in place; returns True to bump version."""
    box: Dict[str, Membership] = {}

    def _apply(doc: Dict[str, Any]) -> None:
        m = _membership_from_file_doc(doc) or Membership()
        if fn(m):
            m.version += 1
        doc["membership"] = m.to_doc()
        _mirror_endpoints(doc, m)
        box["m"] = m

    # strict: a member that cannot register/deregister is invisible to the
    # federation — fail loudly rather than split-brain silently
    jsonstore.update_json(path, _apply, strict=True)
    return box["m"]


def join_membership(path: str, url: str,
                    now: Optional[float] = None) -> Membership:
    """Add (or refresh) ``url`` as a federation member; bumps the version
    when the member set actually changes.  Rejoin after leave/eviction
    allocates a FRESH slot — tags minted against the old incarnation stay
    fenced."""
    ts = time.time() if now is None else now

    def _fn(m: Membership) -> bool:
        if url in m.members:
            m.members[url]["heartbeat_at"] = ts
            return False
        m.members[url] = {"slot": m.next_slot, "joined_at": ts,
                          "heartbeat_at": ts}
        m.next_slot += 1
        return True

    return _update_membership(path, _fn)


def leave_membership(path: str, url: str) -> Membership:
    """Remove ``url`` from the federation (no-op when absent); drops any
    pins that targeted it."""
    def _fn(m: Membership) -> bool:
        if url not in m.members:
            return False
        del m.members[url]
        for q in [q for q, u in m.pins.items() if u == url]:
            del m.pins[q]
        return True

    return _update_membership(path, _fn)


def heartbeat_membership(path: str, url: str,
                         now: Optional[float] = None) -> Membership:
    """Refresh ``url``'s liveness timestamp.  NEVER bumps the version —
    heartbeats must not make every client rebuild its ring."""
    ts = time.time() if now is None else now

    def _fn(m: Membership) -> bool:
        if url in m.members:
            m.members[url]["heartbeat_at"] = ts
        return False

    return _update_membership(path, _fn)


def sweep_membership(path: str, ttl: float,
                     now: Optional[float] = None
                     ) -> Tuple[Membership, List[str]]:
    """Evict members whose heartbeat is older than ``ttl`` seconds (one
    version bump covers the whole sweep).  Members that never heartbeat
    (synthesized legacy entries, heartbeat_at == 0) are left alone —
    eviction is for members that were live and stopped."""
    ts = time.time() if now is None else now
    evicted: List[str] = []

    def _fn(m: Membership) -> bool:
        for url, meta in list(m.members.items()):
            hb = float(meta.get("heartbeat_at") or 0.0)
            if hb > 0.0 and ts - hb > ttl:
                del m.members[url]
                evicted.append(url)
        if evicted:
            for q in [q for q, u in m.pins.items() if u not in m.members]:
                del m.pins[q]
        return bool(evicted)

    return _update_membership(path, _fn), evicted


def pin_queue(path: str, queue: str, url: Optional[str]) -> Membership:
    """Set (url) or clear (None) a per-queue ownership override.  Pins
    win over the ring; a pin to a non-member is rejected."""
    def _fn(m: Membership) -> bool:
        if url is None:
            return m.pins.pop(queue, None) is not None
        if url not in m.members:
            raise ValueError(f"cannot pin {queue!r} to non-member {url!r}")
        if m.pins.get(queue) == url:
            return False
        m.pins[queue] = url
        return True

    return _update_membership(path, _fn)
