"""The port's networked brokers against the reference's, on the CPU.

* Wire compatibility both ways: a port ``NetBroker`` against a reference
  ``BrokerServer``, and a reference client against a port server, in both
  codecs (``json`` and ``bin1``).  One scripted session of put, get, ack,
  nack, a lease that expires and is redelivered, and a dead-lettered task
  must show the same sequence of (op, task, queue, retries) as the
  reference client against the reference server.
* Placement: the hash ring places 1,000 queue names on the same members,
  ``shard_index`` and ``ShardedBroker.shard_for`` route them the same.
* The ``Autoscaler`` plans the same from the same observations (one broker
  state, one clock), and ``ChaosBroker`` injects the same faults in the
  same order from the same seed.

The reference's own broker cases run against the port in the
``test_torch_ref_*.py`` files."""
import time

import pytest

from repro.core import autoscale as AS_ref
from repro.core import chaos as CH_ref
from repro.core import hashring as HR_ref
from repro.core import netbroker as NB_ref
from repro.core import queue as Q_ref
from repro.core import shardbroker as SB_ref
from repro_torch.core import autoscale as AS
from repro_torch.core import chaos as CH
from repro_torch.core import hashring as HR
from repro_torch.core import netbroker as NB
from repro_torch.core import queue as Q
from repro_torch.core import shardbroker as SB

PORT = {"nb": NB, "q": Q}
REF = {"nb": NB_ref, "q": Q_ref}
VT = 0.3  # the server's visibility timeout for the expiry step


def _session(client_pkg, server_pkg, codec):
    """One scripted session over localhost TCP; returns what it saw."""
    backend = server_pkg["q"].InMemoryBroker(visibility_timeout=VT)
    srv = server_pkg["nb"].BrokerServer(backend).start()
    Task = client_pkg["q"].Task
    cli = client_pkg["nb"].NetBroker(srv.address, codec=codec,
                                     connect_timeout=5.0,
                                     reconnect_timeout=5.0)
    seen = []

    def note(op, lease):
        t = lease.task
        seen.append((op, t.id, t.kind, t.queue, t.retries,
                     dict(t.payload)))

    try:
        cli.put_many([Task(id=f"t{i}", kind="real", payload={"i": i},
                           queue="sims") for i in range(4)])
        cli.put(Task(id="g0", kind="gen", payload={"lo": 0, "hi": 8},
                     queue="gen"))
        seen.append(("qsize", cli.qsize(("sims",)), cli.qsize(("gen",))))
        seen.append(("queues", sorted(cli.queue_names())))
        first = cli.get_many(2, timeout=2.0, queues=("sims",))
        for lease in first:
            note("get", lease)
        cli.ack(first[0].tag)
        cli.nack(first[1].tag)       # back with retries + 1
        again = cli.get_many(4, timeout=2.0, queues=("sims",))
        for lease in again:
            note("get", lease)
        by_id = {lease.task.id: lease for lease in again}
        cli.ack_many([by_id[k].tag for k in sorted(by_id) if k != "t2"])
        # t2's lease is left to expire: the server redelivers it
        time.sleep(VT + 0.2)
        late = cli.get(timeout=5.0, queues=("sims",))
        note("redelivered", late)
        # dead-letter it: put on dlq.<queue>, then ack the lease
        t = late.task
        cli.put(Task(id=t.id, kind=t.kind, payload=dict(t.payload),
                     priority=t.priority,
                     queue=client_pkg["q"].dlq_queue_name(t.queue),
                     retries=t.retries))
        cli.ack(late.tag)
        seen.append(("queues", sorted(cli.queue_names())))
        parked = cli.get(timeout=2.0, queues=("dlq.sims",))
        note("dlq", parked)
        cli.ack(parked.tag)
        gen = cli.get(timeout=2.0, queues=("gen",))
        note("get", gen)
        cli.ack(gen.tag)
        seen.append(("idle", cli.qsize(), cli.inflight(), cli.idle()))
    finally:
        cli.close()
        srv.stop()
    return seen


@pytest.mark.net
@pytest.mark.parametrize("codec", ["json", "bin1"])
def test_wire_compatible_both_ways(codec):
    want = _session(REF, REF, codec)
    assert [s[0] for s in want].count("get") == 6
    assert ("redelivered", "t2", "real", "sims", 1, {"i": 2}) in want
    assert _session(PORT, REF, codec) == want
    assert _session(REF, PORT, codec) == want
    assert _session(PORT, PORT, codec) == want


QUEUES = [f"queue-{i:04d}" for i in range(1000)]


def test_ring_places_queue_names_as_the_reference():
    members = [f"tcp://10.0.0.{i}:7000" for i in range(5)]
    ring, ring_ref = HR.HashRing(members), HR_ref.HashRing(members)
    assert ring.owners(QUEUES) == ring_ref.owners(QUEUES)
    assert ring.spread(QUEUES) == ring_ref.spread(QUEUES)
    smaller = [m for m in members if m != members[2]]
    assert HR.moved_keys(ring, HR.HashRing(smaller), QUEUES) == \
        HR_ref.moved_keys(ring_ref, HR_ref.HashRing(smaller), QUEUES)


@pytest.mark.shard
def test_sharded_broker_routes_as_the_reference():
    for n in (2, 3, 5):
        assert [SB.shard_index(q, n) for q in QUEUES] == \
            [SB_ref.shard_index(q, n) for q in QUEUES]
        sb = SB.ShardedBroker([Q.InMemoryBroker() for _ in range(n)],
                              queue_shards={"pinned": n - 1})
        sb_ref = SB_ref.ShardedBroker(
            [Q_ref.InMemoryBroker() for _ in range(n)],
            queue_shards={"pinned": n - 1})
        names = QUEUES + ["pinned"]
        assert [sb.shard_for(q) for q in names] == \
            [sb_ref.shard_for(q) for q in names]


def _scaler(as_mod, q_mod, depth, inflight, policy_kw):
    b = q_mod.InMemoryBroker()
    b.put_many([q_mod.new_task("real", {"i": i}, queue=f"q{i % 3}")
                for i in range(depth)])
    for _ in range(inflight):
        b.get(timeout=0)
    now = [100.0]
    pools = []

    class _Pool:
        def __init__(self, n):
            self.n = n
            pools.append(n)

        def shutdown(self):
            pass

    s = as_mod.Autoscaler(b, as_mod.AutoscalePolicy(**policy_kw),
                          pool_factory=_Pool, clock=lambda: now[0])
    return s, now, pools


@pytest.mark.elastic
@pytest.mark.parametrize("depth,inflight,policy_kw", [
    (30, 0, {"up_backlog_per_worker": 4, "shard_up_depth": 10}),
    (0, 0, {"min_workers": 2}),
    (100, 5, {"pool_size": 3, "max_workers": 5, "cooldown_s": 1.0}),
])
def test_autoscaler_plans_as_the_reference(depth, inflight, policy_kw):
    """Plans from one broker state and one clock, then three steps with
    the clock moving: the same plans, the same pools started."""
    s, now, pools = _scaler(AS, Q, depth, inflight, policy_kw)
    r, now_r, pools_r = _scaler(AS_ref, Q_ref, depth, inflight, policy_kw)
    assert s.plan().to_doc() == r.plan().to_doc()
    for t in (100.0, 102.0, 130.0):
        now[0] = now_r[0] = t
        assert s.step().to_doc() == r.step().to_doc()
    assert pools == pools_r
    s.shutdown()
    r.shutdown()


def _chaos_trace(ch_mod, q_mod, seed):
    """A fixed sequence of data-plane ops through a ChaosBroker: which of
    them failed, which leases were lost and which acks dropped."""
    inner = q_mod.InMemoryBroker(visibility_timeout=30.0)
    cb = ch_mod.ChaosBroker(inner, seed=seed, p_error=0.2, p_delay=0.2,
                            max_delay_s=0.001, p_drop_ack=0.25,
                            p_lose_lease=0.25)
    trace = []
    for i in range(60):
        try:
            cb.put(q_mod.new_task("real", {"i": i}, queue="sims"))
            trace.append(("put", i))
        except q_mod.BrokerUnavailable as e:
            trace.append(("put-error", i, type(e).__name__))
        if i % 3:
            continue
        try:
            leases = cb.get_many(2, timeout=0)
        except q_mod.BrokerUnavailable as e:
            trace.append(("get-error", type(e).__name__))
            continue
        for lease in leases:
            trace.append(("got", lease.task.payload["i"]))
            try:
                cb.ack(lease.tag)
            except q_mod.BrokerUnavailable as e:
                trace.append(("ack-error", type(e).__name__))
    trace.append(("faults", dict(cb.faults)))
    trace.append(("left", inner.qsize(), inner.inflight()))
    return trace


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_chaos_schedule_as_the_reference(seed):
    got, want = _chaos_trace(CH, Q, seed), _chaos_trace(CH_ref, Q_ref, seed)
    assert got == want
    faults = want[-2][1]
    assert faults["errors"] and faults["dropped_acks"] and \
        faults["lost_leases"]
