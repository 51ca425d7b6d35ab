"""Serving launchers of the port (after ``repro/launch/serve.py``).

LLM serving (batched prefill + decode on the card, with throughput and the
launches of each CUDA kernel):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch {jag-surrogate,granite-3-8b,phi4-mini-3.8b,gemma2-27b,
              deepseek-v2-lite-16b,arctic-480b,rwkv6-3b,zamba2-1.2b,
              whisper-tiny,llama-3.2-vision-11b,starcoder2-15b} \
      [--full] [--batch N] [--prompt-len N] [--new-tokens N] [--device cpu]

``--device cpu`` runs on the CPU through the plain versions of the kernels.
whisper-tiny and llama-3.2-vision-11b get the reference's stub-frontend
inputs, ``enc_embed`` / ``img_embed`` of zeros in bf16.  Without ``--full`` the config is the reduced one.  As in the reference
there is no flag for depth or cache dtype: ``--full`` is the published
depth (arctic-480b's ~54 GB of float32 weights a layer do not fit one
80 GB card).

The Merlin CLIs are the reference's, with the same flags and output:

  PYTHONPATH=src python -m repro_torch.launch.serve broker-serve \
      [--backend mem|file] [--root DIR] [--host H] [--port P] \
      [--port-file PATH] [--visibility-timeout S] [--fairness priority|weighted] \
      [--max-queue-depth N] [--queue-depth Q=N ...] [--put-timeout S] \
      [--shard-of I/N] [--announce PATH] [--codecs bin1,json] [--shm PATH] \
      [--join PATH]
  PYTHONPATH=src python -m repro_torch.launch.serve merlin-serve \
      --study DIR [--port-file PATH] [--members N] [--hidden N] [--steps N] \
      [--refresh-s S] [--naive] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve merlin-status \
      --broker URL [--watch S] [--json] [--ring]
  PYTHONPATH=src python -m repro_torch.launch.serve merlin-scale \
      --broker URL [--membership PATH] [--plan | --watch S] [--json]
  PYTHONPATH=src python -m repro_torch.launch.serve merlin-dlq \
      --broker URL list|show|requeue [--queue Q] [--json]
  PYTHONPATH=src python -m repro_torch.launch.serve merlin-validate \
      SPEC.yaml ... [--json]

``broker-serve`` (a standalone BrokerServer: the RabbitMQ stand-in of paper
Sec. 2-3; clients connect with ``MerlinRuntime(broker="tcp://host:port")``),
``merlin-status``, ``merlin-scale``, ``merlin-dlq`` and ``merlin-validate``
are host code and touch no device.  ``merlin-serve`` (the HTTP gateway over
a study's surrogate ensemble; ``REPRO_AUTH_TOKEN`` arms Bearer auth) trains
and predicts on the card unless ``--device cpu`` is given, and raises when
no card is visible.  The reference applies its JAX runtime settings
(``repro.env.configure``) at entry to ``broker-serve`` and ``merlin-serve``;
the port has none to apply.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from repro_torch.configs import registry


def broker_serve_main(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve broker-serve",
        description="Run a standalone broker server for remote "
                    "MerlinRuntime/WorkerPool processes.")
    ap.add_argument("--backend", choices=("mem", "file"), default="mem",
                    help="queue backend the server fronts")
    ap.add_argument("--root", default=None,
                    help="FileBroker directory (required for --backend file;"
                         " makes the queue itself crash-durable)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = pick a free one)")
    ap.add_argument("--port-file", default=None,
                    help="write the bound port here (atomic) once listening")
    ap.add_argument("--visibility-timeout", type=float, default=60.0)
    ap.add_argument("--fairness", choices=("priority", "weighted"),
                    default="priority")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="backpressure bound: puts against a queue holding "
                         "this many pending tasks block, then raise "
                         "BrokerFull (relayed to clients as a typed error)")
    ap.add_argument("--queue-depth", action="append", default=[],
                    metavar="QUEUE=N",
                    help="per-queue depth override (repeatable); takes "
                         "precedence over --max-queue-depth for that queue")
    ap.add_argument("--put-timeout", type=float, default=5.0,
                    help="seconds a put may block on a full queue before "
                         "BrokerFull (keep below the clients' request "
                         "grace, default 10s, or they see a timeout "
                         "instead of the structured error)")
    ap.add_argument("--shard-of", default=None, metavar="I/N",
                    help="label this server as shard I of an N-endpoint "
                         "federation (advisory: sharding is client-side "
                         "queue-hash routing via shard:// URLs)")
    ap.add_argument("--announce", default=None, metavar="PATH",
                    help="atomically publish the bound endpoint into this "
                         "shared discovery file; clients build the shard "
                         "list with make_broker('shard+file://PATH')")
    ap.add_argument("--codecs", default="bin1,json", metavar="C1,C2",
                    help="preference-ordered wire codecs offered at the "
                         "connection handshake (json is always the "
                         "compatibility floor; '--codecs json' emulates a "
                         "binary-unaware server)")
    ap.add_argument("--shm", default=None, metavar="PATH",
                    help="also serve same-host clients over shared-memory "
                         "channels registered at PATH "
                         "(make_broker('shm://PATH'))")
    ap.add_argument("--announce-host", default=None, metavar="HOST",
                    help="hostname to publish in the discovery file. "
                         "Default: --host, except the wildcard binds "
                         "(0.0.0.0/::) publish this machine's hostname — "
                         "a wildcard is not dialable.  A loopback --host "
                         "publishes loopback, which is correct: such a "
                         "server only accepts local connections anyway; "
                         "bind 0.0.0.0 (or set this flag) for "
                         "cross-node federations")
    ap.add_argument("--join", default=None, metavar="PATH",
                    help="join the elastic federation whose membership "
                         "registry lives at PATH: register this server, "
                         "pull the queues the new ring assigns to it from "
                         "their previous owners (live migration), "
                         "heartbeat until shutdown, then drain out and "
                         "leave.  Clients follow the registry with "
                         "make_broker('ring+file://PATH')")
    ap.add_argument("--membership-ttl", type=float, default=15.0,
                    metavar="S",
                    help="heartbeat TTL for --join: peers/sweepers evict "
                         "this member when its heartbeat is older than S "
                         "seconds (heartbeats are sent every S/3)")
    args = ap.parse_args(argv)

    queue_depths = {}
    for spec_s in args.queue_depth:
        try:
            q, _, n_s = spec_s.partition("=")
            queue_depths[q] = int(n_s)
        except ValueError:
            ap.error(f"--queue-depth must be QUEUE=N, got {spec_s!r}")

    shard_of = None
    if args.shard_of is not None:
        try:
            i_s, n_s = args.shard_of.split("/", 1)
            shard_of = (int(i_s), int(n_s))
            if not 0 <= shard_of[0] < shard_of[1]:
                raise ValueError(args.shard_of)
        except ValueError:
            ap.error(f"--shard-of must be I/N with 0 <= I < N, "
                     f"got {args.shard_of!r}")

    from repro_torch.core.netbroker import BrokerServer
    from repro_torch.core.queue import FileBroker, InMemoryBroker

    codecs = tuple(c for c in args.codecs.split(",") if c)
    kw = dict(visibility_timeout=args.visibility_timeout,
              fairness=args.fairness,
              max_queue_depth=args.max_queue_depth,
              put_timeout=args.put_timeout,
              queue_depths=queue_depths or None)
    if args.backend == "file":
        if not args.root:
            ap.error("--backend file requires --root DIR")
        backend = FileBroker(args.root, **kw)
    else:
        backend = InMemoryBroker(**kw)
    auth_token = os.environ.get("REPRO_AUTH_TOKEN")
    try:
        server = BrokerServer(backend, host=args.host, port=args.port,
                              codecs=codecs, shm_path=args.shm,
                              auth_token=auth_token)
    except ValueError as e:
        ap.error(str(e))  # e.g. a typo'd codec name
    server.start()
    print(json.dumps({"event": "listening", "host": args.host,
                      "port": server.port, "backend": args.backend,
                      "codecs": list(codecs), "shm": args.shm,
                      "auth": auth_token is not None,
                      "shard_of": None if shard_of is None
                      else f"{shard_of[0]}/{shard_of[1]}",
                      "max_queue_depth": args.max_queue_depth}),
          flush=True)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        os.rename(tmp, args.port_file)
    if args.announce:
        import socket as _socket
        from repro_torch.core.shardbroker import announce_endpoint
        host = args.announce_host or args.host
        if host in ("0.0.0.0", "::", ""):
            # the wildcard bind address is not a connectable endpoint;
            # publish something peers can actually dial
            host = _socket.gethostname()
        announce_endpoint(args.announce, f"tcp://{host}:{server.port}",
                          index=None if shard_of is None else shard_of[0],
                          total=None if shard_of is None else shard_of[1])
    join_url, hb_stop, hb_thread = None, None, None
    if args.join:
        import socket as _socket
        import threading as _threading
        from repro_torch.core.hashring import heartbeat_membership
        from repro_torch.core.shardbroker import join_federation
        host = args.announce_host or args.host
        if host in ("0.0.0.0", "::", ""):
            host = _socket.gethostname()
        join_url = f"tcp://{host}:{server.port}"
        res = join_federation(args.join, join_url)
        print(json.dumps({"event": "joined", "membership": args.join,
                          "url": join_url, "version": res["version"],
                          "queues_pulled": len(res["moved"])}),
              flush=True)
        hb_stop = _threading.Event()
        hb_period = max(args.membership_ttl / 3.0, 0.2)

        def _heartbeat_loop():
            while not hb_stop.wait(hb_period):
                try:
                    heartbeat_membership(args.join, join_url)
                except OSError:
                    pass  # registry briefly unwritable; retry next beat

        hb_thread = _threading.Thread(target=_heartbeat_loop, daemon=True,
                                      name="membership-heartbeat")
        hb_thread.start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if join_url is not None:
            hb_stop.set()
            hb_thread.join(timeout=2.0)
            # drain our queues to the surviving members BEFORE stopping
            # the server (the migration pulls through our own endpoint);
            # an unclean death instead relies on heartbeat-TTL eviction +
            # a replacement adopting the durable root
            from repro_torch.core.shardbroker import leave_federation
            try:
                res = leave_federation(args.join, join_url)
                print(json.dumps({"event": "left",
                                  "membership": args.join,
                                  "version": res["version"],
                                  "queues_drained": len(res["moved"])}),
                      flush=True)
            except Exception as e:
                print(json.dumps({"event": "leave-failed",
                                  "error": str(e)}), flush=True)
        server.stop()


def status_snapshot(broker) -> dict:
    """One consistent-ish view of a broker: per-queue depth, in-flight
    leases, and live consumers (heartbeat registry), plus the counter
    totals.  Works against any Broker — local, NetBroker, ShardedBroker —
    because it only uses protocol ops."""
    stats = dict(broker.stats)
    consumers = dict(stats.pop("consumers", None) or {})
    inflight_by_q: dict = {}
    for task, _age in broker.inflight_tasks():
        inflight_by_q[task.queue] = inflight_by_q.get(task.queue, 0) + 1
    queues = sorted(set(broker.queue_names())
                    | set(inflight_by_q)
                    | {q for q in consumers if q != "*"})
    rows = {q: {"depth": broker.qsize((q,)),
                "inflight": inflight_by_q.get(q, 0),
                "consumers": consumers.get(q, 0)} for q in queues}
    snap = {
        "queues": rows,
        "totals": {"depth": sum(r["depth"] for r in rows.values()),
                   "inflight": sum(r["inflight"] for r in rows.values())},
        # "*"-subscribed consumers (no named queues) can drain anything
        "wildcard_consumers": consumers.get("*", 0),
        "counters": {k: v for k, v in stats.items()
                     if isinstance(v, (int, float))},
        # per-queue ack totals: the watch loop differences consecutive
        # snapshots into tasks/s
        "acked_by_queue": {q: int(c) for q, c
                           in (stats.get("acked_by_queue") or {}).items()
                           if isinstance(c, (int, float))},
    }
    # federation health: per-shard epoch + replica liveness (failover view)
    shard_health = getattr(broker, "shard_health", None)
    if shard_health is not None:
        snap["shards"] = shard_health()
    return snap


def _render_status(snap: dict, broker_url: str) -> str:
    rates = (snap.get("rates") or {}).get("tasks_per_s")
    lines = [f"broker {broker_url}"]
    header = f"{'queue':<24} {'depth':>8} {'inflight':>9} {'consumers':>10}"
    if rates is not None:
        header += f" {'tasks/s':>9}"
    lines.append(header)
    lines.append("-" * len(header))
    qnames = sorted(set(snap["queues"]) | set(rates or {}))
    for q in qnames:
        r = snap["queues"].get(q, {"depth": 0, "inflight": 0, "consumers": 0})
        row = (f"{q:<24} {r['depth']:>8} {r['inflight']:>9} "
               f"{r['consumers']:>10}")
        if rates is not None:
            row += f" {rates.get(q, 0.0):>9.1f}"
        lines.append(row)
    if not qnames:
        lines.append("(no queues)")
    t = snap["totals"]
    total = (f"{'TOTAL':<24} {t['depth']:>8} {t['inflight']:>9} "
             f"{snap['wildcard_consumers']:>9}*")
    if rates is not None:
        total += f" {snap['rates']['total_tasks_per_s']:>9.1f}"
    lines.append(total)
    c = snap["counters"]
    lines.append("counters: " + ", ".join(
        f"{k}={c[k]}" for k in sorted(c)))
    for sh in snap.get("shards", ()):
        cands = ", ".join(
            f"{'*' if ce['active'] else ''}{ce['endpoint']}"
            f"[{'up' if ce['alive'] else 'DOWN'}]"
            for ce in sh["candidates"])
        lines.append(f"shard {sh['shard']} epoch {sh['epoch']}: {cands}")
    return "\n".join(lines)


def watch_rates(prev: Optional[dict], prev_t: float, snap: dict,
                now: float) -> Optional[dict]:
    """Per-queue throughput between two snapshots: difference the
    ``acked_by_queue`` counters and divide by the wall-clock interval.
    None on the first poll (no history yet).  Negative deltas (a broker
    restart reset its counters) clamp to zero rather than reporting
    nonsense."""
    if prev is None:
        return None
    dt = max(now - prev_t, 1e-9)
    cur = snap.get("acked_by_queue") or {}
    old = prev.get("acked_by_queue") or {}
    per_q = {q: max(0, cur.get(q, 0) - old.get(q, 0)) / dt
             for q in sorted(set(cur) | set(old))}
    return {"interval_s": round(dt, 3),
            "tasks_per_s": {q: round(r, 2) for q, r in per_q.items()},
            "total_tasks_per_s": round(sum(per_q.values()), 2)}


def _render_ring(info: dict, broker_url: str) -> str:
    """The ``merlin-status --ring`` table: membership version, per-member
    owned-queue counts, in-flight migrations, candidate health."""
    mode = "elastic" if info.get("elastic") else "static"
    lines = [f"broker {broker_url}",
             f"ring version {info['version']} ({mode}, "
             f"vnodes={info['vnodes']})"]
    header = (f"{'slot':>4} {'member':<28} {'epoch':>5} {'queues':>7} "
              f"{'migrating':<18} candidates")
    lines.append(header)
    lines.append("-" * len(header))
    for m in info.get("members", ()):
        cands = ", ".join(
            f"{'*' if c['active'] else ''}{c['endpoint']}"
            f"[{'up' if c['alive'] else 'DOWN'}]"
            for c in m.get("candidates", ()))
        mig = ",".join(m.get("migrating", ())) or "-"
        lines.append(f"{m['slot']:>4} {m['member']:<28} {m['epoch']:>5} "
                     f"{m['queues_owned']:>7} {mig:<18} {cands}")
    if not info.get("members"):
        lines.append("(no members)")
    if info.get("pins"):
        lines.append("pins: " + ", ".join(
            f"{q}->{u}" for q, u in sorted(info["pins"].items())))
    if info.get("queue_pins"):
        lines.append("index pins: " + ", ".join(
            f"{q}->{i}" for q, i in sorted(info["queue_pins"].items())))
    if info.get("retired_slots"):
        lines.append("retired slots: " + ", ".join(
            f"{s} ({u})" for s, u in sorted(info["retired_slots"].items())))
    return "\n".join(lines)


def merlin_status_main(argv=None):
    """``merlin-status``: the ROADMAP's 'surface consumers in a CLI' item —
    one-shot (or --watch) per-queue depth/inflight/consumers against any
    broker URL.  --watch keeps history between polls and adds a per-queue
    throughput column from the acked-counter deltas."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve merlin-status",
        description="Show per-queue depth, in-flight leases, and live "
                    "consumers for a broker.")
    ap.add_argument("--broker", required=True,
                    help="broker URL: tcp://host:port, file://dir, "
                         "shard://h:p,h:p, or shard+file://announce-path")
    ap.add_argument("--watch", type=float, default=None, metavar="S",
                    help="refresh every S seconds until interrupted; each "
                         "refresh reports tasks/s per queue since the "
                         "previous poll")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of the table "
                         "(with --watch: a stream, one object per line)")
    ap.add_argument("--ring", action="store_true",
                    help="show the elastic-federation view instead: "
                         "membership version, per-member owned-queue "
                         "counts, migrating queues, candidate health "
                         "(sharded broker URLs only)")
    args = ap.parse_args(argv)

    import time as _time
    from repro_torch.core.netbroker import make_broker
    broker = make_broker(args.broker)
    if args.ring and not hasattr(broker, "ring_info"):
        ap.error(f"--ring needs a sharded broker URL (shard://, "
                 f"shard+file://, ring+file://), got {args.broker!r}")
    prev, prev_t = None, 0.0
    try:
        while True:
            if args.ring:
                info = broker.ring_info()
                if args.json:
                    print(json.dumps({"broker": args.broker, **info}),
                          flush=True)
                else:
                    print(_render_ring(info, args.broker), flush=True)
                if args.watch is None:
                    return
                _time.sleep(args.watch)
                if not args.json:
                    print()
                continue
            snap = status_snapshot(broker)
            now = _time.monotonic()
            rates = watch_rates(prev, prev_t, snap, now)
            if rates is not None:
                snap["rates"] = rates
            prev, prev_t = snap, now
            if args.json:
                print(json.dumps({"broker": args.broker, **snap}),
                      flush=True)
            else:
                print(_render_status(snap, args.broker), flush=True)
            if args.watch is None:
                return
            _time.sleep(args.watch)
            if not args.json:
                print()
    except KeyboardInterrupt:
        pass
    finally:
        close = getattr(broker, "close", None)
        if close is not None:
            close()


def _render_plan(plan) -> str:
    o = plan.observed
    lines = [f"depth {o['depth']}  inflight {o['inflight']}  "
             f"consumers {o['consumers']}  managed workers "
             f"{o['managed_workers']} ({o['pools']} pool(s))  "
             f"backlog/worker {o.get('backlog_per_worker', 0)}"]
    if o.get("members") is not None:
        lines[0] += (f"  members {o['members']} "
                     f"(ring v{o.get('ring_version', '?')})")
    for a in plan.actions:
        lines.append(f"  action: {a.kind} n={a.n} — {a.reason}")
    for a in plan.recommendations:
        lines.append(f"  recommend: {a.kind} — {a.reason}")
    for a in o.get("applied", ()):
        lines.append(f"  applied: {a['kind']} n={a['n']}")
    if o.get("evicted_members"):
        lines.append("  evicted: " + ", ".join(o["evicted_members"]))
    if not plan.actions and not plan.recommendations:
        lines.append("  steady (no action)")
    return "\n".join(lines)


def merlin_scale_main(argv=None):
    """``merlin-scale``: the autoscaler policy loop as a CLI.  ``--plan``
    (default) samples the broker once and prints what the policy would
    do; ``--watch S`` runs plan-then-apply every S seconds — scaling a
    set of local :class:`~repro_torch.core.worker.WorkerPool`\\ s attached to
    ``--broker`` up and down, sweeping heartbeat-dead members out of the
    ``--membership`` registry, and printing shard join/leave
    recommendations for the operator to act on (``broker-serve
    --join``)."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve merlin-scale",
        description="Plan or apply stats-driven autoscaling against a "
                    "broker (worker pools + shard recommendations).")
    ap.add_argument("--broker", required=True,
                    help="broker URL: tcp://host:port, file://dir, "
                         "shard://..., shard+file:// or ring+file://PATH")
    ap.add_argument("--membership", default=None, metavar="PATH",
                    help="federation membership file: apply mode evicts "
                         "heartbeat-expired members; plan mode sizes "
                         "shard recommendations against the member count")
    ap.add_argument("--plan", action="store_true",
                    help="one-shot: print the plan, change nothing "
                         "(default when --watch is absent)")
    ap.add_argument("--watch", type=float, default=None, metavar="S",
                    help="apply loop: plan-then-apply every S seconds "
                         "until interrupted")
    ap.add_argument("--workspace", default="/tmp/merlin-scale",
                    help="runtime workspace for worker pools started in "
                         "apply mode")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable plans, one object per line")
    pol = ap.add_argument_group("policy knobs")
    pol.add_argument("--up-backlog", type=float, default=8.0,
                     help="scale up above this many pending tasks per "
                          "worker (default 8)")
    pol.add_argument("--pool-size", type=int, default=2,
                     help="workers per scale-up increment (default 2)")
    pol.add_argument("--min-workers", type=int, default=0)
    pol.add_argument("--max-workers", type=int, default=16)
    pol.add_argument("--down-idle", type=float, default=10.0, metavar="S",
                     help="retire a pool after this long continuously "
                          "idle (default 10s)")
    pol.add_argument("--cooldown", type=float, default=5.0, metavar="S",
                     help="minimum spacing between applied worker "
                          "actions (default 5s)")
    pol.add_argument("--shard-up-depth", type=int, default=5000,
                     help="recommend joining a shard above this total "
                          "backlog (default 5000)")
    pol.add_argument("--shard-down-depth", type=int, default=0,
                     help="recommend draining a shard at/below this "
                          "total backlog (default 0)")
    pol.add_argument("--membership-ttl", type=float, default=15.0,
                     help="evict members with heartbeats older than this "
                          "when sweeping --membership (default 15s)")
    args = ap.parse_args(argv)
    if args.plan and args.watch is not None:
        ap.error("--plan and --watch are mutually exclusive")

    import time as _time
    from repro_torch.core.autoscale import Autoscaler, AutoscalePolicy
    from repro_torch.core.netbroker import make_broker
    policy = AutoscalePolicy(
        up_backlog_per_worker=args.up_backlog, pool_size=args.pool_size,
        min_workers=args.min_workers, max_workers=args.max_workers,
        down_idle_s=args.down_idle, cooldown_s=args.cooldown,
        shard_up_depth=args.shard_up_depth,
        shard_down_depth=args.shard_down_depth,
        membership_ttl=args.membership_ttl)

    apply_mode = args.watch is not None
    runtime = None
    if apply_mode:
        # pools need a runtime to execute against; it shares the broker
        from repro_torch.core.runtime import MerlinRuntime
        from repro_torch.core.worker import WorkerPool
        runtime = MerlinRuntime(broker=args.broker,
                                workspace=args.workspace)
        broker = runtime.broker

        def pool_factory(n):
            return WorkerPool(runtime, n_workers=n)

        def engine_stats():
            eng = runtime._engine
            return dict(eng.stats) if eng is not None else {}
    else:
        broker = make_broker(args.broker)
        pool_factory = None
        engine_stats = None

    scaler = Autoscaler(broker, policy, pool_factory=pool_factory,
                        membership_path=args.membership,
                        engine_stats=engine_stats)
    try:
        while True:
            plan = scaler.step() if apply_mode else scaler.plan()
            if args.json:
                print(json.dumps(plan.to_doc()), flush=True)
            else:
                print(_render_plan(plan), flush=True)
            if not apply_mode:
                return 0
            _time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0
    finally:
        scaler.shutdown()
        close = getattr(broker, "close", None)
        if close is not None:
            close()


def merlin_dlq_main(argv=None):
    """``merlin-dlq``: inspect and drain dead-letter queues.

    ``list`` shows every ``dlq.*`` queue with its depth; ``show`` leases
    the parked tasks, prints them, and releases them back (their
    redelivery count ticks up — the broker protocol has no peek);
    ``requeue`` feeds each task back to its original queue with a fresh
    retry budget, putting BEFORE acking the DLQ lease so a crash
    mid-requeue duplicates (harmless, once-markers) instead of losing."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve merlin-dlq",
        description="List, inspect, or requeue dead-lettered tasks.")
    ap.add_argument("--broker", required=True,
                    help="broker URL: tcp://host:port, file://dir, "
                         "shard://..., or shard+file://announce-path")
    ap.add_argument("action", choices=("list", "show", "requeue"))
    ap.add_argument("--queue", default=None,
                    help="operate on one original queue (its dlq.<queue>); "
                         "default: every dlq.* queue the broker reports")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output, one object per line")
    args = ap.parse_args(argv)

    from repro_torch.core.netbroker import make_broker
    from repro_torch.core.queue import (Task, dlq_queue_name, is_dlq,
                                  original_queue)
    broker = make_broker(args.broker)
    try:
        if args.queue is not None:
            dlqs = [dlq_queue_name(args.queue)]
        else:
            dlqs = sorted(q for q in broker.queue_names() if is_dlq(q))

        if args.action == "list":
            rows = [{"queue": q, "original": original_queue(q),
                     "depth": broker.qsize((q,))} for q in dlqs]
            if args.json:
                for r in rows:
                    print(json.dumps(r), flush=True)
            elif not rows:
                print("(no dead-letter queues)")
            else:
                for r in rows:
                    print(f"{r['queue']:<28} {r['depth']:>6} task(s) "
                          f"-> {r['original']}")
            return 0

        n_seen = 0
        for q in dlqs:
            # hold every lease until the queue is drained — nacking
            # mid-drain would make the same task visible again and spin
            held = []
            while True:
                leases = broker.get_many(64, timeout=0.2, queues=(q,))
                if not leases:
                    break
                for lease in leases:
                    t = lease.task
                    n_seen += 1
                    if args.action == "requeue":
                        # fresh retry budget; put-then-ack so a crash here
                        # duplicates instead of losing the task
                        broker.put(Task(id=t.id, kind=t.kind,
                                        payload=dict(t.payload),
                                        priority=t.priority,
                                        queue=original_queue(t.queue)))
                        broker.ack(lease.tag)
                    else:
                        held.append(lease)
                    info = {"queue": q, "id": t.id, "kind": t.kind,
                            "retries": t.retries,
                            "study": t.payload.get("study")
                            if isinstance(t.payload, dict) else None,
                            "requeued": args.action == "requeue"}
                    if args.json:
                        print(json.dumps(info), flush=True)
                    else:
                        verb = "requeued" if args.action == "requeue" \
                            else "parked"
                        print(f"{verb} {t.id} ({t.kind}, retries="
                              f"{t.retries}) {q} -> "
                              f"{original_queue(q)}")
            # release the inspection leases (no peek in the protocol;
            # their redelivery count ticks up)
            for lease in held:
                broker.nack(lease.tag)
        if not args.json:
            verb = "requeued" if args.action == "requeue" else "shown"
            print(f"{n_seen} task(s) {verb}")
        return 0
    finally:
        close = getattr(broker, "close", None)
        if close is not None:
            close()


def merlin_validate_main(argv=None):
    """``merlin-validate``: load each workflow spec and compile it into its
    task DAG, surfacing structural errors (cycles, unknown dependencies,
    unequal %zip lists, unsatisfiable edges) without executing anything.
    Exit status 1 if any spec fails — CI gates on it."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve merlin-validate",
        description="Validate workflow spec files by compiling them into "
                    "task DAGs.")
    ap.add_argument("specs", nargs="+", metavar="SPEC.yaml",
                    help="YAML workflow spec files to validate")
    ap.add_argument("--json", action="store_true",
                    help="one JSON result object per spec")
    args = ap.parse_args(argv)

    from repro_torch.core.dag import compile_dag
    from repro_torch.core.spec import SpecError, StudySpec
    failures = 0
    for path in args.specs:
        try:
            with open(path) as f:
                spec = StudySpec.from_yaml(f.read())
            dag = compile_dag(spec)
            info = {"spec": path, "ok": True, "name": spec.name,
                    "nodes": [n.name for n in dag.nodes],
                    "instances": len(list(dag.all_instances()))}
        except (OSError, SpecError, ValueError) as e:
            failures += 1
            info = {"spec": path, "ok": False, "error": str(e)}
        if args.json:
            print(json.dumps(info), flush=True)
        elif info["ok"]:
            print(f"OK   {path}: {info['name']} — "
                  f"{len(info['nodes'])} node(s) "
                  f"[{', '.join(info['nodes'])}], "
                  f"{info['instances']} instance(s)")
        else:
            print(f"FAIL {path}: {info['error']}")
    return 1 if failures else 0


def merlin_serve_main(argv=None):
    """``merlin-serve``: HTTP gateway over a study's surrogate ensemble.

    Trains a resident snapshot from the study archive's bundled rows,
    then serves predict/calibrate/what-if with continuous batching
    (see repro_torch/serve/gateway.py).  SIGINT/SIGTERM triggers a graceful
    drain: new requests get 503, admitted requests complete.
    """
    ap = argparse.ArgumentParser(prog="merlin-serve")
    ap.add_argument("--study", required=True, metavar="DIR",
                    help="study archive root (the Bundler directory "
                         "holding the training bundles)")
    ap.add_argument("--objective-key", default="yield")
    ap.add_argument("--input-key", default="inputs")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (published via --port-file)")
    ap.add_argument("--port-file", default=None,
                    help="atomically publish the bound port to this path")
    ap.add_argument("--max-inflight", type=int, default=64,
                    help="admission queue bound; requests beyond it are "
                         "shed with 429 before admission")
    ap.add_argument("--max-batch-rows", type=int, default=256)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request deadline (504 when it "
                         "passes while queued); requests can override")
    ap.add_argument("--members", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--refresh-s", type=float, default=None,
                    help="poll the archive for new rows every S seconds "
                         "and fold them into the snapshot")
    ap.add_argument("--naive", action="store_true",
                    help="flush-per-request baseline mode (benchmark A/B)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the snapshot trains and predicts")
    args = ap.parse_args(argv)

    from repro_torch import env
    device = env.device(args.device)  # raises before any work without a card

    import signal
    import threading
    from repro_torch.core.active import SurrogateSnapshot
    from repro_torch.serve.gateway import SurrogateGateway

    try:
        snap = SurrogateSnapshot(args.study,
                                 objective_key=args.objective_key,
                                 input_key=args.input_key,
                                 n_members=args.members,
                                 hidden=args.hidden, steps=args.steps,
                                 device=device)
    except ValueError as e:
        ap.error(str(e))  # e.g. archive has no training rows yet
    gw = SurrogateGateway(snap, host=args.host, port=args.port,
                          max_inflight=args.max_inflight,
                          max_batch_rows=args.max_batch_rows,
                          default_deadline_ms=args.deadline_ms,
                          refresh_s=args.refresh_s,
                          naive=args.naive).start()
    print(json.dumps({"event": "listening", "host": args.host,
                      "port": gw.port, "study": args.study,
                      "device": env.device_name(device),
                      "rows": snap.rows, "version": snap.version,
                      "mode": "naive" if args.naive else "continuous",
                      "auth": gw.auth_token is not None}), flush=True)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(gw.port))
        os.rename(tmp, args.port_file)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        drained = gw.stop(drain=True)
        print(json.dumps({"event": "drained", "clean": bool(drained),
                          "stats": gw.stats()}), flush=True)
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "merlin-serve":
        return merlin_serve_main(argv[1:])
    if argv and argv[0] == "broker-serve":
        return broker_serve_main(argv[1:])
    if argv and argv[0] == "merlin-status":
        return merlin_status_main(argv[1:])
    if argv and argv[0] == "merlin-validate":
        return merlin_validate_main(argv[1:])
    if argv and argv[0] == "merlin-dlq":
        return merlin_dlq_main(argv[1:])
    if argv and argv[0] == "merlin-scale":
        return merlin_scale_main(argv[1:])
    return llm_serve_main(argv)


def llm_serve_main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="granite-3-8b",
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import env
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ssd_scan as ssdk
    from repro_torch.kernels import wkv6_scan as wkvk
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, extra_shapes

    dev = env.device(args.device)
    cfg = (registry.reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.new_tokens + 8)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    # the stub frontends' inputs, as the reference passes them
    extra = {k: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
             for k, shape in extra_shapes(cfg, args.batch).items()}
    kernels = {"flash_launches": fak, "wkv6_launches": wkvk,
               "ssd_launches": ssdk}
    launches0 = {name: mod.launches for name, mod in kernels.items()}
    out = eng.generate(toks, args.new_tokens, extra=extra)
    s = eng.stats
    print(json.dumps({
        "arch": cfg.arch_id, "batch": args.batch,
        "prefill_tok_per_s": round(s["prefill_tokens"] / max(s["prefill_s"], 1e-9)),
        "decode_tok_per_s": round(s["decode_tokens"] / max(s["decode_s"], 1e-9)),
        "generated_shape": list(out.shape),
        "device": env.device_name(dev),
        **{name: mod.launches - launches0[name]
           for name, mod in kernels.items()},
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
