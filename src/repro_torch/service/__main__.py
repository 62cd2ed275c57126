"""``python -m repro_torch.service`` - serve a deterministic mixed burst.

Starts a RandServer on the card (``--device cpu`` for the plain torch
path on the CPU), fires ``--burst`` mixed (shape, sampler, dtype)
requests from ``--tenants`` distinct tenants, prints serving stats
(requests/s, p50/p99 latency, coalescing factor) and an
order-independent response digest, then drains gracefully.

  PYTHONPATH=src python -m repro_torch.service --burst 1024 \\
      --tenants 1024 --journal rand.jsonl --verify-replay

``--verify-replay`` re-reads the journal in a FRESH server context and
asserts byte-identical regeneration; ``--linger`` keeps the server up
after the burst until SIGINT/SIGTERM, either of which triggers the
graceful drain.

``--fleet N`` runs the same burst against an N-shard subprocess fleet
(``repro_torch.service.fleet``, every shard on ``--device``) over the
socket transport instead of an in-process server; ``--fault-plan``
scripts the adversary:

  PYTHONPATH=src python -m repro_torch.service --fleet 2 --burst 1024 \\
      --tenants 256 --journal-dir fleet --fault-plan kill@512

Shards coalesce (``--fleet-max-batch``), keep standing producer pools
(``--fleet-hot``), and speak binary v2 wire frames to a pipelined
client (``--pipeline-depth``) — yet the printed digest is identical
with and without the fault plan, because each shard's microbatch
composition is journaled atomically before responses release and the
client resubmits unanswered requests in original order.  Against the
JAX reference (``python -m repro.service``) the integer and threshold
classes' responses are equal bit for bit and the log-based classes'
within 8 ULP, so the whole-burst digest is compared within one package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from repro_torch.service import audit
from repro_torch.service.burst import make_requests, run_burst
from repro_torch.service.server import (RandServer, ServerConfig,
                                        drain_signal_event)


def _shard_stats(client) -> dict:
    """Aggregate serving-side counters (engine calls, pool hits) over
    every live shard owner, through each shard's ``stats`` op."""
    from repro_torch.service import transport

    engine = leases = served = pooled = 0
    for logical, proc in sorted(client._owner.items()):
        try:
            reply = transport.rpc(client.addresses[proc],
                                  {"op": "stats", "shard": logical},
                                  timeout=10.0)
        except (OSError, transport.TransportError):
            continue                # fenced/dead owner: skip
        if not reply.get("ok"):
            continue
        s = reply["stats"]
        engine += s.get("engine_calls", 0)
        leases += s.get("lease_calls", 0)
        served += s.get("requests_served", 0)
        pooled += s.get("pool_requests", 0)
    return {
        "engine_calls": engine,
        "lease_calls": leases,
        "requests_served": served,
        "coalesce_calls_per_req": ((engine + leases) / served
                                   if served else 0.0),
        "pool_hit_rate": (pooled / served if served else 0.0),
    }


def _run_fleet(args) -> int:
    """The ``--fleet N`` path: subprocess shards, socket transport,
    scripted faults, digest + optional union replay over the shard
    journals."""
    from repro_torch.runtime.fault import FaultPlan
    from repro_torch.service.fleet import Fleet, FleetConfig, run_fleet_burst

    plan = FaultPlan.parse(args.fault_plan)
    hot = tuple(tuple(p.split(":", 1))
                for p in args.fleet_hot.split(",") if p)
    fcfg = FleetConfig(num_shards=args.fleet, seed=args.seed,
                       journal_dir=args.journal_dir,
                       max_batch=args.fleet_max_batch,
                       pipeline_depth=args.pipeline_depth,
                       binary=not args.no_binary,
                       hot_classes=hot,
                       queue_depth=max(4096, args.burst),
                       device=args.device)
    reqs = make_requests(burst=args.burst, tenants=args.tenants,
                         seed=args.seed, pattern=args.pattern)
    with Fleet(fcfg, plan) as fleet:
        client = fleet.client()
        t0 = time.perf_counter()
        responses = run_fleet_burst(client, reqs)
        wall_s = time.perf_counter() - t0
        cstats = client.stats()
        cstats.update(_shard_stats(client))
        client.close()
        journals = fleet.journals()
        fleet.stop()

    digest = audit.response_digest(responses)
    print(f"fleet[{args.fleet}] served {len(responses)}/{args.burst} "
          f"requests from {args.tenants} tenants in {wall_s:.3f}s "
          f"({len(responses) / wall_s:.0f} req/s wall)"
          + (f"  [faults: {args.fault_plan}]" if plan else ""))
    print(f"latency p50={cstats['latency_p50_ms']:.2f}ms "
          f"p99={cstats['latency_p99_ms']:.2f}ms  "
          f"retries={cstats['retries']} failovers={cstats['failovers']}"
          + (f" recovery={cstats['recovery_ms']:.0f}ms"
             if cstats["recovery_ms"] is not None else ""))
    print(f"coalescing: {cstats['engine_calls']} engine calls + "
          f"{cstats['lease_calls']} leases for "
          f"{cstats['requests_served']} requests "
          f"({cstats['coalesce_calls_per_req']:.3f} calls/request, "
          f"pool hit rate {cstats['pool_hit_rate']:.3f})")
    print(f"wire: {cstats['bytes_on_wire_per_req']:.0f} bytes/req "
          f"({'binary v2' if not args.no_binary else 'json v1'})")
    print(f"digest {digest}")

    rc = 0
    if args.verify_replay:
        # union replay: each shard journal regenerates its slice of the
        # burst in a fresh context; together they must reproduce every
        # response byte-for-byte
        replayed = {}
        for i, path in sorted(journals.items()):
            part = audit.replay(path, seed=args.seed, device=args.device)
            audit.verify_ledger_disjoint(audit.Journal(path,
                                                       readonly=True))
            replayed.update(part)
        same = (set(replayed) == set(responses)
                and audit.response_digest(replayed) == digest)
        print(f"replay: {'OK — bit-identical' if same else 'MISMATCH'} "
              f"({len(replayed)} journaled requests across "
              f"{len(journals)} shards)")
        if not same:
            rc = 1

    if args.digest_out:
        with open(args.digest_out, "w") as f:
            f.write(digest + "\n")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"burst": args.burst, "tenants": args.tenants,
                       "seed": args.seed, "fleet": args.fleet,
                       "fault_plan": args.fault_plan, "wall_s": wall_s,
                       "digest": digest, "stats": cstats}, f, indent=2)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--burst", type=int, default=512)
    ap.add_argument("--tenants", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pattern", default="mixed",
                    choices=("mixed", "hammer", "unique"),
                    help="traffic shape: mixed classes, single-tenant "
                         "hammer, or all-unique shapes")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve over N subprocess shards via the socket "
                         "transport instead of in-process")
    ap.add_argument("--fault-plan", default="",
                    help="scripted faults for fleet mode, e.g. "
                         "'kill@512' or 'hang@40#1~30' (see "
                         "repro_torch.runtime.fault.FaultPlan.parse)")
    ap.add_argument("--journal-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch-fleet"),
                    help="fleet mode: per-shard journal/log directory")
    ap.add_argument("--fleet-max-batch", type=int, default=32,
                    help="fleet mode: per-shard microbatch size "
                         "(composition is journaled, so >1 is safe)")
    ap.add_argument("--pipeline-depth", type=int, default=32,
                    help="fleet mode: client in-flight window per shard")
    ap.add_argument("--no-binary", action="store_true",
                    help="fleet mode: force JSON v1 wire frames")
    ap.add_argument("--fleet-hot", default="bits:float32,uniform:float32",
                    help="fleet mode: comma-joined sampler:dtype pool "
                         "classes ('' disables standing pools)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-delay", type=float, default=0.25,
                    help="microbatch deadline seconds (generous default "
                         "keeps single-threaded bursts deterministic)")
    ap.add_argument("--submit-threads", type=int, default=0,
                    help="0 = in-order submission (deterministic); >0 = "
                         "concurrent submitter threads")
    ap.add_argument("--hot", action="store_true",
                    help="standing producer pool for uniform/float32")
    ap.add_argument("--journal", default=None,
                    help="journal JSONL path (default: in-memory)")
    ap.add_argument("--verify-replay", action="store_true")
    ap.add_argument("--digest-out", default=None,
                    help="write the response digest to this file")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write stats+digest JSON to this file")
    ap.add_argument("--linger", type=float, default=0.0,
                    help="stay up this many seconds after the burst "
                         "(SIGINT drains gracefully and exits 0)")
    ap.add_argument("--device", default=None,
                    help="device to serve on, and of every fleet shard "
                         "(default: the card; 'cpu' for the plain torch "
                         "path)")
    args = ap.parse_args(argv)

    if args.fleet:
        return _run_fleet(args)

    deterministic = args.submit_threads == 0
    cfg = ServerConfig(
        max_batch=args.max_batch, max_delay_s=args.max_delay,
        queue_depth=max(4096, args.burst),
        hot_classes=((("uniform", "float32"),) if args.hot else ()))
    journal = audit.Journal(args.journal)
    # deterministic mode: enqueue the WHOLE burst before the dispatch
    # loop starts, so microbatch composition is count-based (chunks of
    # max_batch in submission order), never wall-clock-based - the
    # cross-run digest comparison must not depend on scheduler timing
    server = RandServer(args.seed, config=cfg, journal=journal,
                        start=not deterministic, device=args.device)

    # SIGINT (interactive ^C) and SIGTERM (supervisors) both trigger
    # the same graceful drain
    interrupted = drain_signal_event()

    reqs = make_requests(burst=args.burst, tenants=args.tenants,
                         seed=args.seed, pattern=args.pattern)
    t0 = time.perf_counter()
    if deterministic:
        futs = [server.submit(r) for r in reqs]
        server.start()
        responses = {r.rid: f.result(timeout=600)
                     for r, f in zip(reqs, futs)}
    else:
        responses = run_burst(server, reqs,
                              submit_threads=args.submit_threads)
    wall_s = time.perf_counter() - t0
    digest = audit.response_digest(responses)
    stats = server.stats()
    audit.verify_ledger_disjoint(server.block_service)
    if journal.windows():
        audit.verify_ledger_disjoint(journal)

    print(f"served {len(responses)}/{args.burst} requests from "
          f"{stats['tenants']} tenants in {wall_s:.3f}s "
          f"({len(responses) / wall_s:.0f} req/s wall)")
    print(f"latency p50={stats['latency_p50_ms']:.2f}ms "
          f"p99={stats['latency_p99_ms']:.2f}ms")
    print(f"coalescing: {stats['engine_calls']} engine calls + "
          f"{stats['lease_calls']} leases for {stats['requests_served']} "
          f"requests ({stats['calls_per_request']:.3f} calls/request, "
          f"fill {stats['fill_ratio']:.3f})")
    print(f"digest {digest}")

    rc = 0
    if args.verify_replay:
        replayed = audit.replay(journal, seed=args.seed,
                                device=server.device)
        same = (set(replayed) == set(responses)
                and audit.response_digest(replayed) == digest)
        print(f"replay: {'OK — bit-identical' if same else 'MISMATCH'} "
              f"({len(replayed)} journaled requests)")
        if not same:
            rc = 1

    if args.digest_out:
        with open(args.digest_out, "w") as f:
            f.write(digest + "\n")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"burst": args.burst, "tenants": args.tenants,
                       "seed": args.seed, "wall_s": wall_s,
                       "digest": digest, "stats": stats}, f, indent=2)

    if args.linger > 0 and rc == 0:
        print("ready (SIGINT/SIGTERM to drain)", flush=True)
        deadline = time.monotonic() + args.linger
        while not interrupted.is_set() and time.monotonic() < deadline:
            interrupted.wait(0.1)
    server.shutdown()
    print("drained", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
