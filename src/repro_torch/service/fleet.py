"""RandService fleet: sharded serving with journal-backed failover.

The paper's decorrelated counter addressing makes every response a pure
function of ``(seed, tenant tags, counter window)`` - so a serving
*fleet* needs no shared mutable state at all.  Each shard process runs
a full ``RandServer`` over the SAME global plan; the client-side hash
ring decides which tenants it serves; the only durable state is the
shard's append-only journal.  Failover is therefore *stateless*: a
surviving peer takes the dead shard's journal lock (the OS releases a
flock only when the owner is truly gone - fencing for free), restores
the journaled windows into a fresh ledger, raises the lease floor to
the journaled high-water mark, and resumes the dead shard's tenant
regions.

Shards serve COALESCED (``max_batch > 1``) with standing producer
pools, yet failover stays digest-identical, because batch composition
is deterministic end to end: the client sends each shard's request
subsequence in order on ONE pipelined connection (arrival order =
send order), the shard's transport gate seals batches purely by count
or an explicit ``flush`` op (never wall-clock, never connection EOF),
and every sealed batch is journaled as ONE atomic record before its
responses release.  A crashed shard's journal is therefore always
batch-aligned; the adopter re-forms the identical batches from the
client's in-order resubmission - which is exactly what the
kill-mid-burst CI check asserts by digest equality.

Pieces:

  * :class:`HashRing` - consistent tenant -> logical-shard routing
    (blake2s vnodes, pure function of the shard count),
  * :class:`Fleet` - controller that spawns N ``ShardHost``
    subprocesses, hands out addresses, and can *fence* (SIGKILL + wait)
    a shard that is alive-but-hung so its journal lock drops,
  * :class:`FleetClient` - PIPELINED router: per shard, a bounded
    in-flight window of rid-tagged frames over the negotiated wire
    version (binary v2 by default), out-of-order completion, in-order
    per-tenant delivery, per-request deadlines, bounded exponential
    backoff, and fence-gated hedged resubmission: when the owner of a
    shard stops answering, the client asks the failover peer to adopt
    the shard's journal; the peer's flock attempt either succeeds
    (owner dead -> hedge serves there) or reports ``locked`` (owner
    alive -> back off, optionally fence, retry); after failover every
    unanswered request resubmits in original order (journaled rids
    answer by replay, parked rids dedup server-side),
  * :func:`run_fleet_burst` - per-shard in-order burst driver (the
    deterministic traffic shape the digest checks rely on).

Subprocess entry: ``python -m repro_torch.service.fleet --serve --shard
i [--device D]`` (spawned by :class:`Fleet`; drains gracefully on
SIGTERM/SIGINT).  A shard serves on the card unless ``--device`` names
another device, and exits non-zero without one.  On the card it loads
(and at first use builds) kernel A's library before it publishes its
port, so no client deadline covers a compile; its log's first line names
the device it serves on.  The routing, the journals and the wire bytes
are the JAX reference's (``repro.service.fleet``), so a fleet of either
package replays through the other's ``audit.replay``.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import hashlib
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.fault import FaultInjector, FaultPlan
from repro_torch.service import transport
from repro_torch.service.frontend import RandRequest
from repro_torch.service.server import ServerConfig, drain_signal_event


# ---------------------------------------------------------------------------
# Consistent-hash routing
# ---------------------------------------------------------------------------

def _h64(text: str) -> int:
    return int.from_bytes(
        hashlib.blake2s(text.encode("utf-8"), digest_size=8).digest(),
        "little")


class HashRing:
    """Consistent tenant -> shard map: ``replicas`` blake2s vnodes per
    shard on a u64 ring.  Pure function of ``(num_shards, replicas)`` -
    every client and every test derives the identical routing table
    with zero coordination.

    Example:
        >>> from repro_torch.service.fleet import HashRing
        >>> ring = HashRing(2)
        >>> ring.owner("tenant/00042") == ring.owner("tenant/00042")
        True
        >>> sorted({ring.owner(f"t{i}") for i in range(64)})
        [0, 1]
    """

    def __init__(self, num_shards: int, *, replicas: int = 64):
        if num_shards < 1:
            raise ValueError(f"need >= 1 shard, got {num_shards}")
        self.num_shards = num_shards
        self.replicas = replicas
        pts = []
        for s in range(num_shards):
            for r in range(replicas):
                pts.append((_h64(f"shard:{s}:vnode:{r}"), s))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [s for _, s in pts]

    def owner(self, tenant_id: str) -> int:
        """Logical shard owning ``tenant_id``'s region."""
        h = _h64(f"tenant:{tenant_id}")
        i = bisect.bisect_right(self._points, h) % len(self._points)
        return self._owners[i]

    def peers(self, shard: int) -> List[int]:
        """Failover preference order for ``shard``: the other shards,
        nearest successor first (deterministic - every client picks the
        same adoption target)."""
        return [(shard + k) % self.num_shards
                for k in range(1, self.num_shards)]


# ---------------------------------------------------------------------------
# Fleet controller (parent process)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Topology + client policy of one fleet run.

    ``max_batch > 1`` is safe because batch composition is itself
    deterministic: the client's per-shard pipeline sends in order, the
    shard's gate seals purely by count (or the client's trailing
    ``flush``), and each sealed microbatch journals as one atomic
    record - so crash-replay and adoption re-form identical batches
    and the kill-mid-burst digest-equality check still holds.

    ``pipeline_depth`` bounds the client's in-flight window per shard
    connection; it is clamped up to the server's negotiated
    ``max_batch`` so a full batch can always be in flight (a smaller
    window would deadlock: the gate waits for arrivals the client is
    withholding).  ``binary=True`` negotiates wire v2 (raw
    little-endian array payloads, zero-copy decode); v1 JSON remains
    for compatibility.  ``hot_classes`` lists ``(sampler, dtype)``
    pairs each shard keeps standing producer pools for.  ``device``
    (None: each shard's default, the card) becomes the shards'
    ``--device`` only when it is set.
    """
    num_shards: int = 2
    seed: int = 0
    journal_dir: str = "."
    host: str = "127.0.0.1"
    max_batch: int = 32
    pipeline_depth: int = 32
    binary: bool = True
    hot_classes: Tuple[Tuple[str, str], ...] = (
        ("bits", "float32"), ("uniform", "float32"))
    queue_depth: int = 4096
    deadline_s: float = 120.0        # generous: first contacts pay
                                     # the shard's first allocations
    connect_timeout_s: float = 10.0
    max_retries: int = 6
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    replicas: int = 64
    spawn_timeout_s: float = 120.0
    device: Optional[str] = None


class FleetError(RuntimeError):
    """A request could not be served within the retry/deadline budget."""


class Fleet:
    """Spawn and supervise ``num_shards`` ShardHost subprocesses.

    Each child binds an ephemeral port and writes it to
    ``<journal_dir>/shard<i>.port``; stdout/stderr stream to
    ``shard<i>.log``.  ``fence(i)`` is the STONITH step: SIGKILL + wait,
    guaranteeing the child's journal flock is released before a peer
    adopts it.
    """

    def __init__(self, config: FleetConfig,
                 fault_plan: Optional[FaultPlan] = None):
        self.config = config
        self.fault_plan = fault_plan or FaultPlan()
        os.makedirs(config.journal_dir, exist_ok=True)
        self._procs: List[subprocess.Popen] = []
        self._addrs: Dict[int, Tuple[str, int]] = {}
        src_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        try:
            for i in range(config.num_shards):
                log = open(os.path.join(config.journal_dir,
                                        f"shard{i}.log"), "ab")
                try:
                    self._procs.append(subprocess.Popen(
                        self.shard_command(i), env=env, stdout=log,
                        stderr=subprocess.STDOUT))
                finally:
                    log.close()
            self._await_ports()
        except BaseException:
            self.stop(timeout=10.0)      # no shard outlives a failed start
            raise

    def shard_command(self, i: int) -> List[str]:
        """The command line of shard process ``i``."""
        cfg = self.config
        cmd = [sys.executable, "-m", "repro_torch.service.fleet", "--serve",
               "--shard", str(i), "--seed", str(cfg.seed),
               "--host", cfg.host,
               "--journal", self.journal_path(i),
               "--port-file", self._port_file(i),
               "--max-batch", str(cfg.max_batch),
               "--queue-depth", str(cfg.queue_depth),
               "--hot-classes", ",".join(
                   f"{s}:{d}" for s, d in cfg.hot_classes)]
        if cfg.device is not None:
            cmd += ["--device", str(cfg.device)]
        if self.fault_plan:
            cmd += ["--fault-plan", self.fault_plan.to_json()]
        return cmd

    def _port_file(self, i: int) -> str:
        return os.path.join(self.config.journal_dir, f"shard{i}.port")

    def journal_path(self, i: int) -> str:
        return os.path.join(self.config.journal_dir, f"shard{i}.jsonl")

    def _await_ports(self) -> None:
        deadline = time.monotonic() + self.config.spawn_timeout_s
        for i, proc in enumerate(self._procs):
            pf = self._port_file(i)
            while True:
                if os.path.exists(pf):
                    try:
                        port = int(open(pf).read().strip())
                        break
                    except ValueError:
                        pass        # partially written; poll again
                if proc.poll() is not None:
                    raise FleetError(
                        f"shard {i} exited rc={proc.returncode} before "
                        f"listening (see shard{i}.log)")
                if time.monotonic() > deadline:
                    raise FleetError(f"shard {i} never published a port")
                time.sleep(0.02)
            self._addrs[i] = (self.config.host, port)

    def address(self, i: int) -> Tuple[str, int]:
        return self._addrs[i]

    def addresses(self) -> Dict[int, Tuple[str, int]]:
        return dict(self._addrs)

    def journals(self) -> Dict[int, str]:
        return {i: self.journal_path(i)
                for i in range(self.config.num_shards)}

    def alive(self, i: int) -> bool:
        return self._procs[i].poll() is None

    def fence(self, i: int) -> None:
        """Guarantee shard process ``i`` is dead (SIGKILL + reap) so its
        journal lock is released - the STONITH step before adoption."""
        proc = self._procs[i]
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)

    def client(self, **overrides) -> "FleetClient":
        return FleetClient(self.addresses(), self.journals(),
                           config=self.config, fencer=self.fence,
                           **overrides)

    def stop(self, timeout: float = 60.0) -> None:
        """Graceful fleet shutdown: SIGTERM (drain) then SIGKILL."""
        for proc in self._procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + timeout
        for proc in self._procs:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Client-side router
# ---------------------------------------------------------------------------

class _MeterSock:
    """Byte-metering socket wrapper: counts exactly what crosses the
    wire so ``bytes_on_wire_per_req`` in the bench rows is measured,
    not estimated."""

    __slots__ = ("sock", "tx", "rx")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.tx = 0
        self.rx = 0

    def sendall(self, data) -> None:
        self.sock.sendall(data)
        self.tx += len(data)

    def recv(self, n: int) -> bytes:
        data = self.sock.recv(n)
        self.rx += len(data)
        return data

    def settimeout(self, t: Optional[float]) -> None:
        self.sock.settimeout(t)

    def close(self) -> None:
        self.sock.close()


class _PipeConn:
    """One persistent PIPELINED connection to whichever process owns a
    logical shard.  Single-owner (the per-shard burst thread).

    ``ensure()`` connects lazily and runs the hello negotiation once
    per connection: the client offers its wire versions, the server
    answers with the highest common one plus its ``max_batch`` (which
    the caller folds into its in-flight window).  Byte counters
    survive reconnects: ``disconnect()`` folds the dead socket's
    totals into the conn before dropping it.
    """

    def __init__(self, addr: Tuple[str, int], *, connect_timeout: float,
                 versions: Tuple[int, ...]):
        self.addr = addr
        self.connect_timeout = connect_timeout
        self.versions = versions
        self.sock: Optional[_MeterSock] = None
        self.version = transport.WIRE_V1
        self.server_max_batch = 1
        self.tx = 0                  # folded totals from dead sockets
        self.rx = 0

    def ensure(self) -> None:
        if self.sock is not None:
            return
        raw = socket.create_connection(self.addr,
                                       timeout=self.connect_timeout)
        self.sock = _MeterSock(raw)
        transport.send_wire(
            self.sock, {"op": "hello",
                        "versions": sorted(self.versions)},
            version=transport.WIRE_V1)
        got = transport.recv_wire(self.sock)
        if got is None:
            raise transport.TornFrame(f"no hello reply from {self.addr}")
        reply, _ = got
        if not reply.get("ok"):
            raise transport.WireError(
                reply.get("kind", "error"),
                str(reply.get("error", "hello refused")))
        self.version = int(reply.get("version", transport.WIRE_V1))
        self.server_max_batch = int(reply.get("max_batch", 1))

    def send(self, obj: Dict[str, Any]) -> None:
        self.ensure()
        transport.send_wire(self.sock, obj, version=self.version)

    def recv(self, timeout: float) -> Dict[str, Any]:
        self.sock.settimeout(timeout)
        got = transport.recv_wire(self.sock)
        if got is None:
            raise transport.TornFrame(f"EOF from {self.addr}")
        return got[0]

    def bytes_total(self) -> Tuple[int, int]:
        live_tx = self.sock.tx if self.sock is not None else 0
        live_rx = self.sock.rx if self.sock is not None else 0
        return self.tx + live_tx, self.rx + live_rx

    def disconnect(self) -> None:
        if self.sock is not None:
            self.tx += self.sock.tx
            self.rx += self.sock.rx
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def reset(self, addr: Tuple[str, int]) -> None:
        self.disconnect()
        self.addr = addr


class FleetClient:
    """Route requests to shard owners; pipeline, retry, hedge, fail
    over.

    Each logical shard gets ONE pipelined connection: a bounded
    in-flight window of rid-tagged request frames, completions
    accepted out of order, responses released strictly in the shard's
    original request order (which is per-tenant order, since a tenant
    maps to exactly one shard).  After the window's last request a
    ``flush`` op seals any partial microbatch server-side.

    The failure path for a shard whose owner stopped answering:

    1. bounded exponential backoff retries against the current owner
       (covers transient slowness and scripted ``slow`` faults -
       idempotent because a journaled rid is answered by replay),
    2. in parallel with each retry, a *fence-gated hedge*: ask the
       ring's failover peer to ``adopt`` the shard's journal.  The
       peer's exclusive flock attempt is the safety interlock - it
       succeeds only if the owner is actually dead,
    3. if adoption keeps reporting ``locked`` (owner alive but hung)
       and a ``fencer`` is available, fence the owner (SIGKILL + wait)
       and adopt - never two writers, never a lost response,
    4. after reconnecting, every still-unanswered request resubmits in
       its original order: journaled rids answer by replay, parked
       rids attach to the in-flight future, the rest re-enter the gate
       - so batch composition (and hence every byte) matches a
       fault-free run.
    """

    def __init__(self, addresses: Dict[int, Tuple[str, int]],
                 journals: Dict[int, str], *,
                 config: Optional[FleetConfig] = None,
                 fencer: Optional[Callable[[int], None]] = None,
                 ring: Optional[HashRing] = None,
                 deadline_s: Optional[float] = None,
                 fence_after: int = 2,
                 binary: Optional[bool] = None):
        self.config = config or FleetConfig(num_shards=len(addresses))
        self.addresses = dict(addresses)
        self.journals = dict(journals)
        self.fencer = fencer
        self.fence_after = fence_after
        self.deadline_s = (self.config.deadline_s
                           if deadline_s is None else deadline_s)
        self.binary = self.config.binary if binary is None else binary
        self._versions: Tuple[int, ...] = (
            (transport.WIRE_V1, transport.WIRE_V2) if self.binary
            else (transport.WIRE_V1,))
        self.ring = ring or HashRing(len(addresses),
                                     replicas=self.config.replicas)
        # logical shard -> process index currently hosting it
        self._owner: Dict[int, int] = {i: i for i in addresses}
        self._conns: Dict[int, _PipeConn] = {}
        self._lock = threading.Lock()
        self.latencies: List[float] = []
        self.retries = 0
        self.failovers = 0
        self.errors = 0
        self.recovery_s: Optional[float] = None
        # (tenant_id, rid) in delivery order - the per-tenant ordering
        # oracle the pipelining tests assert over
        self.delivery_log: List[Tuple[str, str]] = []
        self._bytes_base = (0, 0)    # byte totals at last reset_metrics

    # -- connection/ownership ---------------------------------------------

    def _conn(self, logical: int) -> _PipeConn:
        with self._lock:
            proc = self._owner[logical]
            conn = self._conns.get(logical)
            addr = self.addresses[proc]
            if conn is None:
                conn = _PipeConn(
                    addr, connect_timeout=self.config.connect_timeout_s,
                    versions=self._versions)
                self._conns[logical] = conn
            elif conn.addr != addr:
                conn.reset(addr)
            return conn

    def _try_adopt(self, logical: int) -> bool:
        """Hedge to the failover peer: adopted -> reroute and return
        True; ``locked`` (owner still alive) -> False."""
        dead_proc = self._owner[logical]
        for peer_logical in self.ring.peers(logical):
            with self._lock:
                peer_proc = self._owner[peer_logical]
            if peer_proc == dead_proc:
                continue
            try:
                reply = transport.rpc(
                    self.addresses[peer_proc],
                    {"op": "adopt", "shard": logical,
                     "journal": self.journals[logical]},
                    timeout=self.config.connect_timeout_s)
            except (OSError, transport.TransportError):
                continue            # peer also unreachable; next one
            if reply.get("ok"):
                with self._lock:
                    self._owner[logical] = peer_proc
                    conn = self._conns.get(logical)
                if conn is not None:
                    conn.reset(self.addresses[peer_proc])
                self.failovers += 1
                return True
            if reply.get("kind") != "locked":
                continue
        return False

    # -- request path ------------------------------------------------------

    def run_shard(self, logical: int, reqs: List[RandRequest],
                  responses: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
        """Serve ``reqs`` (one shard's in-order subsequence) through a
        bounded pipelined window, riding out owner death.

        Completions arrive rid-tagged and possibly out of order;
        delivery into ``responses`` (and ``delivery_log``) is strictly
        in ``reqs`` order.  On a wire failure every unanswered request
        resubmits in original order after the adopt/fence dance - the
        server dedups by rid, so composition is preserved.
        """
        if responses is None:
            responses = {}
        for r in reqs:
            if r.rid is None:
                raise ValueError("fleet requests need caller-stamped rids")
        resolved: Dict[str, Any] = {}
        t_first: Dict[str, float] = {}
        delivered = 0

        def release() -> None:
            nonlocal delivered
            while (delivered < len(reqs)
                   and reqs[delivered].rid in resolved):
                req = reqs[delivered]
                responses[req.rid] = resolved[req.rid]
                with self._lock:
                    self.latencies.append(
                        time.perf_counter() - t_first[req.rid])
                    self.delivery_log.append((req.tenant_id, req.rid))
                delivered += 1

        attempt = 0
        failed_at: Optional[float] = None
        last_exc: Optional[BaseException] = None
        while delivered < len(reqs):
            conn = self._conn(logical)
            try:
                conn.ensure()
                window = max(self.config.pipeline_depth,
                             conn.server_max_batch)
                todo = [r for r in reqs if r.rid not in resolved]
                inflight: set = set()
                sent = 0
                flushed = False
                while inflight or sent < len(todo) or not flushed:
                    while sent < len(todo) and len(inflight) < window:
                        r = todo[sent]
                        t_first.setdefault(r.rid, time.perf_counter())
                        conn.send(transport.request_to_wire(r, logical))
                        inflight.add(r.rid)
                        sent += 1
                    if sent >= len(todo) and not flushed:
                        # seal any partial microbatch server-side
                        conn.send({"op": "flush", "shard": logical})
                        flushed = True
                    if not inflight and flushed:
                        break
                    reply = conn.recv(self.deadline_s)
                    rid = reply.get("rid")
                    if rid is None:
                        continue            # op ack (flush)
                    if reply.get("ok"):
                        if (failed_at is not None
                                and self.recovery_s is None):
                            self.recovery_s = (time.perf_counter()
                                               - failed_at)
                        inflight.discard(rid)
                        resolved[rid] = transport.reply_array(reply)
                        release()
                        continue
                    if reply.get("kind") == "not_owner":
                        # ownership moved (another thread's failover
                        # won): rediscover, then resubmit unanswered
                        raise transport.WireError(
                            "not_owner", str(reply.get("error", "")))
                    self.errors += 1
                    raise FleetError(
                        f"shard {logical} refused {rid}: "
                        f"{reply.get('kind')}: {reply.get('error')}")
                continue                    # loop guard re-checks
            except (OSError, transport.TransportError,
                    transport.WireError) as e:
                last_exc = e
                if failed_at is None:
                    failed_at = time.perf_counter()
                self.retries += 1
                conn.disconnect()
                adopted = self._try_adopt(logical)
                if not adopted:
                    if (self.fencer is not None
                            and attempt + 1 >= self.fence_after):
                        # hung owner: its journal lock is still held -
                        # fence (SIGKILL + wait) so adoption can proceed
                        self.fencer(self._owner[logical])
                        adopted = self._try_adopt(logical)
                if not adopted:
                    time.sleep(min(self.config.backoff_cap_s,
                                   self.config.backoff_base_s
                                   * (2 ** attempt)))
                attempt += 1
                if attempt > self.config.max_retries:
                    self.errors += 1
                    raise FleetError(
                        f"shard {logical} burst exhausted "
                        f"{self.config.max_retries} retries "
                        f"({len(reqs) - delivered} undelivered)"
                        ) from last_exc
        return responses

    def request(self, req: RandRequest) -> Any:
        """Serve one request (a single-element pipelined window; the
        trailing ``flush`` seals the server's partial batch)."""
        if req.rid is None:
            raise ValueError("fleet requests need caller-stamped rids")
        out = self.run_shard(self.ring.owner(req.tenant_id), [req])
        return out[req.rid]

    def reset_metrics(self) -> None:
        """Zero latency/retry/byte accounting (connections stay up) so
        a benchmark can split warm-up from a steady-state window."""
        with self._lock:
            self.latencies = []
            self.delivery_log = []
            self.retries = self.failovers = self.errors = 0
            self.recovery_s = None
            self._bytes_base = (
                sum(c.bytes_total()[0] for c in self._conns.values()),
                sum(c.bytes_total()[1] for c in self._conns.values()))

    def stats(self) -> Dict[str, Any]:
        lat = np.asarray(self.latencies, np.float64)
        with self._lock:
            tx = (sum(c.bytes_total()[0] for c in self._conns.values())
                  - self._bytes_base[0])
            rx = (sum(c.bytes_total()[1] for c in self._conns.values())
                  - self._bytes_base[1])
        n = int(lat.size)
        return {
            "requests": n,
            "retries": self.retries,
            "failovers": self.failovers,
            "errors": self.errors,
            "recovery_ms": (None if self.recovery_s is None
                            else self.recovery_s * 1e3),
            "latency_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                               if lat.size else 0.0),
            "latency_p99_ms": (float(np.percentile(lat, 99)) * 1e3
                               if lat.size else 0.0),
            "bytes_tx": tx,
            "bytes_rx": rx,
            "bytes_on_wire_per_req": ((tx + rx) / n if n else 0.0),
        }

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            conn.disconnect()


def run_fleet_burst(client: FleetClient,
                    requests: List[RandRequest]
                    ) -> Dict[str, Any]:
    """Drive a burst through the fleet: requests partition by owning
    shard (order preserved) and each partition runs through the
    pipelined per-shard engine on its own thread - every shard sees a
    deterministic in-order subsequence (bounded in-flight window,
    in-order delivery), so assignments are reproducible, fault or no
    fault.
    """
    by_shard: Dict[int, List[RandRequest]] = {}
    for req in requests:
        by_shard.setdefault(client.ring.owner(req.tenant_id),
                            []).append(req)
    responses: Dict[str, Any] = {}
    failures: List[BaseException] = []
    lock = threading.Lock()

    def worker(shard: int, reqs: List[RandRequest]) -> None:
        try:
            out = client.run_shard(shard, reqs)
        except BaseException as e:   # noqa: BLE001 - surfaced below
            with lock:
                failures.append(e)
            return
        with lock:
            responses.update(out)

    threads = [threading.Thread(target=worker, args=(shard, reqs),
                                daemon=True)
               for shard, reqs in by_shard.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    return responses


# ---------------------------------------------------------------------------
# Shard subprocess entry
# ---------------------------------------------------------------------------

def serve_shard(args) -> int:
    injector = None
    if args.fault_plan:
        injector = FaultInjector(FaultPlan.parse(args.fault_plan))
    hot = tuple(tuple(p.split(":", 1))
                for p in args.hot_classes.split(",") if p)
    cfg = ServerConfig(max_batch=args.max_batch, max_delay_s=0.0,
                       queue_depth=args.queue_depth, hot_classes=hot)
    host = transport.ShardHost(args.seed, host=args.host, port=args.port,
                               config=cfg, injector=injector,
                               device=args.device)
    where = str(host.device)
    if host.device.type == "cuda":
        import torch
        from repro_torch.kernels import build
        # kernel A serves every pool block and class call: load it (and
        # build it at first use) before the port file, so no client
        # deadline ever covers an nvcc build
        build.library("thundering_block")
        where += f" ({torch.cuda.get_device_name(host.device)})"
    print(f"shard {args.shard} serves on {where}", flush=True)
    host.add_shard(args.shard, args.journal)
    stop = drain_signal_event()
    # port file last: its existence means "accepting and shard is open"
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(host.address[1]))
    os.replace(tmp, args.port_file)
    stop.wait()
    host.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="RandService fleet shard process")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--journal", required=True)
    ap.add_argument("--port-file", required=True)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--queue-depth", type=int, default=4096)
    ap.add_argument("--hot-classes", default="",
                    help="comma-joined sampler:dtype pool classes")
    ap.add_argument("--fault-plan", default="")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card)")
    args = ap.parse_args(argv)
    if not args.serve:
        ap.error("--serve is the only mode (spawned by fleet.Fleet)")
    return serve_shard(args)


if __name__ == "__main__":
    sys.exit(main())
