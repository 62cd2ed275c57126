"""RandServer: the dispatch loop of randomness-as-a-service.

One daemon thread owns a bounded request queue (a full queue blocks
``submit``: backpressure, not unbounded buffering) and turns arrivals
into microbatches under a two-sided watermark: a batch closes when it
reaches ``max_batch`` requests OR when the oldest request has waited
``max_delay_s``.  Each batch is served by

  * **standing producer pools** for the configured hot
    ``(sampler, dtype)`` classes: a ``runtime.blocks.BlockProducer``
    keeps pre-generated ``(pool_rows, pool_cols)`` blocks ready on the
    service's device (leased and launched ahead of demand on its own
    stream: the paper's FIFO-into-application), and small requests are
    served by slicing whole columns off the current block, copied to the
    host once, or
  * the **coalescing frontend** (``service.frontend``) for everything
    else: one leased counter window + one gathered-tag
    ``engine.generate`` per request class.

Every response's assignment is journaled and fsynced *before* the
caller's future resolves, so a crash after a response was released is
always replayable (``service.audit``).  Journaling is
**group-committed**: each microbatch becomes ONE atomic ``batch``
record (its composition in batch order + every counter window it
consumed) and ONE fsync.  On construction with a non-empty journal the
server fences every journaled window off its ledgers - a restarted
service can never re-serve consumed randomness - and standing pools
resume mid-block at the exact column cursor the journal implies, so a
failover peer's pool serves the same columns the dead owner would have.
The journal is the JAX reference's (``repro.service.server``) byte for
byte for the same deterministic burst, so either package restarts over
the other's journal.

Shutdown is a graceful drain: ``shutdown()`` stops new admissions,
serves everything already queued, closes the pools (releasing their
unconsumed reservations), and only then returns.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import queue
import signal as signal_mod
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime import blocks
from repro_torch.service import tenants as tenants_mod
from repro_torch.service.audit import Journal
from repro_torch.service.frontend import (DEFAULT_MAX_ROWS, Assignment,
                                          Coalescer, RandRequest, host_block,
                                          slice_response)

_STOP = object()


class _SealedBatch:
    """A pre-composed microbatch enqueued as ONE queue item.

    ``submit_batch`` wraps its requests in this so the dispatch loop
    serves them exactly as composed - never merged with neighbouring
    arrivals, never re-chunked - which is what lets a wire shard seal
    batch composition at the transport gate and journal it atomically.
    """
    __slots__ = ("items",)

    def __init__(self, items: List) -> None:
        self.items = items


class ServiceClosed(RuntimeError):
    """submit() after shutdown began (or the queue was torn down)."""


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Knobs of the dispatch loop and the standing pools.

    ``max_batch``/``max_delay_s`` are the microbatch watermark (size OR
    deadline); ``queue_depth`` bounds admission (backpressure);
    ``hot_classes`` lists the (sampler, out_dtype) pairs that get a
    standing producer pool of ``pool_depth`` blocks of ``(pool_rows,
    pool_cols)``; ``pool_donate`` writes the pool's blocks into a ring of
    preallocated buffers.
    """
    max_batch: int = 256
    max_delay_s: float = 0.005
    queue_depth: int = 4096
    max_rows: int = DEFAULT_MAX_ROWS
    hot_classes: Tuple[Tuple[str, str], ...] = ()
    pool_rows: int = 1024
    pool_cols: int = 64
    pool_depth: int = 2
    pool_donate: bool = True
    pool_fuse: int = 1
    default_quota: Optional[int] = None


def pool_channel(sampler: str, out_dtype: str) -> str:
    """Channel of one hot class's standing pool (distinct from the
    coalescer's class channel: pooled columns are the channel's own
    leaf table 0..pool_cols-1, not tenant-region tags)."""
    return f"service/pool/{sampler}/{out_dtype}"


class _Pool:
    """Standing producer for one hot class + a column cursor over the
    current pre-generated block.  Dispatcher-thread only (no locks).

    A pulled block is copied to the host on the pulling thread: the
    producer's ``__next__`` orders that thread's current stream after the
    block's launch, and a donated ring buffer is valid only until the
    next pull, so the copy is taken before it.
    """

    def __init__(self, service: blocks.BlockService, sampler: str,
                 out_dtype: str, *, rows: int, cols: int, depth: int,
                 donate: bool = False, fuse: int = 1):
        self.sampler, self.out_dtype = sampler, out_dtype
        self.channel = pool_channel(sampler, out_dtype)
        self.rows, self.cols = rows, cols
        self._service = service
        self.donate = donate
        service.open(self.channel, num_streams=cols, sampler=sampler,
                     out_dtype=out_dtype)
        self._producer = service.producer(self.channel, rows, depth=depth,
                                          donate=donate, fuse=fuse)
        self._lease: Optional[blocks.Lease] = None
        self._block: Any = None
        self._col = 0
        self.blocks_consumed = 0
        self.requests_served = 0

    def can_serve(self, n: int) -> bool:
        return -(-n // self.rows) <= self.cols

    def serve(self, req: RandRequest) -> Tuple[Any, Assignment, bool]:
        """Slice one request off the current block; the third result is
        True when this serve pulled (and so must journal) a new window."""
        n = req.num_samples
        ncols = -(-n // self.rows)
        fresh = False
        if self._block is None or self._col + ncols > self.cols:
            # leftover columns are discarded, never served twice: the
            # lease stays committed (fenced) either way
            self._lease, blk = next(self._producer)
            self._block = host_block(blk, copy=self.donate)
            self._col = 0
            self.blocks_consumed += 1
            fresh = True
        col0, self._col = self._col, self._col + ncols
        resp = slice_response(self._block, col0, ncols, n, req.shape)
        asg = Assignment(
            rid=req.rid, tenant_id=req.tenant_id, sampler=self.sampler,
            out_dtype=self.out_dtype, shape=tuple(req.shape),
            channel=self.channel, lo=self._lease.lo, rows=self.rows,
            tags=tuple(range(col0, col0 + ncols)))
        self.requests_served += 1
        return resp, asg, fresh

    def resume(self, lo: int, consumed: int) -> None:
        """Re-enter the middle of the journaled block ``[lo, lo+rows)``
        with ``consumed`` columns already served.

        The window is already durable (journaled + fenced), so the block
        is REGENERATED - bit-identical by counter addressing - without
        leasing; the column cursor continues exactly where the previous
        owner's journal left off, so a restarted or adopting server
        serves the same columns for the same arrivals the dead owner
        would have.
        """
        blk = self._service.regenerate(self.channel, lo, self.rows)
        self._block = host_block(blk)
        self._lease = blocks.Lease(channel=self.channel, lo=int(lo),
                                   hi=int(lo) + self.rows,
                                   service=self._service)
        self._col = int(consumed)

    def close(self) -> None:
        self._producer.close()


class RandServer:
    """Multi-tenant randomness service over one seed's stream space.

    ``device`` (None: the card, and an error without one) holds the
    ``BlockService`` that the coalescer and the pools generate on;
    responses come back on the host (numpy arrays, CPU tensors for
    bfloat16).

    Example:
        >>> from repro_torch.service import RandServer, ServerConfig
        >>> srv = RandServer(seed=3, config=ServerConfig(max_batch=1),
        ...                  device="cpu")
        >>> u = srv.request("docs/tenant", (4,), sampler="uniform")
        >>> (u.shape, str(u.dtype))
        ((4,), 'float32')
        >>> srv.shutdown()     # True: drained (and journal closed)
        True
    """

    def __init__(self, seed: int = 0, *,
                 config: Optional[ServerConfig] = None,
                 registry: Optional[tenants_mod.TenantRegistry] = None,
                 journal: Optional[Journal] = None,
                 backend: Optional[str] = None, deco: str = "splitmix64",
                 start: bool = True, device=None):
        self.seed = seed
        self.config = config or ServerConfig()
        self.journal = journal
        self.block_service = blocks.BlockService(seed, backend=backend,
                                                 device=device)
        self.device = self.block_service.device
        if journal is not None and journal.entries:
            # restart/adopt: restore committed windows AND raise each
            # channel's lease floor to its journaled high-water mark -
            # this MUST happen before the pools below spin up their
            # producers (restore_ledger wipes reservations, so a later
            # restore would strand every producer's leased-ahead block)
            journal.restore_into(self.block_service, fence=True)
        # explicit None-check: a freshly constructed registry is empty,
        # hence falsy (__len__) - `registry or ...` would discard it
        self.registry = (registry if registry is not None else
                         tenants_mod.TenantRegistry(
                             default_quota=self.config.default_quota))
        # the coalescer runs journal-less under the server: the server
        # group-commits ONE atomic `batch` record per microbatch (see
        # _serve_batch), so windows are derived from the assignments
        self.coalescer = Coalescer(
            self.block_service, self.registry, journal=None,
            backend=backend, deco=deco, max_rows=self.config.max_rows)
        self._pools: Dict[Tuple[str, str], _Pool] = {}
        for sampler, out_dtype in self.config.hot_classes:
            self._pools[(sampler, out_dtype)] = _Pool(
                self.block_service, sampler, out_dtype,
                rows=self.config.pool_rows, cols=self.config.pool_cols,
                depth=self.config.pool_depth,
                donate=self.config.pool_donate,
                fuse=self.config.pool_fuse)
        if journal is not None and journal.entries:
            self._resume_pools(journal)
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=self.config.queue_depth)
        self._closed = threading.Event()
        self._drained = threading.Event()
        self._rid_lock = threading.Lock()
        self._rid = 0
        self._session_rids = set()
        if journal is not None:
            self._session_rids = {e["rid"] for e in journal.requests()}
            # continue auto-rids past anything already journaled: a
            # restarted server must never reuse a pre-crash rid (replay
            # keys responses by rid)
            for e in journal.requests():
                rid = e.get("rid", "")
                if rid.startswith("r") and rid[1:].isdigit():
                    self._rid = max(self._rid, int(rid[1:]))
        self._latencies = collections.deque(maxlen=100_000)
        self._served = 0
        self._failed = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop,
                                        name="randservice", daemon=True)
        self.started = False
        if start:
            self.start()

    def _resume_pools(self, journal: Journal) -> None:
        """Continue each standing pool mid-block from the journal.

        The journal's last request against a pool channel names the
        block window (``lo``) and, via its highest tag, the column
        cursor; regenerating that window (no lease - it is already
        committed and fenced) and setting the cursor makes the resumed
        pool's future serves identical to the dead owner's.
        """
        entries = journal.requests()
        for pool in self._pools.values():
            last_lo: Optional[int] = None
            last_rows = 0
            consumed = 0
            for e in entries:
                if e["channel"] != pool.channel:
                    continue
                if e["lo"] != last_lo:
                    last_lo, consumed = e["lo"], 0
                    last_rows = int(e["rows"])
                if e["tags"]:
                    consumed = max(consumed, max(e["tags"]) + 1)
            # a changed pool geometry (rows) or an exhausted block means
            # there is nothing to re-enter; fresh leases start past the
            # fence either way
            if (last_lo is not None and last_rows == pool.rows
                    and consumed < pool.cols):
                pool.resume(last_lo, consumed)

    def start(self) -> None:
        """Start the dispatch loop (idempotent).  ``start=False`` at
        construction lets a caller enqueue a whole burst FIRST, making
        microbatch composition count-based - pure chunks of
        ``max_batch`` in submission order - instead of wall-clock-based
        (what the cross-run determinism check relies on)."""
        if not self.started:
            self.started = True
            self._thread.start()

    # -- client API --------------------------------------------------------

    def _next_rid(self) -> str:
        with self._rid_lock:
            self._rid += 1
            return f"r{self._rid:08d}"

    def _enqueue(self, item, timeout: Optional[float]) -> None:
        """Put one queue item, blocking while the queue is full.

        The closed-check and the put are one atomic step against
        ``drain``'s closed-set + ``_STOP`` put: anything enqueued here
        sits BEFORE the sentinel and is served by the drain, never
        orphaned.  The put under the lock is non-blocking - a full queue
        releases the lock and retries (backpressure without deadlocking
        the drain).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._close_lock:
                if self._closed.is_set():
                    raise ServiceClosed("RandServer is shut down")
                try:
                    self._queue.put_nowait(item)
                    return
                except queue.Full:
                    pass
            if deadline is not None and time.monotonic() >= deadline:
                raise queue.Full("RandServer queue stayed full "
                                 f"for {timeout}s")
            time.sleep(0.002)

    def _admit(self, requests: List[RandRequest]) -> List[RandRequest]:
        """Validate and rid-stamp ``requests``; with a journal, refuse a
        rid it already holds (all or nothing: a refused batch leaks no
        partial registration)."""
        reqs: List[RandRequest] = []
        for request in requests:
            request.validate()
            if request.rid is None:
                request = dataclasses.replace(request, rid=self._next_rid())
            reqs.append(request)
        if self.journal is not None:
            # the journal is keyed by rid: a reused rid would make the
            # earlier response unauditable
            with self._rid_lock:
                for r in reqs:
                    if r.rid in self._session_rids:
                        raise ValueError(
                            f"rid {r.rid!r} was already used in this "
                            f"journal; rids must be unique")
                self._session_rids.update(r.rid for r in reqs)
        return reqs

    def submit(self, request: RandRequest,
               timeout: Optional[float] = None
               ) -> "concurrent.futures.Future":
        """Enqueue a request; returns a ``concurrent.futures.Future``.

        A full queue BLOCKS the caller (bounded admission); after
        ``shutdown`` began, raises ``ServiceClosed``.
        """
        (request,) = self._admit([request])
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        self._enqueue((request, fut, time.perf_counter()), timeout)
        return fut

    def submit_batch(self, requests: List[RandRequest],
                     timeout: Optional[float] = None) -> List:
        """Enqueue a SEALED microbatch; returns one Future per request.

        The batch is served exactly as composed - one queue item, one
        ``_serve_batch`` call, one atomic journal record - never merged
        with other arrivals or re-chunked by the watermark.  This is the
        wire shard's path: the transport gate seals composition (by
        count or explicit flush), and determinism of the journal record
        then makes failover reconstruct identical batches.
        """
        reqs = self._admit(requests)
        t0 = time.perf_counter()
        futs = [concurrent.futures.Future() for _ in reqs]
        self._enqueue(_SealedBatch([(r, f, t0) for r, f in zip(reqs, futs)]),
                      timeout)
        return futs

    def request(self, tenant_id: str, shape, sampler: str = "bits",
                out_dtype: str = "float32",
                timeout: Optional[float] = None):
        """Synchronous convenience: submit one request, wait, return."""
        return self.submit(RandRequest(
            tenant_id=tenant_id, shape=tuple(shape), sampler=sampler,
            out_dtype=out_dtype)).result(timeout)

    # -- dispatch loop -----------------------------------------------------

    def _loop(self) -> None:
        cfg = self.config
        stop = False
        while not stop:
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is _STOP:
                break
            if isinstance(item, _SealedBatch):
                # sealed composition: serve verbatim, never merge
                self._serve_batch(item.items)
                continue
            batch = [item]
            pending: Optional[_SealedBatch] = None
            deadline = time.perf_counter() + cfg.max_delay_s
            while len(batch) < cfg.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                if isinstance(nxt, _SealedBatch):
                    pending = nxt
                    break
                batch.append(nxt)
            self._serve_batch(batch)
            if pending is not None:
                self._serve_batch(pending.items)
        # stragglers racing the shutdown sentinel: fail, don't hang
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                continue
            items = item.items if isinstance(item, _SealedBatch) else [item]
            for it in items:
                it[1].set_exception(
                    ServiceClosed("RandServer is shut down"))
        for pool in self._pools.values():
            pool.close()
        if self.journal is not None:
            self.journal.flush()
        self._drained.set()

    def _serve_batch(self, batch: List) -> None:
        t_batch = time.perf_counter()
        if self._t_first is None:
            self._t_first = t_batch
        ready = []     # (fut, result-or-exc, is_error, t_submit)
        coalesce: List[RandRequest] = []
        futs: Dict[str, Tuple] = {}
        seen_rids = set()
        served: List[Assignment] = []          # batch order
        windows: List[Tuple[str, int, int]] = []
        for req, fut, t0 in batch:
            if req.rid in seen_rids:
                ready.append((fut, ValueError(
                    f"duplicate rid {req.rid!r} in one batch"), True, t0))
                continue
            seen_rids.add(req.rid)
            pool = self._pools.get(req.klass)
            if pool is not None and pool.can_serve(req.num_samples):
                try:
                    self.registry.charge(req.tenant_id, req.num_samples)
                except Exception as e:
                    ready.append((fut, e, True, t0))
                    continue
                try:
                    resp, asg, fresh = pool.serve(req)
                    if fresh:
                        windows.append(
                            (asg.channel, asg.lo, asg.lo + asg.rows))
                    served.append(asg)
                    ready.append((fut, resp, False, t0))
                except Exception as e:
                    # admission was charged but nothing served: refund
                    self.registry.refund(req.tenant_id, req.num_samples)
                    ready.append((fut, e, True, t0))
            else:
                coalesce.append(req)
                futs[req.rid] = (fut, t0)
        if coalesce:
            try:
                responses, asgs, errors = self.coalescer.flush(coalesce)
            except Exception as e:      # whole-batch failure
                responses, asgs, errors = {}, [], \
                    {r.rid: e for r in coalesce}
            # each class batch shares one [lo, lo+rows) lease
            seen_w = set()
            for a in asgs:
                if (a.channel, a.lo) not in seen_w:
                    seen_w.add((a.channel, a.lo))
                    windows.append((a.channel, a.lo, a.lo + a.rows))
            served.extend(asgs)
            for rid, (fut, t0) in futs.items():
                if rid in responses:
                    ready.append((fut, responses[rid], False, t0))
                else:
                    err = errors.get(
                        rid, RuntimeError(f"request {rid} not served"))
                    ready.append((fut, err, True, t0))
        # group commit, then durability before release: ONE atomic
        # batch record (composition + windows), ONE fsync, THEN resolve
        if self.journal is not None:
            if served:
                self.journal.append_batch(served, windows)
            self.journal.flush()
        t_done = time.perf_counter()
        self._t_last = t_done
        for fut, result, is_error, t0 in ready:
            self._latencies.append(t_done - t0)
            if is_error:
                self._failed += 1
                fut.set_exception(result)
            else:
                self._served += 1
                fut.set_result(result)

    # -- lifecycle / introspection ----------------------------------------

    def drain(self, timeout: Optional[float] = 60.0) -> bool:
        """Stop admissions, serve everything queued, close the pools.

        ``timeout=None`` waits until every admitted request is answered.
        Returns True once the loop has fully drained, False if the
        timeout elapsed first.
        """
        with self._close_lock:
            first = not self._closed.is_set()
            self._closed.set()     # submits now refuse; queue can only
                                   # shrink, so the put below completes
        self.start()               # a never-started server still drains
        if first:
            self._queue.put(_STOP)
        drained = self._drained.wait(timeout)
        if drained:
            self._thread.join(timeout)
        return drained

    def shutdown(self, timeout: Optional[float] = 60.0) -> bool:
        """Graceful drain; closes the journal (releasing its lock) only
        once the drain completed - a timed-out drain leaves the journal
        open so the still-running loop cannot write through a closed
        file.  Returns the drain result."""
        drained = self.drain(timeout)
        if drained and self.journal is not None:
            self.journal.close()
        return drained

    def __enter__(self) -> "RandServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def ledger_state(self) -> Dict[str, Any]:
        return self.block_service.ledger_state()

    def reset_metrics(self) -> None:
        """Zero the serving metrics (NOT the ledgers/quotas) so a
        benchmark can measure a steady-state window after warm-up."""
        self._latencies.clear()
        self._served = self._failed = 0
        self._t_first = self._t_last = None
        co = self.coalescer
        co.requests_served = co.engine_calls = co.lease_calls = 0
        co.samples_served = co.samples_generated = 0
        for p in self._pools.values():
            p.blocks_consumed = p.requests_served = 0

    def stats(self) -> Dict[str, Any]:
        """Serving metrics: requests/s, p50/p99 latency, coalescing."""
        lat = np.asarray(self._latencies, np.float64)
        span = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last else 0.0)
        pool_calls = sum(p.blocks_consumed for p in self._pools.values())
        pool_served = sum(p.requests_served for p in self._pools.values())
        co = self.coalescer.stats()
        total = max(1, self._served)
        calls = co["engine_calls"] + co["lease_calls"] + 2 * pool_calls
        return {
            "requests_served": self._served,
            "requests_failed": self._failed,
            "pool_requests": pool_served,
            "pool_hit_rate": pool_served / total,
            "requests_per_s": (self._served / span) if span > 0 else 0.0,
            "latency_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                               if lat.size else 0.0),
            "latency_p99_ms": (float(np.percentile(lat, 99)) * 1e3
                               if lat.size else 0.0),
            "engine_calls": co["engine_calls"] + pool_calls,
            "lease_calls": co["lease_calls"] + pool_calls,
            "calls_per_request": calls / total,
            "coalescing_factor": total / max(1, calls),
            "fill_ratio": co["fill_ratio"],
            "tenants": len(self.registry),
        }


def drain_signal_event(
        signals: Tuple[int, ...] = (signal_mod.SIGINT, signal_mod.SIGTERM)
) -> threading.Event:
    """Install handlers that set (and return) a ``threading.Event`` on
    the first delivery of any of ``signals`` - the trigger for a
    graceful drain.  SIGTERM is what process supervisors (and
    ``fleet.Fleet.stop``) send; SIGINT covers interactive ^C.  Main
    thread only (CPython restricts ``signal.signal``)."""
    stop = threading.Event()

    def _handler(signum, frame):
        stop.set()

    for s in signals:
        signal_mod.signal(s, _handler)
    return stop
