"""Block delivery: leased counter windows + double-buffered producers.

The paper's deployment is a standing producer streaming decorrelated
blocks through on-chip FIFOs into application kernels.  ``BlockService``
is the software form of that delivery layer, above the engine:

  * **Counter-window leases.**  Every consumer names a *channel* (one MISRN
    family of the service seed) and receives disjoint, checkpointable
    ``[lo, hi)`` windows of its counter space; an overlapping lease raises
    ``LeaseError``.
  * **A two-phase ledger.**  ``lease()`` reserves a window in memory;
    ``commit()`` moves it into the durable ledger.  ``ledger_state()``
    snapshots committed windows only, and ``restore_ledger()`` rewinds to
    a snapshot, after which re-leasing replays the same windows.  The
    snapshot is a plain dict of the same form as the reference's, so a
    reference snapshot restores here.
  * **Double-buffered generation.**  ``producer()`` runs a thread that
    leases window k+1 and launches its generation on a side CUDA stream
    while the consumer still holds block k; each block is handed over
    with an event that the consumer's stream waits on.

In eager PyTorch there is nothing to compile per window: each window is
one ``engine.generate`` (one kernel launch) at a static counter.

``estimate_pi`` / ``price_option`` run the paper's two applications on
leased draw windows: open, lease, run, commit (release on failure).
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.core import engine, sampler as sampler_mod, stream as tstream
from repro_torch.core.u64 import M64, U64Pair
from repro_torch.kernels import ops


class LeaseError(ValueError):
    """A lease request overlaps randomness that is already spoken for."""


def channel_purpose(name: str) -> int:
    """Deterministic 64-bit purpose tag for a channel name (stable across
    processes: the ledger must mean the same windows after a restart)."""
    return int.from_bytes(
        hashlib.blake2s(name.encode(), digest_size=8).digest(), "little")


# ---------------------------------------------------------------------------
# Lease + ledger
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Lease:
    """One disjoint counter window ``[lo, hi)`` of a channel.

    Example:
        >>> from repro_torch.runtime.blocks import BlockService
        >>> svc = BlockService(seed=11, device="cpu")
        >>> _ = svc.open("docs/demo", num_streams=2)
        >>> lease = svc.lease("docs/demo", 4)
        >>> (lease.lo, lease.hi, lease.length)
        (0, 4, 4)
        >>> lease.commit()
        >>> svc.lease("docs/demo", 4).lo
        4
    """
    channel: str
    lo: int
    hi: int
    service: "BlockService" = dataclasses.field(repr=False, compare=False)

    @property
    def length(self) -> int:
        return self.hi - self.lo

    def plan(self, **overrides) -> engine.GenPlan:
        """The engine plan for this window (plan channels only)."""
        return self.service.plan_for(self, **overrides)

    def stream(self, column: int = 0) -> tstream.ThunderStream:
        """ThunderStream for one column of the window, advanced to ``lo``."""
        return self.service.stream_for(self, column)

    def commit(self) -> None:
        self.service.commit(self)

    def release(self) -> None:
        self.service.release(self)


class _Ledger:
    """Disjoint-interval bookkeeping for one channel: ``committed`` is a
    sorted list of merged ``[lo, hi)`` windows, ``reserved`` the in-flight
    leases, ``floor`` the fence below which nothing may be leased."""

    def __init__(self) -> None:
        self.committed: List[Tuple[int, int]] = []
        self.reserved: List[Tuple[int, int]] = []
        self.floor = 0

    @property
    def next(self) -> int:
        hi = self.floor
        if self.committed:
            hi = max(hi, self.committed[-1][1])
        for _, h in self.reserved:
            hi = max(hi, h)
        return hi

    def _overlaps(self, lo: int, hi: int) -> Optional[Tuple[int, int]]:
        i = bisect.bisect_left(self.committed, (lo, lo)) - 1
        for j in (i, i + 1):
            if 0 <= j < len(self.committed):
                clo, chi = self.committed[j]
                if clo < hi and lo < chi:
                    return (clo, chi)
        for rlo, rhi in self.reserved:
            if rlo < hi and lo < rhi:
                return (rlo, rhi)
        return None

    def reserve(self, lo: int, hi: int) -> None:
        if lo < self.floor:
            raise LeaseError(
                f"window [{lo}, {hi}) starts below the fenced floor "
                f"{self.floor} (counters below the floor may already "
                f"have been served by a previous owner)")
        clash = self._overlaps(lo, hi)
        if clash is not None:
            raise LeaseError(
                f"window [{lo}, {hi}) overlaps existing lease "
                f"[{clash[0]}, {clash[1]})")
        self.reserved.append((lo, hi))

    def commit(self, lo: int, hi: int) -> None:
        try:
            self.reserved.remove((lo, hi))
        except ValueError:
            raise LeaseError(f"window [{lo}, {hi}) is not reserved") from None
        bisect.insort(self.committed, (lo, hi))
        merged: List[Tuple[int, int]] = []
        for w in self.committed:
            if merged and merged[-1][1] >= w[0]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], w[1]))
            else:
                merged.append(w)
        self.committed = merged

    def release(self, lo: int, hi: int) -> None:
        try:
            self.reserved.remove((lo, hi))
        except ValueError:
            raise LeaseError(f"window [{lo}, {hi}) is not reserved") from None

    def state(self) -> Dict[str, Any]:
        return {"committed": [[lo, hi] for lo, hi in self.committed],
                "floor": self.floor}

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "_Ledger":
        led = cls()
        led.committed = sorted((int(lo), int(hi))
                               for lo, hi in state.get("committed", []))
        led.floor = int(state.get("floor", 0))
        return led


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Channel:
    """One named consumer of the service's MISRN space: a *plan channel*
    (``window_fn is None``) generates (L, S) engine blocks per window; a
    *custom channel* delegates to ``window_fn(lo, hi)`` and uses the
    ledger for accounting only."""
    name: str
    purpose: int
    num_streams: int = 1
    mode: str = "ctr"
    deco: str = "splitmix64"
    sampler: str = "bits"
    out_dtype: str = "float32"
    window_fn: Optional[Callable[[int, int], Any]] = None


class BlockService:
    """Leased-window block delivery over one seed's MISRN stream space.

    ``mesh`` / ``axis_names`` route every plan-channel window through
    ``engine.generate_sharded`` (a 1-d or a 2-d ``("hosts", "streams")``
    fan-out of the columns, the root state shared, no collective): the
    paper's "add SOU instances" move.  ``axis_names`` defaults to the
    mesh's own.  Without a mesh, plans go through ``engine.generate`` on
    ``device`` with the service's backend override (chosen by the device
    when None); ``device`` also holds the channels' leaf tables.

    Example:
        >>> from repro_torch.runtime.blocks import BlockService
        >>> svc = BlockService(seed=11, device="cpu")
        >>> _ = svc.open("docs/demo", num_streams=4)
        >>> blk = svc.take("docs/demo", 8)
        >>> tuple(blk.shape)
        (8, 4)
        >>> svc.ledger_state()["channels"]["docs/demo"]["committed"]
        [[0, 8]]
    """

    def __init__(self, seed: int = 0, *,
                 mesh: Optional[engine.Mesh] = None,
                 axis_names: Optional[Tuple[str, ...]] = None,
                 backend: Optional[str] = None,
                 block_t: int = engine.DEFAULT_BLOCK_T, device=None):
        self.seed = seed
        self.mesh = mesh
        self.axis_names = (tuple(axis_names) if axis_names is not None
                           else (tuple(mesh.axis_names) if mesh is not None
                                 else None))
        self.backend = backend
        self.block_t = block_t
        self.device = engine.resolve_device(device)
        self._channels: Dict[str, Channel] = {}
        self._ledgers: Dict[str, _Ledger] = {}
        self._tables: Dict[str, Tuple[int, U64Pair]] = {}
        self._lock = threading.Lock()

    # -- channels ----------------------------------------------------------

    def open(self, name: str, *, num_streams: int = 1,
             purpose: Optional[int] = None, mode: str = "ctr",
             deco: str = "splitmix64", sampler: str = "bits",
             out_dtype: str = "float32",
             window_fn: Optional[Callable[[int, int], Any]] = None
             ) -> Channel:
        """Open (or return the already-open) channel ``name``."""
        with self._lock:
            if name in self._channels:
                return self._channels[name]
            ch = Channel(name=name,
                         purpose=(channel_purpose(name) if purpose is None
                                  else purpose),
                         num_streams=num_streams, mode=mode, deco=deco,
                         sampler=sampler, out_dtype=out_dtype,
                         window_fn=window_fn)
            self._channels[name] = ch
            self._ledgers.setdefault(name, _Ledger())
            return ch

    def channel(self, name: str) -> Channel:
        return self._channels[name]

    # -- leases ------------------------------------------------------------

    def _check_open(self, name: str) -> None:
        if name not in self._channels:
            raise KeyError(f"channel {name!r} is not open; "
                           f"have {sorted(self._channels)}")

    def lease(self, name: str, length: int, *,
              at: Optional[int] = None) -> Lease:
        """Reserve the next (or an explicit ``at``) disjoint window."""
        if length <= 0:
            raise ValueError(f"lease length must be positive, got {length}")
        self._check_open(name)
        with self._lock:
            led = self._ledgers[name]
            lo = led.next if at is None else int(at)
            hi = lo + length
            if hi > M64:
                raise LeaseError(f"window [{lo}, {hi}) exceeds the u64 "
                                 f"counter space")
            led.reserve(lo, hi)
        return Lease(channel=name, lo=lo, hi=hi, service=self)

    def lease_many(self, name: str, length: int, n: int, *,
                   at: Optional[int] = None) -> List[Lease]:
        """``n`` contiguous equal-length windows, reserved all or none."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if length <= 0:
            raise ValueError(f"lease length must be positive, got {length}")
        self._check_open(name)
        with self._lock:
            led = self._ledgers[name]
            lo0 = led.next if at is None else int(at)
            if lo0 + n * length > M64:
                raise LeaseError(f"window [{lo0}, {lo0 + n * length}) "
                                 f"exceeds the u64 counter space")
            done: List[Tuple[int, int]] = []
            try:
                for i in range(n):
                    lo = lo0 + i * length
                    led.reserve(lo, lo + length)
                    done.append((lo, lo + length))
            except LeaseError:
                for lo, hi in done:
                    led.release(lo, hi)
                raise
        return [Lease(channel=name, lo=lo, hi=hi, service=self)
                for lo, hi in done]

    def commit(self, lease: Lease) -> None:
        """Move a reserved window into the durable ledger."""
        with self._lock:
            self._ledgers[lease.channel].commit(lease.lo, lease.hi)

    def release(self, lease) -> None:
        """Drop an unconsumed reservation, or, given a channel name, retire
        the channel: its floor is fenced at its high-water mark (so a
        later occupant of the name never overlaps anything leased before)
        and its entry is dropped; live reservations refuse the retire."""
        if isinstance(lease, str):
            return self._release_channel(lease)
        with self._lock:
            self._ledgers[lease.channel].release(lease.lo, lease.hi)

    def _release_channel(self, name: str) -> int:
        with self._lock:
            self._check_open(name)
            led = self._ledgers[name]
            if led.reserved:
                raise LeaseError(
                    f"channel {name!r} has {len(led.reserved)} live "
                    f"reservation(s); close its producers before release")
            led.floor = led.next
            del self._channels[name]
            self._tables.pop(name, None)
            return led.floor

    # -- ledger checkpointing ---------------------------------------------

    def ledger_state(self) -> Dict[str, Any]:
        """JSON-able snapshot of COMMITTED windows per channel."""
        with self._lock:
            return {"channels": {name: led.state()
                                 for name, led in self._ledgers.items()}}

    def restore_ledger(self, state: Optional[Dict[str, Any]]) -> None:
        """Rewind the ledger to a snapshot (or clear it with None / {});
        every reservation vanishes, so close producers first."""
        chans = (state or {}).get("channels", {})
        with self._lock:
            self._ledgers = {name: _Ledger.from_state(s)
                             for name, s in chans.items()}
            for name in self._channels:
                self._ledgers.setdefault(name, _Ledger())

    def fence(self, name: str, floor: int) -> int:
        """Raise channel ``name``'s lease floor to at least ``floor``."""
        with self._lock:
            led = self._ledgers.setdefault(name, _Ledger())
            led.floor = max(led.floor, int(floor))
            return led.floor

    # -- generation --------------------------------------------------------

    def plan_for(self, lease: Lease, *, sampler: Optional[str] = None,
                 out_dtype: Optional[str] = None) -> engine.GenPlan:
        """Engine plan for a leased window (plan channels)."""
        return self._plan(self._plan_channel(lease.channel), lease.lo,
                          lease.length, sampler, out_dtype)

    def stream_for(self, lease: Lease, column: int = 0
                   ) -> tstream.ThunderStream:
        ch = self._channels[lease.channel]
        fam = tstream.new_stream(self.seed, ch.purpose, device=self.device)
        return tstream.advance(tstream.derive(fam, column), lease.lo)

    def _plan_channel(self, name: str) -> Channel:
        ch = self._channels[name]
        if ch.window_fn is not None:
            raise ValueError(f"channel {name!r} has a custom window_fn; "
                             f"it has no engine plan")
        return ch

    def _plan(self, ch: Channel, lo: int, length: int,
              sampler: Optional[str], out_dtype: Optional[str]
              ) -> engine.GenPlan:
        """Static-counter plan; the channel's leaf table is built once."""
        with self._lock:
            cached = self._tables.get(ch.name)
            if cached is None:
                x0, h_fam = engine.family_from_seed(self.seed, ch.purpose)
                cached = (x0, engine.leaf_table(h_fam, ch.num_streams,
                                                self.device))
                self._tables[ch.name] = cached
        x0, h = cached
        return engine.GenPlan(
            x0=x0, h=h, num_steps=length, ctr=lo & M64, mode=ch.mode,
            deco=ch.deco, sampler=ch.sampler if sampler is None else sampler,
            out_dtype=ch.out_dtype if out_dtype is None else out_dtype)

    def generate(self, lease: Lease, *, sampler: Optional[str] = None,
                 out_dtype: Optional[str] = None,
                 retired: Optional[torch.Tensor] = None) -> Any:
        """The block for a leased window, launched and not waited on.

        Plan channels return the (length, S) block; custom channels
        ``window_fn(lo, hi)``.  ``retired`` - a tensor of the output's
        shape and dtype, typically the block the consumer just finished
        with - is overwritten in place and returned (donated ring).
        """
        ch = self._channels[lease.channel]
        if ch.window_fn is not None:
            if retired is not None:
                raise ValueError(f"channel {lease.channel!r} has a custom "
                                 f"window_fn; donation needs a plan channel")
            return ch.window_fn(lease.lo, lease.hi)
        if retired is not None and self.mesh is not None:
            raise ValueError("donated windows require mesh=None; sharded "
                             "delivery manages its own output buffers")
        plan = self._plan(ch, lease.lo, lease.length, sampler, out_dtype)
        return self._generate(plan, out=retired)

    def _generate(self, plan: engine.GenPlan,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One window: sharded over the mesh, or one ``engine.generate``."""
        if self.mesh is not None:
            return engine.generate_sharded(
                plan, mesh=self.mesh, axis_names=self.axis_names,
                backend=self.backend, block_t=self.block_t)
        return engine.generate(plan, backend=self.backend,
                               block_t=self.block_t, out=out)

    def generate_many(self, leases: List[Lease], *,
                      sampler: Optional[str] = None,
                      out_dtype: Optional[str] = None,
                      retired: Optional[torch.Tensor] = None) -> Any:
        """(W, L, S) stack for W contiguous equal-length leases of one plan
        channel: ONE ``generate_windows`` launch."""
        if not leases:
            raise ValueError("generate_many needs at least one lease")
        ch = self._channels[leases[0].channel]
        if ch.window_fn is not None:
            raise ValueError(f"channel {leases[0].channel!r} has a custom "
                             f"window_fn; fused generation needs a plan "
                             f"channel")
        L = leases[0].length
        for a, b in zip(leases, leases[1:]):
            if b.channel != a.channel or b.length != L or b.lo != a.hi:
                raise ValueError(
                    "generate_many needs contiguous equal-length leases of "
                    f"one channel; got [{a.lo},{a.hi}) then [{b.lo},{b.hi}) "
                    f"on {a.channel!r}/{b.channel!r}")
        if self.mesh is not None:
            if len(leases) > 1 or retired is not None:
                raise ValueError("fused/donated window functions require "
                                 "mesh=None; sharded delivery manages its "
                                 "own output buffers")
            return self.generate(leases[0], sampler=sampler,
                                 out_dtype=out_dtype)[None]
        plan = self._plan(ch, leases[0].lo, L, sampler, out_dtype)
        return engine.generate_windows(plan, len(leases),
                                       backend=self.backend,
                                       block_t=self.block_t, out=retired)

    def regenerate(self, name: str, lo: int, length: int, *,
                   sampler: Optional[str] = None,
                   out_dtype: Optional[str] = None) -> Any:
        """The block for an already-durable window: no lease, no ledger."""
        ch = self._channels[name]
        if ch.window_fn is not None:
            return ch.window_fn(lo, lo + length)
        return self._generate(self._plan(ch, lo, length, sampler, out_dtype))

    def take(self, name: str, length: int, **kw) -> Any:
        """lease + generate + commit in one call (synchronous consumers)."""
        lease = self.lease(name, length)
        try:
            block = self.generate(lease, **kw)
        except Exception:
            self.release(lease)
            raise
        self.commit(lease)
        return block

    def producer(self, name: str, block_len: int, *, depth: int = 1,
                 count: Optional[int] = None, start: Optional[int] = None,
                 donate: bool = False, fuse: int = 1,
                 check_ring: bool = False, **gen_kw) -> "BlockProducer":
        """Double-buffered producer over successive leased windows (see
        ``BlockProducer``); ``start`` pins the first window."""
        return BlockProducer(self, name, block_len, depth=depth,
                             count=count, start=start, donate=donate,
                             fuse=fuse, check_ring=check_ring, **gen_kw)


# ---------------------------------------------------------------------------
# Double-buffered producer
# ---------------------------------------------------------------------------

def _tensors(block: Any):
    """The tensors of a block: itself, or the leaves of a custom
    channel's dict / list / tuple."""
    if isinstance(block, torch.Tensor):
        yield block
    elif isinstance(block, dict):
        for v in block.values():
            yield from _tensors(v)
    elif isinstance(block, (list, tuple)):
        for v in block:
            yield from _tensors(v)


class BlockProducer:
    """Standing producer thread: block k+1 is leased and launched while the
    consumer holds block k (the paper's FIFO-into-application pipeline).

    On a card the thread launches on its own CUDA stream and hands each
    block over with an event; ``__next__`` makes the consumer's current
    stream wait on that event (no host synchronisation) and marks the
    block as used there.  Iterating yields ``(lease, block)`` and commits
    the lease at handoff.

      * ``fuse=W`` leases W contiguous windows at once and generates their
        (W, L, S) stack in ONE launch; blocks are handed over per window
        and committed per window.
      * ``donate=True`` writes every stack into a ring of preallocated
        buffers, ``ceil(depth / fuse) + 2`` of them (queue depth + the
        consumer's live stack + the one being written): no allocation in
        the steady state.  A yielded block is valid until the NEXT
        ``__next__`` call.  A buffer goes back to the producer when the
        consumer moves past its last window, with an event recorded on the
        consumer's stream; the producer's stream waits on that event
        before writing the buffer again.  A short tail (count % fuse) is
        generated into a fresh tensor.

    Example:
        >>> from repro_torch.runtime.blocks import BlockService
        >>> svc = BlockService(seed=11, device="cpu")
        >>> _ = svc.open("docs/demo", num_streams=2)
        >>> with svc.producer("docs/demo", 4, count=4, fuse=2) as prod:
        ...     lows = [lease.lo for lease, _ in prod]
        >>> lows
        [0, 4, 8, 12]
    """

    def __init__(self, service: BlockService, name: str, block_len: int, *,
                 depth: int = 1, count: Optional[int] = None,
                 start: Optional[int] = None, donate: bool = False,
                 fuse: int = 1, check_ring: bool = False, **gen_kw):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        fuse = int(fuse)
        if fuse < 1:
            raise ValueError(f"fuse must be >= 1, got {fuse}")
        if (donate or fuse > 1) and service.mesh is not None:
            raise ValueError("donate/fuse producers require a mesh-less "
                             "service; sharded delivery manages its own "
                             "buffers")
        self._service = service
        self._name = name
        self._block_len = block_len
        self._count = count
        self._pos = start
        self._donate = donate
        self._fuse = fuse
        self._check_ring = check_ring
        self._gen_kw = gen_kw
        self._cuda = service.device.type == "cuda"
        self._side = (torch.cuda.Stream(device=service.device)
                      if self._cuda else None)
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._recycle: "queue.Queue" = queue.Queue()
        self._ring_ptrs: set = set()
        self._held: Any = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._produced = 0
        if donate:
            ch = service.channel(name)
            if ch.window_fn is not None:
                raise ValueError(f"channel {name!r} has a custom window_fn; "
                                 f"donation needs a plan channel")
            s = gen_kw.get("sampler") or ch.sampler
            d = gen_kw.get("out_dtype") or ch.out_dtype
            dtype = sampler_mod.result_dtype(sampler_mod.parse(s), d)
            shape = ((block_len, ch.num_streams) if fuse == 1
                     else (fuse, block_len, ch.num_streams))
            for _ in range(-(-depth // fuse) + 2):
                buf = torch.empty(shape, dtype=dtype, device=service.device)
                self._ring_ptrs.add(buf.data_ptr())
                self._recycle.put((buf, self._event()))
        self._thread = threading.Thread(
            target=self._work, name=f"blocks:{name}", daemon=True)
        self._thread.start()

    def _event(self) -> Optional[torch.cuda.Event]:
        """An event recorded now on the calling thread's current stream."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._service.device))
        return ev

    def _get_retired(self) -> Optional[torch.Tensor]:
        """Next free ring buffer, ordered after its retirement (None once
        stop is requested)."""
        while not self._stop.is_set():
            try:
                buf, ev = self._recycle.get(timeout=0.1)
            except queue.Empty:
                continue
            if ev is not None:
                self._side.wait_event(ev)
            return buf
        return None

    def _put(self, item) -> bool:
        """queue.put with stop-polling; False once stop is requested."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self) -> None:
        try:
            if self._cuda:
                with torch.cuda.stream(self._side):
                    self._loop()
            else:
                self._loop()
        except BaseException as e:  # surfaced in the consumer thread
            self._error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._queue.put(None, timeout=0.1)  # end of stream
                    break
                except queue.Full:
                    continue

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._count is not None and self._produced >= self._count:
                break
            n = self._fuse
            if self._count is not None:
                n = min(n, self._count - self._produced)
            retired = wait = None
            if self._donate and n == self._fuse:
                with trace.span("blocks.ring_wait") as wait:
                    retired = self._get_retired()
                if retired is None:  # stopping
                    break
            with trace.span("blocks.launch") as launch:
                leases: List[Lease] = []
                try:
                    leases = self._service.lease_many(
                        self._name, self._block_len, n, at=self._pos)
                    launch.key = leases[0].lo
                    if wait is not None:
                        wait.key = launch.key
                    if self._pos is not None:
                        self._pos += n * self._block_len
                    if self._fuse == 1:
                        # a custom channel's window may be any tensor tree
                        stack = self._service.generate(
                            leases[0], retired=retired, **self._gen_kw)
                        outs = [stack]
                    else:
                        stack = self._service.generate_many(
                            leases, retired=retired, **self._gen_kw)
                        outs = [stack[w] for w in range(n)]
                except BaseException:
                    if retired is not None:
                        self._recycle.put((retired, self._event()))
                    for lease in leases:
                        self._service.release(lease)
                    raise
            if (self._check_ring and retired is not None
                    and stack.data_ptr() not in self._ring_ptrs):
                raise AssertionError(
                    f"donated block escaped the buffer ring: "
                    f"{stack.data_ptr():#x} not in "
                    f"{sorted(map(hex, self._ring_ptrs))}")
            ready = self._event()
            self._produced += n
            with trace.span("blocks.put_wait", key=leases[0].lo):
                for w in range(n):
                    last = retired if w == n - 1 else None
                    if not self._put((leases[w], outs[w], ready, last)):
                        for lease in leases[w:]:
                            self._service.release(lease)
                        return

    def __iter__(self) -> "BlockProducer":
        return self

    def __next__(self) -> Tuple[Lease, Any]:
        with trace.span("blocks.next") as sp:
            lease, block = self._take()
            sp.key = lease.lo
            return lease, block

    def _take(self) -> Tuple[Lease, Any]:
        while True:
            if self._error is not None and self._queue.empty():
                err, self._error = self._error, None
                raise err
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                raise StopIteration
            lease, block, ready, ring_buf = item
            if self._cuda:
                consumer = torch.cuda.current_stream(self._service.device)
                consumer.wait_event(ready)
                for t in _tensors(block):
                    t.record_stream(consumer)
            self._service.commit(lease)
            self._retire_held()
            self._held = ring_buf
            return lease, block

    def _retire_held(self) -> None:
        """Hand the ring buffer whose last window the consumer just moved
        past back to the producer, ordered after the consumer's work."""
        if self._held is not None:
            self._recycle.put((self._held, self._event()))
            self._held = None

    def close(self) -> None:
        """Stop the thread and release every unconsumed reservation."""
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._side is not None:
            # ring buffers may be freed once this returns
            self._side.synchronize()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._service.release(item[0])

    def __enter__(self) -> "BlockProducer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Leased Monte-Carlo app entry points (paper Sec. 6 consumers)
# ---------------------------------------------------------------------------

def _leased_app(service: BlockService, channel: str, num_streams: int,
                length: int, fn: Callable[[Lease], Any]) -> Any:
    """open + lease + run + commit (release on failure): the lifecycle of
    every synchronous leased consumer."""
    trace.count("blocks.apps")
    with trace.span("blocks.app") as sp:
        service.open(channel, num_streams=num_streams)
        lease = service.lease(channel, length)
        sp.key = lease.lo
        try:
            result = fn(lease)
        except Exception:
            service.release(lease)
            raise
        service.commit(lease)
        return result


def estimate_pi(service: BlockService, *, num_lanes: int,
                draws_per_lane: int, **kw) -> torch.Tensor:
    """MC pi over a leased draw window on the service's device: repeated
    calls consume fresh, disjoint randomness of the service family (window
    units = draws per lane; the x/y coordinate purposes share the
    window)."""
    return _leased_app(
        service, "mc/pi", num_lanes, draws_per_lane,
        lambda lease: ops.estimate_pi(
            seed=service.seed, num_lanes=num_lanes,
            draws_per_lane=draws_per_lane, offset=lease.lo,
            device=service.device, **kw))


def price_option(service: BlockService, *, num_lanes: int,
                 draws_per_lane: int, **kw) -> torch.Tensor:
    """Leased-window Black-Scholes MC (see ``estimate_pi``)."""
    return _leased_app(
        service, "mc/option", num_lanes, draws_per_lane,
        lambda lease: ops.price_option(
            seed=service.seed, num_lanes=num_lanes,
            draws_per_lane=draws_per_lane, offset=lease.lo,
            device=service.device, **kw))
