"""Append-only request journal: crash -> replay -> bit-identical bytes.

Counter addressing makes a randomness service auditable in a way a
stateful generator never is: a response is a pure function of its
*assignment* — ``(seed, channel, leaf tags, counter window, sampler,
dtype)`` — so an append-only log of assignments IS a complete backup
of every byte the service ever served.  The journal writes two kinds
of records:

  * ``window``  — one per committed class-channel lease (the lease
    ledger made durable: ``ledger_state()`` rebuilds the exact
    committed-window set, so a restarted service re-opens its ledgers
    with every consumed window still fenced off), and
  * ``request`` — one per served request (the
    ``frontend.Assignment``), flushed+fsynced before the response is
    released to the caller, and
  * ``batch``   — one per served *microbatch* (group commit): the
    batch's composition (its request assignments, in batch order) plus
    every window it consumed, as ONE JSON line.  A single line is
    atomic under the torn-tail repair — either the whole batch is
    durable or none of it is — so a crashed server's journal is always
    batch-aligned, which is what lets a failover peer re-form the
    identical microbatches (and hence identical assignments) for the
    un-journaled suffix.  One record = one write = one fsync per
    batch instead of one per request.

``replay`` regenerates every journaled response through plain
``engine.generate`` - one stand-alone plan of just that request's tags,
never the serving path's batched call - so the replay check is also an
independence check on the serving path.

The JSON-lines format is the reference's byte for byte (``json.dumps``
with sorted keys, one record per line), so a journal written by
``repro.service.audit`` loads, restores and replays here, and the
reverse.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.u64 import M64
from repro_torch.runtime import blocks
from repro_torch.service.frontend import (Assignment, host_block,
                                          slice_response)

try:                               # POSIX only; fencing degrades to a
    import fcntl                   # no-op where flock does not exist
except ImportError:                # pragma: no cover - non-POSIX
    fcntl = None


def _request_record(a: Assignment) -> Dict[str, Any]:
    """The JSON-able journal form of one assignment (shared by the
    per-request ``request`` records and the members of ``batch``
    records, so ``replay_entry`` handles both identically)."""
    return {"kind": "request", "rid": a.rid,
            "tenant": a.tenant_id, "sampler": a.sampler,
            "dtype": a.out_dtype, "shape": list(a.shape),
            "channel": a.channel, "lo": int(a.lo),
            "rows": int(a.rows), "tags": [int(t) for t in a.tags],
            "deco": a.deco}


def _iter_requests(entries: Iterable[Dict[str, Any]]
                   ) -> Iterable[Dict[str, Any]]:
    """Every request record in ``entries``, expanding batch records."""
    for e in entries:
        if e["kind"] == "request":
            yield e
        elif e["kind"] == "batch":
            yield from e["requests"]


class JournalLockedError(RuntimeError):
    """Another live process holds this journal's exclusive lock.

    Exactly one process may ever append to a journal: two writers would
    silently interleave windows and requests, corrupting the replay
    record.  The lock doubles as the fleet's *fencing* primitive — a
    failover peer adopts a dead shard by taking its journal lock, which
    the OS only releases when the owning process is actually gone.
    """


class Journal:
    """Append-only JSONL journal (or in-memory when ``path`` is None).

    Re-opening an existing path loads its records first and appends
    after them — the restart flow is ``Journal(path)`` followed by
    ``restore_into(service)`` and, when responses must be re-served,
    ``replay(journal, seed=...)``.

    Opening a path takes an exclusive ``flock`` held for the journal's
    lifetime (:class:`JournalLockedError` if another process has it);
    ``readonly=True`` skips the lock and the append handle — an
    auditor's view that can inspect a journal another process is
    actively writing.

    Example:
        >>> from repro_torch.service.audit import Journal
        >>> j = Journal()                      # in-memory
        >>> j.append_window("service/class/bits/float32", 0, 8)
        >>> [e["kind"] for e in j.entries]
        ['window']
    """

    def __init__(self, path: Optional[str] = None, *,
                 readonly: bool = False):
        self.path = path
        self.readonly = readonly
        self._entries: List[Dict[str, Any]] = []
        self._fh = None
        self._rid_entries: Dict[str, Dict[str, Any]] = {}
        self._rid_cursor = 0
        if path is None:
            return
        if readonly:
            if os.path.exists(path):
                self._load(path, repair=False)
            return
        # lock BEFORE the torn-tail repair: a second writer must fail
        # here, not interleave its own repair/appends with ours
        self._fh = open(path, "a", encoding="utf-8")
        if fcntl is not None:
            try:
                fcntl.flock(self._fh.fileno(),
                            fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                fh, self._fh = self._fh, None
                fh.close()
                raise JournalLockedError(
                    f"journal {path!r} is locked by another live "
                    f"process; a journal has exactly one writer "
                    f"(fence the owner before adopting its journal)")
        self._load(path, repair=True)

    def _load(self, path: str, *, repair: bool) -> None:
        with open(path, "rb") as f:
            raw_lines = f.read().splitlines(keepends=True)
        good_bytes = 0
        for i, bline in enumerate(raw_lines):
            line = bline.strip()
            if not line:
                good_bytes += len(bline)
                continue
            try:
                self._entries.append(json.loads(line))
            except (json.JSONDecodeError, UnicodeDecodeError):
                if i == len(raw_lines) - 1:
                    break   # torn final line: crashed mid-write
                raise
            good_bytes += len(bline)
        if not repair:
            return
        if good_bytes < sum(len(b) for b in raw_lines):
            with open(path, "r+b") as f:
                f.truncate(good_bytes)  # drop the torn tail
        elif raw_lines and not raw_lines[-1].endswith(b"\n"):
            # crash AFTER the final brace but before the newline:
            # the record is complete — terminate its line so the
            # next append cannot concatenate onto it
            with open(path, "ab") as f:
                f.write(b"\n")

    @property
    def entries(self) -> List[Dict[str, Any]]:
        return list(self._entries)

    def _append(self, record: Dict[str, Any]) -> None:
        self._entries.append(record)
        if self._fh is not None:
            self._fh.write(json.dumps(record, sort_keys=True) + "\n")

    def append_window(self, channel: str, lo: int, hi: int) -> None:
        """Record one committed class-channel counter window."""
        self._append({"kind": "window", "channel": channel,
                      "lo": int(lo), "hi": int(hi)})

    def append_request(self, a: Assignment) -> None:
        """Record one served request's assignment."""
        self._append(_request_record(a))

    def append_batch(self, assignments: List[Assignment],
                     windows: Iterable[Tuple[str, int, int]]) -> None:
        """Record one served microbatch as ONE atomic line (group commit).

        ``assignments`` is the batch's composition in batch order;
        ``windows`` the (channel, lo, hi) counter windows the batch
        consumed (class-channel leases and freshly pulled pool blocks).
        The torn-tail repair drops a partial line wholly, so a journal
        can never hold half a batch — the invariant the fleet's
        deterministic-handoff protocol rests on.
        """
        self._append({
            "kind": "batch",
            "rids": sorted(a.rid for a in assignments),
            "windows": [{"channel": c, "lo": int(lo), "hi": int(hi)}
                        for c, lo, hi in windows],
            "requests": [_request_record(a) for a in assignments],
        })

    def flush(self) -> None:
        """Make everything appended so far durable (fsync) — called by
        the frontend BEFORE responses are handed to callers."""
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        """Close the append handle — which also releases the exclusive
        journal lock, letting the next writer (restart or failover
        peer) take ownership."""
        if self._fh is not None:
            self._fh.close()        # flock released with the descriptor
            self._fh = None

    def requests(self) -> List[Dict[str, Any]]:
        """Every request record, batch members expanded in batch order."""
        return list(_iter_requests(self._entries))

    def find_request(self, rid: str) -> Optional[Dict[str, Any]]:
        """The journaled request record for ``rid`` (``None`` if never
        journaled).  Incremental index over the live entry list, so the
        fleet's idempotent-retry path (a resubmitted rid is answered by
        replay, never served twice) stays O(1) amortized."""
        while self._rid_cursor < len(self._entries):
            e = self._entries[self._rid_cursor]
            self._rid_cursor += 1
            for r in _iter_requests([e]):
                self._rid_entries[r["rid"]] = r
        return self._rid_entries.get(rid)

    def windows(self) -> List[Dict[str, Any]]:
        """Every window record, batch-consumed windows expanded."""
        out: List[Dict[str, Any]] = []
        for e in self._entries:
            if e["kind"] == "window":
                out.append(e)
            elif e["kind"] == "batch":
                out.extend(e["windows"])
        return out

    def ledger_state(self) -> Dict[str, Any]:
        """The ``BlockService.restore_ledger`` state implied by the
        journal: every journaled window, merged per channel."""
        per: Dict[str, List] = {}
        for w in self.windows():
            per.setdefault(w["channel"], []).append((w["lo"], w["hi"]))
        channels = {}
        for name, wins in per.items():
            merged: List[List[int]] = []
            for lo, hi in sorted(wins):
                if merged and merged[-1][1] >= lo:
                    merged[-1][1] = max(merged[-1][1], hi)
                else:
                    merged.append([lo, hi])
            channels[name] = {"committed": merged, "floor": 0}
        return {"channels": channels}

    def restore_into(self, service: blocks.BlockService, *,
                     fence: bool = False) -> None:
        """Fence off every journaled window in a (fresh) BlockService so
        a restarted server leases strictly new counters.

        ``fence=True`` additionally raises each channel's lease *floor*
        to its journaled high-water mark (``BlockService.fence``): even
        an explicit ``lease(at=...)`` into a gap below it is refused —
        the guarantee a failover peer needs before resuming a dead
        shard's tenant regions.
        """
        state = self.ledger_state()
        service.restore_ledger(state)
        if fence:
            for name, led in state.get("channels", {}).items():
                wins = led.get("committed", [])
                if wins:
                    service.fence(name, max(int(hi) for _, hi in wins))


def _entries_of(journal: Union[Journal, str, Iterable[Dict[str, Any]]]
                ) -> List[Dict[str, Any]]:
    if isinstance(journal, Journal):
        return journal.entries
    if isinstance(journal, str):
        # an auditor's read, never a write: no lock, no tail repair —
        # replay over a path works even while the owner is still live
        return Journal(journal, readonly=True).entries
    return list(journal)


def replay(journal: Union[Journal, str, Iterable[Dict[str, Any]]], *,
           seed: int, backend: Optional[str] = None, device=None
           ) -> Dict[str, Any]:
    """Regenerate every journaled response, bit-identically.

    Independent of the live serving path: each request becomes its own
    stand-alone ``GenPlan`` (its tags only, static counter) through
    ``engine.generate`` - counter addressing guarantees the bytes match
    what the batched call served.  ``backend`` None lets the engine pick
    (``"cuda"`` on the card, ``"torch"`` on the CPU).  Responses come
    back on the host: numpy arrays, or CPU tensors for bfloat16, which
    numpy has no type for.

    Example:
        >>> from repro_torch.service.audit import Journal, replay
        >>> from repro_torch.service.frontend import Assignment
        >>> j = Journal()
        >>> j.append_request(Assignment(
        ...     rid="r0", tenant_id="alice", sampler="bits",
        ...     out_dtype="float32", shape=(4,), channel="demo", lo=0,
        ...     rows=8, tags=(3,)))
        >>> replay(j, seed=5, device="cpu")["r0"].shape
        (4,)
    """
    out: Dict[str, Any] = {}
    for e in _iter_requests(_entries_of(journal)):
        out[e["rid"]] = replay_entry(e, seed=seed, backend=backend,
                                     device=device)
    return out


def replay_entry(e: Dict[str, Any], *, seed: int,
                 backend: Optional[str] = None, device=None) -> Any:
    """Regenerate ONE journaled request record, bit-identically.

    The plan is the request's own ``len(tags)`` columns (no batch
    padding, no gathered neighbours): leaf offsets derived on the host
    from the channel's family, the counter window ``[lo, lo + rows)``.
    """
    purpose = blocks.channel_purpose(e["channel"])
    x0, h_fam = engine.family_from_seed(seed, purpose)
    tags = e["tags"]
    h = engine.leaf_limbs([engine.derive_leaf_host(h_fam, t) for t in tags],
                          engine.resolve_device(device))
    plan = engine.GenPlan(
        x0=x0, h=h, num_steps=int(e["rows"]), ctr=int(e["lo"]) & M64,
        mode="ctr", deco=e.get("deco", "splitmix64"), sampler=e["sampler"],
        out_dtype=e["dtype"])
    block = host_block(engine.generate(plan, backend=backend))
    shape = tuple(e["shape"])
    n = 1
    for d in shape:
        n *= d
    return slice_response(block, 0, len(tags), n, shape)


def response_digest(responses: Dict[str, Any]) -> str:
    """Order-independent sha256 over (rid, dtype, shape, bytes) - the
    cross-run determinism check.  Takes numpy arrays or torch tensors and
    hashes both alike (dtype by its bare name, shape as a tuple), so a
    digest over the reference's numpy responses equals one over the
    port's."""
    h = hashlib.sha256()
    for rid in sorted(responses):
        a = responses[rid]
        if isinstance(a, torch.Tensor):
            t = a.detach().cpu().contiguous()
            dtype = str(t.dtype).replace("torch.", "")
            shape = tuple(t.shape)
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        else:
            a = np.asarray(a)
            dtype, shape, raw = str(a.dtype), a.shape, a.tobytes()
        h.update(rid.encode())
        h.update(dtype.encode())
        h.update(str(shape).encode())
        h.update(raw)
    return h.hexdigest()


def verify_ledger_disjoint(state_or_service) -> Dict[str, int]:
    """Assert every committed window in a ledger state (or a live
    ``BlockService``) is well-formed and pairwise disjoint; returns the
    per-channel window count.  This is the acceptance check "zero
    counter-window overlap, ledger-verified" as an executable."""
    if isinstance(state_or_service, Journal):
        # the journal's RAW (unmerged) windows: each lease as recorded
        per: Dict[str, List] = {}
        for w in state_or_service.windows():
            per.setdefault(w["channel"], []).append((w["lo"], w["hi"]))
        state = {"channels": {n: {"committed": ws}
                              for n, ws in per.items()}}
    else:
        state = (state_or_service.ledger_state()
                 if hasattr(state_or_service, "ledger_state")
                 else state_or_service)
    counts: Dict[str, int] = {}
    for name, led in state.get("channels", {}).items():
        wins = [(int(lo), int(hi)) for lo, hi in led.get("committed", [])]
        prev_hi = None
        for lo, hi in sorted(wins):
            if lo >= hi:
                raise blocks.LeaseError(
                    f"{name}: malformed window [{lo}, {hi})")
            if prev_hi is not None and lo < prev_hi:
                raise blocks.LeaseError(
                    f"{name}: window [{lo}, {hi}) overlaps previous "
                    f"ending at {prev_hi}")
            prev_hi = hi
        counts[name] = len(wins)
    return counts
