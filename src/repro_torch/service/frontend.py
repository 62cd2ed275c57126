"""Request coalescing: many small heterogeneous requests, few engine calls.

A randomness request is tiny - "tenant X wants an (8, 17) float32
uniform block" - and a service that made one engine call per request
would spend its life in launch overhead.  Every sample is
counter-addressed, a pure function of ``(x0, h_tag, ctr + t)``, and
columns are the cheap axis (the paper's SOU-instance scaling), so the
coalescer packs a microbatch into one gathered-tag ``engine.generate``
per request class:

  * requests are grouped by class ``(sampler, out_dtype)``; each class
    owns one ``BlockService`` channel (``class_channel``: one ``GenPlan``
    family of the service seed, shared by all tenants),
  * the batch leases ONE counter window ``[lo, lo + T)`` on the class
    channel's ledger, ``T`` the largest quantized row count
    (``request_rows``) of the class's requests,
  * each request gets ``ceil(n / T)`` columns - leaf tags from its
    tenant's private region (``service.tenants``), packed per tenant in
    request order - and the class becomes one ``(T, S)`` plan whose tags
    are padded to a power of two with the last tag repeated,
  * responses are column-major slices (``slice_response``).

A request's bytes depend only on its ``Assignment`` (channel, counter
window, tags), never on the batch it rode in: the journal
(``service.audit``) records assignments and replays each through a plain
``engine.generate`` of its own tags.  The JSON journal is the reference's
byte for byte, so journals replay across the two packages.

The reference jit-compiles one window function per shape class and keeps
an LRU of them; in eager torch nothing compiles, and an entry of the same
LRU (bounded at ``window_fn_cache_size``, keyed alike) holds what is fixed
per class - the family's ``x0`` and ``h``, the purpose and the
decorrelator - while the tags' leaf offsets are derived on the device per
call.  Tenants choose sampler specs, so the class space is unbounded and
the cache must not be.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine, sampler as sampler_mod, u64
from repro_torch.runtime import blocks
from repro_torch.service import tenants as tenants_mod

#: row-count ceiling for one coalesced window (counter steps per lease)
DEFAULT_MAX_ROWS = 2048
_MIN_ROWS = 8

#: LRU bound on the coalescer's window-function cache: one entry per
#: (purpose, rows, cols, sampler, out_dtype) shape class.
WINDOW_FN_CACHE_SIZE = 64


def class_channel(sampler: str, out_dtype: str) -> str:
    """Ledger/family channel name for one (sampler, dtype) request class.

    Distinct classes get distinct channels, hence distinct ``GenPlan``
    families (disjoint h-spaces of the same root seed) and independent
    counter ledgers - a uniform/float32 window can never alias a
    bits/uint32 window.
    """
    return f"service/class/{sampler}/{out_dtype}"


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def request_rows(n: int, max_rows: int = DEFAULT_MAX_ROWS) -> int:
    """Quantized row count for an ``n``-sample request: the next power
    of two, clamped to ``[8, max_rows]`` (even, as the normal stage's
    row pairs need)."""
    if n <= 0:
        raise ValueError(f"request size must be positive, got {n}")
    return max(_MIN_ROWS, min(_next_pow2(n), max_rows))


@dataclasses.dataclass(frozen=True)
class RandRequest:
    """One tenant's ask: ``shape`` samples of ``sampler``/``out_dtype``.

    ``rid`` names the request in responses and in the journal.

    Example:
        >>> from repro_torch.service.frontend import RandRequest
        >>> r = RandRequest(tenant_id="alice", shape=(4, 3),
        ...                 sampler="uniform", rid="r0")
        >>> r.num_samples
        12
    """
    tenant_id: str
    shape: Tuple[int, ...]
    sampler: str = "bits"
    out_dtype: str = "float32"
    rid: Optional[str] = None

    @property
    def num_samples(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def klass(self) -> Tuple[str, str]:
        return (self.sampler, self.out_dtype)

    def validate(self) -> None:
        spec = sampler_mod.parse(self.sampler)        # raises on bad spec
        sampler_mod.result_dtype(spec, self.out_dtype)
        if self.num_samples <= 0:
            raise ValueError(f"empty request shape {self.shape!r}")


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Where one request's samples live: the journal-able provenance.

    ``audit.replay`` needs nothing else: the plan is ``(seed,
    channel->purpose, tags, [lo, lo+rows), sampler, out_dtype)`` and the
    response is the column-major flatten of the generated
    ``(rows, len(tags))`` block truncated to ``n``.
    """
    rid: str
    tenant_id: str
    sampler: str
    out_dtype: str
    shape: Tuple[int, ...]
    channel: str
    lo: int                 # counter-window start (lease.lo)
    rows: int               # counter-window length (the batch's T)
    tags: Tuple[int, ...]   # absolute leaf tags of the assigned columns
    deco: str = "splitmix64"

    @property
    def num_samples(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


def slice_response(block, col0: int, ncols: int, assignment_n: int,
                   shape: Tuple[int, ...]):
    """Column-major slice: columns ``[col0, col0+ncols)`` read
    top-to-bottom, first ``n`` samples, reshaped.  ``block`` is a numpy
    array or a torch tensor; the result is of the same kind."""
    cols = block[:, col0:col0 + ncols].T
    if isinstance(cols, torch.Tensor):
        flat = cols.contiguous().reshape(-1)
    else:
        flat = np.ascontiguousarray(cols).reshape(-1)
    return flat[:assignment_n].reshape(shape)


def host_block(block: torch.Tensor, *, copy: bool = False):
    """A generated block on the host: a numpy array, or a CPU tensor for
    bfloat16, which numpy has no type for (one copy off the card).
    ``copy=True`` gives a fresh buffer for a block that is already on the
    CPU too: a donated ring buffer is overwritten by a later window."""
    block = block.to("cpu", copy=copy)
    return block if block.dtype == torch.bfloat16 else block.numpy()


class Coalescer:
    """Batches requests into one leased gathered-tag engine call per class.

    ``flush(requests)`` is deterministic in the ORDER of ``requests``: the
    same ordered list against the same service and ledger state gives the
    same assignments and the same bytes.  The engine runs on the service's
    device (``backend`` overrides the engine's choice); responses come
    back on the host (``host_block``).

    Example:
        >>> from repro_torch.runtime.blocks import BlockService
        >>> from repro_torch.service.frontend import Coalescer, RandRequest
        >>> from repro_torch.service.tenants import TenantRegistry
        >>> co = Coalescer(BlockService(seed=3, device="cpu"),
        ...                TenantRegistry())
        >>> got, asg, err = co.flush([RandRequest("alice", (5,), rid="a")])
        >>> (got["a"].shape, asg[0].rows, err)
        ((5,), 8, {})
    """

    def __init__(self, service: blocks.BlockService,
                 registry: tenants_mod.TenantRegistry, *,
                 journal=None, backend: Optional[str] = None,
                 deco: str = "splitmix64",
                 max_rows: int = DEFAULT_MAX_ROWS,
                 window_fn_cache_size: int = WINDOW_FN_CACHE_SIZE):
        self.service = service
        self.registry = registry
        self.journal = journal
        self.backend = backend
        self.deco = deco
        self.max_rows = max_rows
        self.window_fn_cache_size = int(window_fn_cache_size)
        if self.window_fn_cache_size < 1:
            raise ValueError(f"window_fn_cache_size must be >= 1, got "
                             f"{window_fn_cache_size!r}")
        self._window_fns: "collections.OrderedDict[Tuple, Callable]" = \
            collections.OrderedDict()
        self._fn_lock = threading.Lock()
        # cumulative coalescing stats
        self.requests_served = 0
        self.engine_calls = 0
        self.lease_calls = 0
        self.samples_served = 0
        self.samples_generated = 0

    # -- window functions --------------------------------------------------

    def _window_fn(self, purpose: int, rows: int, cols: int, sampler: str,
                   out_dtype: str) -> Callable:
        """The window function of one quantized shape class:
        ``fn(tags, lo) -> (rows, cols)`` block on the service's device.

        It holds the family's ``x0`` and ``h`` (fixed per class); the
        leaf offsets of the tags are derived on the device per call.  The
        cache is LRU-bounded at ``window_fn_cache_size`` entries; an
        evicted class is simply rebuilt.
        """
        key = (purpose, rows, cols, sampler, out_dtype)
        with self._fn_lock:
            fn = self._window_fns.get(key)
            if fn is not None:
                self._window_fns.move_to_end(key)
        if fn is not None:
            return fn
        x0, h_fam = engine.family_from_seed(self.service.seed, purpose)
        f_hi, f_lo = u64.split64(h_fam)
        deco, backend = self.deco, self.backend
        device, block_t = self.service.device, self.service.block_t

        def window(tags: List[int], lo: int) -> torch.Tensor:
            t_hi, t_lo = engine.leaf_limbs(tags, device)
            h = engine.derive_leaf((torch.full_like(t_hi, f_hi),
                                    torch.full_like(t_lo, f_lo)),
                                   (t_hi, t_lo))
            plan = engine.GenPlan(
                x0=x0, h=h, num_steps=rows, ctr=lo & u64.M64, mode="ctr",
                deco=deco, sampler=sampler, out_dtype=out_dtype)
            return engine.generate(plan, backend=backend, block_t=block_t)

        with self._fn_lock:
            fn = self._window_fns.setdefault(key, window)
            self._window_fns.move_to_end(key)
            while len(self._window_fns) > self.window_fn_cache_size:
                self._window_fns.popitem(last=False)
        return fn

    # -- batching ----------------------------------------------------------

    def flush(self, requests: List[RandRequest]
              ) -> Tuple[Dict[str, Any], List[Assignment],
                         Dict[str, BaseException]]:
        """Serve an ordered microbatch; returns (responses by rid,
        assignments in request order, per-rid errors).

        Quota rejections and invalid requests fail individually; the
        rest of the batch is unaffected.
        """
        by_class: Dict[Tuple[str, str], List[RandRequest]] = {}
        errors: Dict[str, BaseException] = {}
        rids = [req.rid for req in requests]
        if None in rids:
            raise ValueError("flush needs rid-stamped requests")
        if len(set(rids)) != len(rids):
            raise ValueError("flush needs unique rids within a batch")
        for req in requests:
            try:
                req.validate()
            except Exception as e:
                errors[req.rid] = e
                continue
            by_class.setdefault(req.klass, []).append(req)

        responses: Dict[str, Any] = {}
        assignments: List[Assignment] = []
        for klass in sorted(by_class):
            try:
                got, asg, errs = self._flush_class(klass, by_class[klass])
            except Exception as e:
                # one class's failure (lease/engine) fails ITS requests
                # only; _flush_class already refunded and released
                for req in by_class[klass]:
                    errors.setdefault(req.rid, e)
                continue
            responses.update(got)
            assignments.extend(asg)
            errors.update(errs)
        # journal/assignment order = request order, not class order
        order = {req.rid: i for i, req in enumerate(requests)}
        assignments.sort(key=lambda a: order[a.rid])
        if self.journal is not None:
            for a in assignments:
                self.journal.append_request(a)
            self.journal.flush()
        return responses, assignments, errors

    def _flush_class(self, klass: Tuple[str, str],
                     reqs: List[RandRequest]):
        sampler, out_dtype = klass
        channel = class_channel(sampler, out_dtype)
        rows = max(request_rows(r.num_samples, self.max_rows) for r in reqs)

        # pack columns: per-tenant slot cursors restart every batch (the
        # fresh counter window is what makes the draws fresh)
        cursors: Dict[str, int] = {}
        packed = []          # (req, col0, ncols, tags)
        tags: List[int] = []
        errors: Dict[str, BaseException] = {}
        for req in reqs:
            n = req.num_samples
            ncols = -(-n // rows)
            try:
                # every fallible admission check runs BEFORE charge():
                # a rejected request must not consume quota
                tenant = self.registry.register(req.tenant_id)
                slot0 = cursors.get(req.tenant_id, 0)
                if slot0 + ncols > tenant.region_slots:
                    raise tenants_mod.QuotaExceeded(
                        f"tenant {req.tenant_id!r} needs {slot0 + ncols} "
                        f"slots in one microbatch; region has "
                        f"{tenant.region_slots}")
                self.registry.charge(req.tenant_id, n)
            except Exception as e:
                errors[req.rid] = e
                continue
            cursors[req.tenant_id] = slot0 + ncols
            rtags = [tenant.tag(slot0 + j) for j in range(ncols)]
            packed.append((req, len(tags), ncols, rtags))
            tags.extend(rtags)
        if not packed:
            return {}, [], errors

        cols = max(_MIN_ROWS, _next_pow2(len(tags)))
        padded = tags + [tags[-1]] * (cols - len(tags))  # dup cols: sliced off

        self.service.open(channel, num_streams=1)
        lease = self.service.lease(channel, rows)
        self.lease_calls += 1
        purpose = blocks.channel_purpose(channel)
        fn = self._window_fn(purpose, rows, cols, sampler, out_dtype)
        try:
            block = host_block(fn(padded, lease.lo))
        except Exception:
            self.service.release(lease)
            for req, _, _, _ in packed:   # nothing served: refund quota
                self.registry.refund(req.tenant_id, req.num_samples)
            raise
        self.engine_calls += 1
        if self.journal is not None:
            self.journal.append_window(channel, lease.lo, lease.hi)
        lease.commit()
        self.samples_generated += rows * cols

        responses: Dict[str, Any] = {}
        assignments: List[Assignment] = []
        for req, col0, ncols, rtags in packed:
            n = req.num_samples
            responses[req.rid] = slice_response(block, col0, ncols, n,
                                                req.shape)
            assignments.append(Assignment(
                rid=req.rid, tenant_id=req.tenant_id, sampler=sampler,
                out_dtype=out_dtype, shape=tuple(req.shape),
                channel=channel, lo=lease.lo, rows=rows, tags=tuple(rtags),
                deco=self.deco))
            self.requests_served += 1
            self.samples_served += n
        return responses, assignments, errors

    def stats(self) -> Dict[str, Any]:
        served = max(1, self.requests_served)
        return {
            "requests_served": self.requests_served,
            "engine_calls": self.engine_calls,
            "lease_calls": self.lease_calls,
            "calls_per_request": (self.engine_calls + self.lease_calls)
                                 / served,
            "samples_served": self.samples_served,
            "samples_generated": self.samples_generated,
            "fill_ratio": self.samples_served
                          / max(1, self.samples_generated),
            "window_fn_cache": len(self._window_fns),
            "window_fn_cache_max": self.window_fn_cache_size,
        }
