"""Deterministic tenant registry: ids -> disjoint stream-tag regions.

The paper's core economics — one shared root state, per-stream cost of
one add plus an output stage — is exactly what a multi-tenant service
needs: handing a new client its own independent sequences must not cost
per-client generator state.  This module maps arbitrary tenant ids onto
the engine's 64-bit leaf-tag space (the ``tag`` argument of
``engine.derive_leaf``) so that

  * every tenant owns a private, contiguous *region* of
    ``2**REGION_BITS`` stream slots, derived purely from ``blake2s`` of
    the id (stable across processes and restarts — the journal must
    mean the same streams after a crash),
  * regions of distinct tenants are disjoint by construction whenever
    their region bases differ, and the registry *verifies* rather than
    assumes this: a base collision between distinct ids raises
    ``TenantCollisionError`` deterministically (probability ~n^2/2^49
    for n tenants; ~2e-7 at n = 10^4),
  * per-tenant consumption is metered: ``charge`` accumulates samples
    served against an optional quota.

All tenants of one request class share a single ``GenPlan`` family
(one ``x0``, one family offset — see ``frontend.class_channel``); a
tenant's streams are the family leaves at its region's tags.  Millions
of logical clients therefore cost the service nothing but table rows
here — the software restatement of "adding SOU instances needs no
extra root hardware".
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, Optional

#: log2 of the number of stream slots in one tenant region.  16 leaves
#: 2**48 distinct regions: ample slots for any single microbatch, and a
#: ~2e-7 collision probability across 10^4 tenants (collisions are
#: detected, not silently tolerated).
REGION_BITS = 16


class TenantCollisionError(ValueError):
    """Two distinct tenant ids hashed to the same stream-tag region."""


class QuotaExceeded(RuntimeError):
    """A request would push a tenant past its sample quota."""


def tenant_region(tenant_id: str, region_bits: int = REGION_BITS) -> int:
    """Region base tag for ``tenant_id``: blake2s-64 with the low
    ``region_bits`` cleared.

    The region is ``[base, base + 2**region_bits)`` in the u64 leaf-tag
    space; bases are multiples of the region size, so *distinct bases
    imply disjoint regions* — injectivity of this function over the
    registered ids is the whole non-overlap argument (and is property-
    tested over >= 10^4 ids in ``tests/test_torch_service.py``).

    Example:
        >>> from repro_torch.service.tenants import tenant_region
        >>> a, b = tenant_region("alice"), tenant_region("bob")
        >>> a != b and a % (1 << 16) == 0
        True
    """
    digest = hashlib.blake2s(tenant_id.encode("utf-8"),
                             digest_size=8).digest()
    h = int.from_bytes(digest, "little")
    return (h >> region_bits) << region_bits


@dataclasses.dataclass
class Tenant:
    """One registered tenant: its region and its consumption meters."""
    tenant_id: str
    region_lo: int           # first stream tag owned by this tenant
    region_hi: int           # one past the last owned tag
    quota: Optional[int]     # max samples ever served (None = unmetered)
    served: int = 0          # samples handed out so far
    requests: int = 0        # requests admitted so far

    @property
    def region_slots(self) -> int:
        return self.region_hi - self.region_lo

    def tag(self, slot: int) -> int:
        """Absolute leaf tag of ``slot`` within this tenant's region."""
        if not 0 <= slot < self.region_slots:
            raise ValueError(
                f"slot {slot} outside tenant {self.tenant_id!r} region of "
                f"{self.region_slots} slots")
        return self.region_lo + slot


class TenantRegistry:
    """Thread-safe id -> ``Tenant`` table with collision detection.

    Registration is idempotent and deterministic: the same id always
    maps to the same region, in any process, with no coordination —
    which is what lets a restarted service resume serving the same
    tenants from the journal alone.

    Example:
        >>> from repro_torch.service.tenants import TenantRegistry
        >>> reg = TenantRegistry(default_quota=100)
        >>> t = reg.register("alice")
        >>> t.region_slots
        65536
        >>> reg.charge("alice", 64).served
        64
    """

    def __init__(self, *, region_bits: int = REGION_BITS,
                 default_quota: Optional[int] = None):
        self.region_bits = region_bits
        self.default_quota = default_quota
        self._tenants: Dict[str, Tenant] = {}
        self._by_region: Dict[int, str] = {}
        self._lock = threading.Lock()

    def register(self, tenant_id: str,
                 quota: Optional[int] = None) -> Tenant:
        """Return (creating if needed) the ``Tenant`` for ``tenant_id``."""
        with self._lock:
            t = self._tenants.get(tenant_id)
            if t is not None:
                return t
            base = tenant_region(tenant_id, self.region_bits)
            other = self._by_region.get(base)
            if other is not None:
                raise TenantCollisionError(
                    f"tenant {tenant_id!r} collides with {other!r} on "
                    f"region base {base:#x} (region_bits="
                    f"{self.region_bits})")
            t = Tenant(tenant_id=tenant_id, region_lo=base,
                       region_hi=base + (1 << self.region_bits),
                       quota=self.default_quota if quota is None else quota)
            self._tenants[tenant_id] = t
            self._by_region[base] = tenant_id
            return t

    def get(self, tenant_id: str) -> Tenant:
        return self._tenants[tenant_id]

    def __len__(self) -> int:
        return len(self._tenants)

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._tenants

    def charge(self, tenant_id: str, num_samples: int) -> Tenant:
        """Meter ``num_samples`` against the tenant's quota (registering
        the tenant on first contact); raises ``QuotaExceeded`` without
        consuming anything when the quota would be passed."""
        t = self.register(tenant_id)
        with self._lock:
            if t.quota is not None and t.served + num_samples > t.quota:
                raise QuotaExceeded(
                    f"tenant {tenant_id!r}: {t.served} served + "
                    f"{num_samples} requested > quota {t.quota}")
            t.served += num_samples
            t.requests += 1
        return t

    def refund(self, tenant_id: str, num_samples: int) -> Tenant:
        """Return samples charged for a request that later failed (e.g.
        the fused engine call errored after admission) so a tenant is
        only ever billed for bytes actually served."""
        t = self.get(tenant_id)
        with self._lock:
            t.served = max(0, t.served - num_samples)
            t.requests = max(0, t.requests - 1)
        return t

    def retire(self, tenant_id: str) -> Optional[Tenant]:
        """Drop a tenant from the table, freeing its row (idempotent).

        This is the sequence-churn primitive for the inference tier:
        every live decode sequence is a tenant, and at millions of
        finished sequences the registry must not grow without bound.
        Retiring only removes the TABLE ROW — the id -> region map is a
        pure hash, so re-registering the same id later lands on the
        same region with fresh meters (counter-window disjointness
        across the reuse is the lease ledger's job, not the registry's:
        see ``BlockService.release(name)``).  Returns the retired
        ``Tenant`` snapshot, or ``None`` if it was never registered.
        """
        with self._lock:
            t = self._tenants.pop(tenant_id, None)
            if t is not None:
                self._by_region.pop(t.region_lo, None)
            return t

    def usage(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant accounting snapshot (JSON-able)."""
        with self._lock:
            return {tid: {"served": t.served, "requests": t.requests,
                          "region_lo": t.region_lo,
                          "region_hi": t.region_hi}
                    for tid, t in sorted(self._tenants.items())}
