"""RandService layers: the deterministic tenant registry (``tenants``),
the request coalescer with its request classes and assignments
(``frontend``) and the append-only replayable journal (``audit``).

The server, the burst load generator, the wire transport and the fleet of the
reference's ``repro.service`` are not ported yet (ROADMAP queue A).
"""
from repro_torch.service.audit import (Journal, JournalLockedError,  # noqa: F401
                                       replay, replay_entry,
                                       response_digest,
                                       verify_ledger_disjoint)
from repro_torch.service.frontend import (Assignment, Coalescer,  # noqa: F401
                                          RandRequest, class_channel,
                                          request_rows, slice_response)
from repro_torch.service.tenants import (QuotaExceeded, Tenant,  # noqa: F401
                                         TenantCollisionError,
                                         TenantRegistry, tenant_region)
