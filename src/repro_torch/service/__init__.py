"""RandService layers the inference tier needs: the deterministic tenant
registry (``tenants``), request-class channels and assignments
(``frontend``) and the append-only replayable journal (``audit``).

The request coalescer, the server and the wire fleet of the reference's
``repro.service`` are not ported yet (ROADMAP queue A item 8).
"""
from repro_torch.service.audit import (Journal, JournalLockedError,  # noqa: F401
                                       replay, replay_entry,
                                       response_digest,
                                       verify_ledger_disjoint)
from repro_torch.service.frontend import (Assignment, class_channel,  # noqa: F401
                                          slice_response)
from repro_torch.service.tenants import (QuotaExceeded, Tenant,  # noqa: F401
                                         TenantCollisionError,
                                         TenantRegistry, tenant_region)
