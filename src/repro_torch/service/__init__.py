"""RandService: multi-tenant randomness-as-a-service.

The serving layer over ``core.engine`` + ``runtime.blocks``: a
deterministic tenant registry (``tenants``), a request-coalescing
frontend (``frontend``), a bounded-queue dispatch server with standing
producer pools (``server``), an append-only replayable request journal
(``audit``), a deterministic burst driver (``burst``), and - over the
wire - a length-prefixed socket transport (``transport``) plus a
sharded fleet with journal-backed failover (``fleet``).  Servers,
shard hosts and fleets run on the card unless given another device.

``fleet``/``transport`` symbols are imported lazily (PEP 562): the
in-process service must stay importable without touching the socket
layer.
"""
from repro_torch.service.audit import (Journal, JournalLockedError,  # noqa: F401
                                       replay, replay_entry,
                                       response_digest,
                                       verify_ledger_disjoint)
from repro_torch.service.frontend import (Assignment, Coalescer,  # noqa: F401
                                          RandRequest, class_channel,
                                          request_rows, slice_response)
from repro_torch.service.server import (RandServer, ServerConfig,  # noqa: F401
                                        ServiceClosed, drain_signal_event)
from repro_torch.service.tenants import (QuotaExceeded, Tenant,  # noqa: F401
                                         TenantCollisionError,
                                         TenantRegistry, tenant_region)

_WIRE = {
    "Fleet": "repro_torch.service.fleet",
    "FleetClient": "repro_torch.service.fleet",
    "FleetConfig": "repro_torch.service.fleet",
    "FleetError": "repro_torch.service.fleet",
    "HashRing": "repro_torch.service.fleet",
    "run_fleet_burst": "repro_torch.service.fleet",
    "ShardHost": "repro_torch.service.transport",
    "TransportError": "repro_torch.service.transport",
    "FrameTooLarge": "repro_torch.service.transport",
    "TornFrame": "repro_torch.service.transport",
    "WireError": "repro_torch.service.transport",
}


def __getattr__(name):
    mod = _WIRE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)


__all__ = [
    "Assignment", "Coalescer", "Fleet", "FleetClient", "FleetConfig",
    "FleetError", "FrameTooLarge", "HashRing", "Journal",
    "JournalLockedError", "QuotaExceeded", "RandRequest", "RandServer",
    "ServerConfig", "ServiceClosed", "ShardHost", "Tenant",
    "TenantCollisionError", "TenantRegistry", "TornFrame",
    "TransportError", "WireError", "class_channel", "drain_signal_event",
    "replay", "replay_entry", "request_rows", "response_digest",
    "run_fleet_burst", "slice_response", "tenant_region",
    "verify_ledger_disjoint",
]
