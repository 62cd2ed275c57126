"""Delivery layer above the engine (leased counter windows and
producers) and the fault-tolerant training loop."""
from repro_torch.runtime.blocks import (BlockProducer, BlockService, Lease,
                                        LeaseError)
from repro_torch.runtime.fault import FaultTolerantLoop, SimulatedFailure

__all__ = ["BlockProducer", "BlockService", "FaultTolerantLoop", "Lease",
           "LeaseError", "SimulatedFailure"]
