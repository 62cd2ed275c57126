"""Deterministic, seekable synthetic LM data pipeline on ThundeRiNG.

Every batch is a pure function of (seed, step): batch b at step s draws
tokens from the MISRN stream ``derive(data_root, s)`` at counter 0.  So a
run resumes exactly from the step number alone, any worker can recompute
any other worker's batch, and batches are bit-identical on any device.

Delivery goes through the block layer (``runtime.blocks``):
``LeasedBatchFeeder`` registers the pipeline as a ``BlockService``
channel whose window unit is ONE OPTIMIZER STEP — step ``s`` is the
window ``[s, s+1)``.  A producer thread leases and dispatches batch
``s+1`` while step ``s`` computes, and the lease ledger makes feeding a
step's randomness twice a structural error.

The token distribution is Zipfian over the vocab (a rough LM-like
marginal): a (B, S+1) uniform draw looked up in the Zipf CDF.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import stream as tstream


@dataclasses.dataclass
class SyntheticLMPipeline:
    seed: int
    vocab: int
    global_batch: int
    seq_len: int
    zipf_alpha: float = 1.1
    extras: Optional[Dict[str, tuple]] = None   # name -> shape suffix
    device: Any = None                          # the card unless given

    def __post_init__(self):
        self.device = engine.resolve_device(self.device)
        self._root = tstream.new_stream(self.seed, 0xDA7A, device=self.device)
        # Zipf CDF over vocab (host-side, once)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        w = ranks ** (-self.zipf_alpha)
        self._cdf = torch.from_numpy(
            (np.cumsum(w) / w.sum()).astype(np.float32)).to(self.device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch for a given step (pure)."""
        st = tstream.derive(self._root, int(step))
        B, S = self.global_batch, self.seq_len
        u = tstream.uniform(st, (B, S + 1))
        # side="left", as jnp.searchsorted
        toks = torch.searchsorted(self._cdf, u).clamp_(0, self.vocab - 1)
        toks = toks.to(torch.int32)
        batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
        if self.extras:
            est = tstream.derive(st, 0xE57A)
            for name, suffix in self.extras.items():
                batch[name] = tstream.normal(est, (B, *suffix),
                                             torch.bfloat16)
        return batch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class LeasedBatchFeeder:
    """Lease-accounted, double-buffered batch source for the train loop.

    One ``BlockService`` channel (``"data/batches"``, window unit = one
    optimizer step) delivers the SAME bits as calling ``batch_at(step)``
    directly, through the block layer: a producer thread dispatches batch
    ``s+1`` while the trainer runs step ``s``, and the lease ledger
    records exactly which steps' randomness has been consumed.

    ``batch_for(step)`` expects sequential steps; a non-sequential step
    (restart-from-checkpoint) repositions the producer, which the ledger
    only permits after ``service.restore_ledger`` rewound it.
    """

    CHANNEL = "data/batches"

    def __init__(self, pipe: SyntheticLMPipeline, service, *,
                 depth: int = 1):
        self._pipe = pipe
        self._service = service
        self._depth = depth
        self._producer = None
        self._next: Optional[int] = None
        service.open(self.CHANNEL, window_fn=self._window)

    def _window(self, lo: int, hi: int):
        if hi != lo + 1:
            raise ValueError(f"data windows are single steps, got "
                             f"[{lo}, {hi})")
        return self._pipe.batch_at(lo)

    def batch_for(self, step: int) -> Dict[str, torch.Tensor]:
        """The (prefetched) batch for ``step``; commits its lease."""
        if self._producer is None or self._next != step:
            self.reset()
            self._producer = self._service.producer(
                self.CHANNEL, 1, depth=self._depth, start=step)
            self._next = step
        lease, batch = next(self._producer)
        if lease.lo != step:
            raise RuntimeError(f"producer delivered step {lease.lo}, "
                               f"expected {step}")
        self._next = step + 1
        return batch

    def reset(self) -> None:
        """Close the producer and drop its unconsumed reservations (call
        after a ledger restore, before resuming from the restored step)."""
        if self._producer is not None:
            self._producer.close()
            self._producer = None
        self._next = None
