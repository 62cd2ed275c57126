"""Fixed-capacity slot pool: live decode sequences as RandService tenants.

Continuous batching keeps a fixed number of decode *slots* hot and
churns sequences through them: a sequence joins the batch when a slot
frees up, decodes until it finishes, and its slot is immediately
reusable.  The randomness-safety question under that churn is the whole
point of this module — when sequence B reuses the slot sequence A just
vacated, NOTHING B draws may overlap anything A ever consumed, and a
crash-restarted run must reassign the exact same sequences to the exact
same slots so its token streams replay bit-identically.

The mapping onto the service tiers:

  * each live sequence registers as a tenant (``TenantRegistry``) — its
    blake2s region tag is its noise column in the decode kernel, stable
    across processes because it derives from the seq id alone;
  * each SLOT owns a per-slot admission channel
    (``inference/slot/<i>``); occupant ``o`` of slot ``i`` draws its
    admission randomness (target length etc.) from the deterministic
    window ``[o * draw_rows, (o+1) * draw_rows)`` of that channel, so
    slot assignment alone pins every admission draw;
  * retiring a sequence retires its tenant row
    (``TenantRegistry.retire``) and RELEASES the slot channel
    (``BlockService.release(name)``), which fences the channel floor at
    its high-water mark — the ledger-level proof that a
    retired-and-reused slot can never re-lease a window its previous
    occupant consumed (``tests/test_torch_inference.py`` asserts this).

Replay: admissions happen at deterministic (slot, occupant-ordinal)
coordinates, so a restarted pool re-admits the same sequences into the
same slots; admission draws use lease-or-regenerate — a window already
committed in the restored ledger regenerates bit-identically instead
of double-leasing.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.runtime import blocks
from repro_torch.service import tenants


def slot_channel(slot: int) -> str:
    """Per-slot admission channel name."""
    return f"inference/slot/{slot}"


@dataclasses.dataclass
class Sequence:
    """One sequence's lifetime in the pool."""
    seq_id: str
    tenant_id: str
    tag: int                 # leaf tag = noise column selector
    slot: int
    occupant: int            # nth occupant of this slot (admission ordinal)
    arrival_step: int        # decode step at which the sequence was admitted
    target_len: int          # tokens to generate before it finishes
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def position(self) -> int:
        return len(self.tokens)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.target_len


class SlotPool:
    """``capacity`` decode slots over one BlockService + TenantRegistry.

    ``admit`` assigns the lowest free slot (deterministic given the
    admission order, which the scheduler makes deterministic given the
    seed), registers the sequence's tenant, opens the slot channel, and
    draws the sequence's target length from the slot channel's
    occupant-ordinal window.  ``retire`` frees the slot, retires the
    tenant row, and releases the slot channel (floor-fencing its
    ledger).
    """

    def __init__(self, service: blocks.BlockService,
                 registry: tenants.TenantRegistry, *, capacity: int,
                 min_len: int = 4, len_spread: int = 29,
                 draw_rows: int = 8, journal=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if min_len < 1 or len_spread < 0:
            raise ValueError(f"need min_len >= 1 and len_spread >= 0, got "
                             f"min_len={min_len} len_spread={len_spread}")
        self.service = service
        self.registry = registry
        self.capacity = int(capacity)
        self.min_len = int(min_len)
        self.len_spread = int(len_spread)
        self.draw_rows = int(draw_rows)
        self.journal = journal
        self._slots: List[Optional[Sequence]] = [None] * capacity
        # occupant ordinals survive retire: the (slot, ordinal) pair is
        # the admission-draw address, so it must count every occupant a
        # slot has EVER had, not just the live one.
        self._occupants: List[int] = [0] * capacity
        self.admitted = 0
        self.retired = 0

    # -- queries -----------------------------------------------------------

    def has_free(self) -> bool:
        return any(s is None for s in self._slots)

    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    def active(self) -> List[Sequence]:
        """Live sequences, slot order (the decode batch)."""
        return [s for s in self._slots if s is not None]

    def at(self, slot: int) -> Optional[Sequence]:
        return self._slots[slot]

    # -- admission draw ----------------------------------------------------

    def _admission_draw(self, slot: int, occupant: int) -> torch.Tensor:
        """(draw_rows,) uniforms from the slot channel's occupant window,
        via lease-or-regenerate (replay-safe)."""
        name = slot_channel(slot)
        self.service.open(name, num_streams=1, sampler="uniform",
                          out_dtype="float32")
        lo = occupant * self.draw_rows
        lease = None
        try:
            lease = self.service.lease(name, self.draw_rows, at=lo)
        except blocks.LeaseError:
            pass  # already journaled by a previous owner: regenerate
        u = self.service.regenerate(name, lo, self.draw_rows).cpu()
        if lease is not None:
            lease.commit()
            if self.journal is not None:
                self.journal.append_window(name, lo, lo + self.draw_rows)
        return u[:, 0]

    # -- lifecycle ---------------------------------------------------------

    def admit(self, seq_id: str, arrival_step: int) -> Sequence:
        """Admit ``seq_id`` into the lowest free slot."""
        slot = next((i for i, s in enumerate(self._slots) if s is None),
                    None)
        if slot is None:
            raise RuntimeError(f"no free slot for {seq_id!r} "
                               f"(capacity {self.capacity})")
        occupant = self._occupants[slot]
        self._occupants[slot] = occupant + 1
        tenant = self.registry.register(seq_id)
        u = self._admission_draw(slot, occupant)
        target_len = self.min_len + int(float(u[0]) * (self.len_spread + 1))
        seq = Sequence(seq_id=seq_id, tenant_id=seq_id, tag=tenant.tag(0),
                       slot=slot, occupant=occupant,
                       arrival_step=arrival_step, target_len=target_len)
        self._slots[slot] = seq
        self.admitted += 1
        return seq

    def retire(self, slot: int) -> Sequence:
        """Finish the sequence in ``slot``; the slot is free afterwards.

        Tenant row and slot channel are both retired — the channel
        release fences the slot-channel floor so the NEXT occupant's
        admission window can never overlap this occupant's (the ledger
        also enforces it structurally: occupant ordinals never repeat).
        """
        seq = self._slots[slot]
        if seq is None:
            raise ValueError(f"slot {slot} is not occupied")
        self._slots[slot] = None
        self.registry.retire(seq.tenant_id)
        self.service.release(slot_channel(slot))
        self.retired += 1
        return seq

    def occupancy(self) -> float:
        return self.num_active() / self.capacity
