"""Token sampling over leased counter windows: the decode tier's ONE
randomness consumer.

``GumbelMaxSampler`` turns a ``(capacity, vocab)`` logit block into
``(capacity,)`` token ids, drawing all of a decode step's randomness
from ONE leased counter window of one per-class channel - the
continuous batcher's "one coalesced per-class request per decode step"
contract, metered as ``engine_calls / steps``.

Per decode step ``d`` the sampler consumes window
``[d * vocab, (d+1) * vocab)`` of its class channel; each live
sequence's noise column is the engine leaf at the sequence-tenant's
region tag.  The (channel, window, tags) triple is journaled per step
as an atomic batch record - ``service.audit`` can regenerate any
sequence's per-step noise from the record alone, and a restarted run
replays journaled steps through lease-or-regenerate: an explicit
``lease(at=d * vocab)`` that collides with a restored (fenced) window
is the replay signal, and the step regenerates bit-identically instead
of double-spending counters.

Sampling paths (all give the same tokens where no two scores lie within
a few ULP of a sequence's maximum):

  * ``"fused"`` - kernel F (``inference.kernels``): one launch, bits ->
    token ids, nothing intermediate in device memory; on the CPU its
    plain version.
  * ``"cuda"`` / ``"torch"`` - the two-pass oracle: a (vocab, capacity)
    ``"gumbel"`` noise block from ``engine.generate`` on that engine
    backend, then the same masked first-argmax.

Greedy decode (``temperature <= 0``) takes ``torch.argmax`` and consumes
NO randomness - no lease, no journal record, zero engine calls.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.inference.kernels import gumbel_argmax as kern
from repro_torch.runtime import blocks
from repro_torch.service import frontend, tenants

PATHS = ("fused", "cuda", "torch")


def class_channel(sampler: str = "gumbel",
                  out_dtype: str = "float32") -> str:
    """Channel name for one inference sampling class (cf.
    ``service.frontend.class_channel`` - same convention, own prefix)."""
    return f"inference/class/{sampler}/{out_dtype}"


def twopass_path(device) -> str:
    """The two-pass path on the engine backend that serves ``device``:
    ``"cuda"`` on a card, ``"torch"`` elsewhere (``engine.select_backend``'s
    rule)."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """Host-side sampling parameters.

    ``temperature <= 0`` means greedy argmax (no randomness).
    ``top_k == 0`` disables the top-k filter; ``top_k = k`` keeps the k
    largest logits per sequence.  ``inv_temp`` is rounded once to f32 on
    the host so every path scales by the identical constant.
    """
    temperature: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def inv_temp(self) -> float:
        return float(np.float32(1.0 / float(self.temperature)))


@dataclasses.dataclass(frozen=True)
class ActiveSeq:
    """One live sequence's view of a decode step (slot pool row)."""
    slot: int           # slot index = logits row = noise column
    seq_id: str
    tenant_id: str
    tag: int            # absolute leaf tag (tenant region slot 0)
    position: int       # tokens generated so far = decode position

    @property
    def rid(self) -> str:
        return f"{self.seq_id}/t{self.position:06d}"


class GumbelMaxSampler:
    """Slot-batched gumbel-max token sampler over a BlockService channel.

    One instance serves a fixed ``(capacity, vocab)`` decode shape on the
    service's device.  Per stochastic step the host derives each slot's
    leaf offset from its tag (python ints) and sends the (capacity,)
    offsets to the device in one copy; logits stay where the caller made
    them.
    """

    def __init__(self, service: blocks.BlockService,
                 registry: Optional[tenants.TenantRegistry] = None, *,
                 vocab: int, capacity: int,
                 spec: SamplingSpec = SamplingSpec(),
                 path: str = "fused", journal=None,
                 channel: Optional[str] = None,
                 deco: str = "splitmix64"):
        if path not in PATHS:
            raise ValueError(f"unknown sampling path {path!r}; have {PATHS}")
        if vocab < 1 or capacity < 1:
            raise ValueError(f"need vocab >= 1 and capacity >= 1, got "
                             f"vocab={vocab} capacity={capacity}")
        if spec.top_k > vocab:
            raise ValueError(f"top_k={spec.top_k} exceeds vocab={vocab}")
        self.service = service
        self.registry = registry
        self.vocab = int(vocab)
        self.capacity = int(capacity)
        self.spec = spec
        self.path = path
        self.journal = journal
        self.deco = deco
        self.device = service.device
        self.channel = channel or class_channel()
        service.open(self.channel, num_streams=capacity, sampler="gumbel",
                     out_dtype="float32", deco=deco)
        purpose = service.channel(self.channel).purpose
        self._x0, self._h_fam = engine.family_from_seed(service.seed, purpose)
        # (tag, leaf offset) per slot: a sequence keeps its slot and tag
        # for its whole life, so each leaf is derived once, not per step
        self._slot_leaf = [(None, 0)] * self.capacity
        self._no_mask = torch.full((self.capacity,), float("-inf"),
                                   dtype=torch.float32, device=self.device)
        self.steps = 0
        self.engine_calls = 0
        self.replayed_steps = 0

    @classmethod
    def standalone(cls, *, seed: int, vocab: int, capacity: int,
                   spec: SamplingSpec = SamplingSpec(),
                   path: str = "fused", journal=None,
                   device=None) -> "GumbelMaxSampler":
        """Self-contained sampler over a fresh BlockService + registry."""
        return cls(blocks.BlockService(seed=seed, device=device),
                   tenants.TenantRegistry(), vocab=vocab,
                   capacity=capacity, spec=spec, path=path, journal=journal)

    # -- one step's tokens -------------------------------------------------

    def _leaves(self, tags: Sequence[int]) -> List[int]:
        hs = []
        for slot, tag in enumerate(tags):
            known, h = self._slot_leaf[slot]
            if known != tag:
                h = engine.derive_leaf_host(self._h_fam, tag)
                self._slot_leaf[slot] = (tag, h)
            hs.append(h)
        return hs

    def _tokens(self, logits: torch.Tensor, tags: Sequence[int],
                lo: int) -> torch.Tensor:
        top_k = int(self.spec.top_k)
        thresh = (torch.topk(logits, top_k, dim=-1).values[:, -1]
                  if top_k > 0 else self._no_mask)
        hs = self._leaves(tags)
        inv_temp = self.spec.inv_temp
        if self.path == "fused":
            return kern.fused_argmax(
                logits, kern.leaf_words(hs, self.device), self._x0, lo,
                thresh, inv_temp=inv_temp, deco=self.deco)
        plan = engine.GenPlan(
            x0=self._x0, h=engine.leaf_limbs(hs, self.device),
            num_steps=self.vocab,
            ctr=lo, mode="ctr", deco=self.deco, sampler="gumbel",
            out_dtype="float32")
        noise = engine.generate(plan, backend=self.path)
        return kern.twopass_argmax(logits.T, noise, thresh,
                                   inv_temp=inv_temp)

    # -- the decode step ---------------------------------------------------

    def sample_step(self, step: int, logits,
                    active: Sequence[ActiveSeq] = ()) -> np.ndarray:
        """(capacity,) int32 tokens for decode step ``step``.

        ``logits``: (capacity, vocab) float32 - inactive slots' rows are
        ignored (their tokens are garbage; callers only read active
        slots).  ``active``: the live sequences; their tags select the
        noise columns, their rids label the journal record.
        """
        self.steps += 1
        logits = torch.as_tensor(logits, device=self.device).to(
            torch.float32).reshape(self.capacity, self.vocab)
        if self.spec.greedy:
            # pure argmax: consumes no randomness, journals nothing
            return torch.argmax(logits, -1).to(torch.int32).cpu().numpy()

        V = self.vocab
        lo = step * V
        lease = None
        try:
            lease = self.service.lease(self.channel, V, at=lo)
        except blocks.LeaseError:
            pass  # journaled window from a previous owner: regenerate

        tags = [0] * self.capacity
        for a in active:
            tags[a.slot] = int(a.tag)
        toks = self._tokens(logits, tags, lo).cpu().numpy()
        self.engine_calls += 1

        if self.registry is not None:
            for a in active:
                self.registry.charge(a.tenant_id, V)
        if lease is not None:
            lease.commit()
            if self.journal is not None:
                assignments = [frontend.Assignment(
                    rid=a.rid, tenant_id=a.tenant_id, sampler="gumbel",
                    out_dtype="float32", shape=(V,), channel=self.channel,
                    lo=lo, rows=V, tags=(a.tag,), deco=self.deco)
                    for a in active]
                self.journal.append_batch(
                    assignments, [(self.channel, lo, lo + V)])
                self.journal.flush()
        else:
            self.replayed_steps += 1
        return toks

    def stats(self) -> Dict[str, float]:
        steps = max(1, self.steps)
        return {"steps": self.steps,
                "engine_calls": self.engine_calls,
                "replayed_steps": self.replayed_steps,
                "calls_per_step": self.engine_calls / steps,
                "path": self.path,
                "greedy": self.spec.greedy}
