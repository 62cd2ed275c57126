"""Continuous batcher: Poisson arrivals, slot churn, one fused sampling
call per decode step.

The decode loop the offline harness runs:

  1. arrivals whose time has come join the prefill queue (arrival gaps
     are drawn from the service's own ``exponential(rate)`` sampler
     stage — the RNG tier dogfooding its distribution grammar);
  2. queued sequences admit into free slots (``SlotPool.admit``);
  3. one ``GumbelMaxSampler.sample_step`` samples EVERY live sequence's
     next token — one coalesced per-class engine call for the whole
     step (``calls_per_step`` meters exactly this: 1.0);
  4. finished sequences retire, freeing their slots for step 5's
     admissions.

Every stochastic input is counter-addressed at schedule-deterministic
coordinates — arrival gaps at block ordinals of one arrivals channel,
admission draws at (slot, occupant) ordinals, decode noise at
``step * vocab`` of the class channel — so the whole run is a pure
function of ``ScheduleConfig``: re-running it, or crash-replaying it
from the journal (``restore_into`` + lease-or-regenerate), reproduces
the per-sequence token transcripts bit-identically.  The digest over
those transcripts is the cross-run/replay check, and at the same seed it
is the reference's (``repro.inference.scheduler``) digest.

Logits come from :class:`SyntheticLogitModel` — a pure hash of
(sequence, position, token) — standing in for a real model forward
pass; it is deliberately NOT drawn from the service so the randomness
accounting above stays exactly "admission + arrivals + one decode
window per step".  It runs on the batcher's device, in int64 tensors
masked to 32 bits (torch cannot multiply or shift uint32 on the CPU), and
its logits equal the reference's bit for bit.

The device enters through ``ContinuousBatcher(device=...)``: the card by
default, ``"cpu"`` for the plain path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import u64
from repro_torch.runtime import blocks, fault
from repro_torch.service import audit, tenants
from repro_torch.inference import slots as slots_mod
from repro_torch.inference.sampling import (ActiveSeq, GumbelMaxSampler,
                                            SamplingSpec)

U32 = np.uint32

ARRIVAL_CHANNEL = "inference/arrivals"
ARRIVAL_BLOCK = 64


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """One offline continuous-batching run, fully determined by this."""
    capacity: int = 64        # decode slots (the batch dimension)
    vocab: int = 512
    sequences: int = 128      # total sequences to serve
    rate: float = 8.0         # Poisson arrival rate (sequences per step)
    min_len: int = 4          # shortest target length
    len_spread: int = 29      # target_len in [min_len, min_len+len_spread]
    seed: int = 0
    temperature: float = 1.0
    top_k: int = 0
    path: str = "fused"       # sampling path: fused | cuda | torch
    max_steps: int = 100_000  # hard stop (safety bound)
    logit_scale: float = 6.0

    def spec(self) -> SamplingSpec:
        return SamplingSpec(temperature=self.temperature, top_k=self.top_k)


class ArrivalProcess:
    """Poisson arrivals from the service's own exponential sampler stage.

    Inter-arrival gaps (units: decode steps) are ``exponential(rate)``
    draws from one arrivals channel, consumed in fixed ``ARRIVAL_BLOCK``
    windows at block ordinals — lease-or-regenerate, journaled — and
    cumulated into integer arrival steps at construction, so the whole
    arrival schedule is pinned before the first decode step (and pinned
    identically by a replaying run).
    """

    def __init__(self, service: blocks.BlockService, *, rate: float,
                 count: int, journal=None):
        if rate <= 0:
            raise ValueError(f"arrival rate must be > 0, got {rate}")
        spec = f"exponential({rate})"
        service.open(ARRIVAL_CHANNEL, num_streams=1, sampler=spec,
                     out_dtype="float32")
        gaps: List[float] = []
        block = 0
        while len(gaps) < count:
            lo = block * ARRIVAL_BLOCK
            lease = None
            try:
                lease = service.lease(ARRIVAL_CHANNEL, ARRIVAL_BLOCK, at=lo)
            except blocks.LeaseError:
                pass  # journaled by the previous owner: regenerate
            blk = service.regenerate(ARRIVAL_CHANNEL, lo,
                                     ARRIVAL_BLOCK).cpu()
            if lease is not None:
                lease.commit()
                if journal is not None:
                    journal.append_window(ARRIVAL_CHANNEL, lo,
                                          lo + ARRIVAL_BLOCK)
            gaps.extend(blk[:, 0].tolist())
            block += 1
        t = 0.0
        steps: List[int] = []
        for g in gaps[:count]:
            t += g
            steps.append(int(t))
        self.arrival_steps = steps          # non-decreasing

    def due(self, step: int, start: int) -> int:
        """Number of arrivals in ``[start, count)`` due by ``step``."""
        n = start
        while (n < len(self.arrival_steps)
               and self.arrival_steps[n] <= step):
            n += 1
        return n


class SyntheticLogitModel:
    """Pure-hash (capacity, vocab) logits: fmix32(seq ^ position ^ token).

    A deterministic stand-in for a model forward pass - every (sequence,
    position, token) cell is an independent-looking value in
    ``[0, scale)``, identical across processes, devices and packages
    (integer hashing + one exact float scale), so token-stream
    determinism checks exercise the SAMPLER's reproducibility, not a
    model's.  The 32-bit hash runs in int64 tensors masked to 32 bits
    after every multiply (``u64.mul32_lo``) and before every shift.
    """

    P1, P2 = 0x9E3779B1, 0x85EBCA77

    def __init__(self, capacity: int, vocab: int, scale: float = 6.0,
                 device="cpu"):
        self.capacity = capacity
        self.vocab = vocab
        self.device = torch.device(device)
        self._scale = float(np.float32(scale * 2.0 ** -24))
        col = torch.arange(vocab, dtype=torch.int64, device=self.device)
        self._col = u64.mul32_lo(col, self.P2).reshape(1, vocab)

    @staticmethod
    def _fmix32(x: torch.Tensor) -> torch.Tensor:
        x = x ^ (x >> 16)
        x = u64.mul32_lo(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = u64.mul32_lo(x, 0xC2B2AE35)
        return x ^ (x >> 16)

    @staticmethod
    def seq_hash(seq_id: str) -> int:
        return int.from_bytes(
            hashlib.blake2s(seq_id.encode(), digest_size=4).digest(),
            "little")

    def __call__(self, seq_hash: np.ndarray,
                 position: np.ndarray) -> torch.Tensor:
        """(capacity, vocab) float32 logits on the model's device; the
        (capacity,) hashes and positions reach it in one copy."""
        hp = np.stack([np.asarray(seq_hash, np.uint32),
                       np.asarray(position, np.uint32)]).astype(np.int64)
        hp = torch.from_numpy(hp).to(self.device)
        x = (hp[0].reshape(self.capacity, 1)
             ^ u64.mul32_lo(hp[1], self.P1).reshape(self.capacity, 1)
             ^ self._col)
        return (self._fmix32(x) >> 8).to(torch.float32) * self._scale


@dataclasses.dataclass
class RunResult:
    """One offline run's outcome (transcripts + meters)."""
    transcripts: Dict[str, List[int]]
    digest: str
    decode_steps: int
    total_tokens: int
    admitted: int
    retired: int
    occupancy: float              # mean live-slots / capacity over steps
    step_seconds: List[float]     # wall time of each decode step
    sampler_stats: Dict[str, float]

    def latency_percentiles(self) -> Dict[str, float]:
        if not self.step_seconds:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        s = np.asarray(self.step_seconds)
        return {"p50_ms": float(np.percentile(s, 50) * 1e3),
                "p99_ms": float(np.percentile(s, 99) * 1e3)}


def transcript_digest(transcripts: Dict[str, List[int]]) -> str:
    """Order-independent sha256 over per-sequence token streams."""
    h = hashlib.sha256()
    for seq_id in sorted(transcripts):
        h.update(seq_id.encode())
        h.update(np.asarray(transcripts[seq_id], np.int32).tobytes())
    return h.hexdigest()


class ContinuousBatcher:
    """The decode loop; see the module docstring for the step anatomy.

    ``journal``: an ``audit.Journal`` — when it already holds entries
    (restart), its windows are restored and FENCED into the service
    before any channel opens, and the schedule re-executes from step 0
    with every journaled draw regenerating bit-identically.
    ``fault_plan``: scripted faults keyed on the decode step index
    (``kill`` = ``os._exit(1)`` BEFORE the step's journal append —
    SIGKILL semantics; ``slow`` = sleep, a straggler step).
    ``device``: where the service, the logits and the sampler run (the
    card unless ``"cpu"`` is given).
    """

    def __init__(self, config: ScheduleConfig, *,
                 journal: Optional[audit.Journal] = None,
                 fault_plan: Optional[fault.FaultPlan] = None,
                 device=None):
        self.config = config
        self.journal = journal
        self.service = blocks.BlockService(seed=config.seed, device=device)
        self.device = self.service.device
        if journal is not None and journal.entries:
            journal.restore_into(self.service, fence=True)
        self.registry = tenants.TenantRegistry()
        self.sampler = GumbelMaxSampler(
            self.service, self.registry, vocab=config.vocab,
            capacity=config.capacity, spec=config.spec(), path=config.path,
            journal=journal)
        self.pool = slots_mod.SlotPool(
            self.service, self.registry, capacity=config.capacity,
            min_len=config.min_len, len_spread=config.len_spread,
            journal=journal)
        self.arrivals = ArrivalProcess(
            self.service, rate=config.rate, count=config.sequences,
            journal=journal)
        self.logit_model = SyntheticLogitModel(
            config.capacity, config.vocab, config.logit_scale,
            device=self.device)
        self.injector = (fault.FaultInjector(fault_plan)
                         if fault_plan else None)

    @staticmethod
    def seq_id(index: int) -> str:
        return f"seq/{index:06d}"

    def _fire_fault(self, step: int) -> None:
        if self.injector is None:
            return
        spec = self.injector.fire(0, step)
        if spec is None:
            return
        if spec.kind == "kill":
            # SIGKILL semantics: no journal write for this step, no
            # cleanup — the torn-tail repair and lease-or-regenerate
            # must carry the restart
            os._exit(1)
        elif spec.kind == "slow":
            time.sleep(spec.seconds)
        else:
            raise ValueError(f"unsupported decode fault {spec.kind!r} "
                             f"(have kill, slow)")

    def run(self) -> RunResult:
        cfg = self.config
        transcripts: Dict[str, List[int]] = {}
        hashes = np.zeros(cfg.capacity, dtype=np.uint32)
        positions = np.zeros(cfg.capacity, dtype=np.uint32)
        step_seconds: List[float] = []
        live_sum = 0
        next_arrival = 0
        step = 0
        decode_steps = 0
        while step < cfg.max_steps:
            # 1+2: due arrivals admit into free slots (FIFO prefill queue)
            due = self.arrivals.due(step, next_arrival)
            while next_arrival < due and self.pool.has_free():
                sid = self.seq_id(next_arrival)
                seq = self.pool.admit(sid, step)
                transcripts[sid] = seq.tokens
                hashes[seq.slot] = U32(
                    SyntheticLogitModel.seq_hash(sid))
                positions[seq.slot] = 0
                next_arrival += 1
            active = self.pool.active()
            if not active:
                if next_arrival >= cfg.sequences and self.pool.num_active() == 0:
                    break   # drained: every sequence served
                step += 1   # idle step: nothing due yet
                continue

            # 3: one coalesced sampling call for every live sequence
            self._fire_fault(decode_steps)
            t0 = time.perf_counter()
            logits = self.logit_model(hashes, positions)
            batch = [ActiveSeq(slot=s.slot, seq_id=s.seq_id,
                               tenant_id=s.tenant_id, tag=s.tag,
                               position=s.position) for s in active]
            tokens = self.sampler.sample_step(decode_steps, logits, batch)
            step_seconds.append(time.perf_counter() - t0)
            live_sum += len(active)
            decode_steps += 1

            # 4: record tokens, retire finished sequences (slot order)
            for s in active:
                s.tokens.append(int(tokens[s.slot]))
                positions[s.slot] += U32(1)
                if s.done:
                    self.pool.retire(s.slot)
            step += 1

        return RunResult(
            transcripts=transcripts,
            digest=transcript_digest(transcripts),
            decode_steps=decode_steps,
            total_tokens=sum(len(t) for t in transcripts.values()),
            admitted=self.pool.admitted,
            retired=self.pool.retired,
            occupancy=(live_sum / (decode_steps * cfg.capacity)
                       if decode_steps else 0.0),
            step_seconds=step_seconds,
            sampler_stats=self.sampler.stats())
