"""Fault-tolerant execution loop (checkpoint/restart around a training
step) and scripted fault injection for the serving and decode tiers.

  * ``FaultTolerantLoop`` - wraps a step function with periodic async
    checkpoints and restart-from-latest semantics.  Because the data
    pipeline and all randomness are counter-addressed (pure functions of
    (seed, step)), resume needs nothing beyond (params, opt, step) and
    the lease ledger: no iterator state, no RNG state files.
  * ``SimulatedFailure`` - deterministic fault injection for tests: raise
    at step k, prove the restarted run converges to the same states.
  * ``FaultPlan`` / ``FaultInjector`` - scripted faults (kill / hang /
    drop-frame / slow) at specific request or decode-step indices, either
    written out explicitly (``FaultPlan.parse("kill@512")``) or drawn from
    a seed (``FaultPlan.seeded``) so adversarial runs replay exactly.  The
    inference tier's ``ContinuousBatcher`` keys them on the decode step.

A plan's JSON form (``to_json`` / ``from_json``) is the reference's, so a
plan written by either package parses in the other.
"""
from __future__ import annotations

import dataclasses
import json
import random
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import engine
from repro_torch.optim.adamw import AdamWState


class SimulatedFailure(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Scripted fault injection (the serving fleet's and the decode loop's adversary)
# ---------------------------------------------------------------------------

#: fault kinds a shard can inject when the matching request arrives
FAULT_KINDS = ("kill", "hang", "drop", "slow")

_RID_DIGITS = re.compile(r"(\d+)\s*$")


def rid_index(rid: Optional[str]) -> Optional[int]:
    """Request index encoded in a rid's trailing digits (``burst/000512``
    -> 512); ``None`` when the rid carries no index.  Faults key on this
    so "kill at request 512" means the same request in every run,
    regardless of which shard the hash ring routes it to."""
    if not rid:
        return None
    m = _RID_DIGITS.search(rid)
    return int(m.group(1)) if m else None


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: inject ``kind`` when request ``index`` reaches
    a shard (optionally only shard ``shard``).

    Kinds (what the transport layer does when the spec fires):
      * ``kill`` — ``os._exit`` before serving: SIGKILL semantics, no
        journal write for the triggering request, flock released.
      * ``hang`` — wedge the whole host: this request and every later
        one (including reconnect retries) stalls indefinitely while the
        process stays alive holding its journal flock — the
        live-but-unresponsive shard that fencing (SIGKILL + peer
        adoption) exists for.
      * ``drop`` — serve and journal the request, then close the
        connection without sending the reply frame (torn response; the
        client's retry must be answered by journal replay, bit-identically).
      * ``slow`` — sleep ``seconds`` before serving, then serve normally.
    """
    kind: str
    index: int
    shard: Optional[int] = None
    seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FAULT_KINDS}")
        if self.index < 0:
            raise ValueError(f"fault index must be >= 0, got {self.index}")

    def to_wire(self) -> Dict[str, Any]:
        return {"kind": self.kind, "index": self.index,
                "shard": self.shard, "seconds": self.seconds}

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "FaultSpec":
        return cls(kind=d["kind"], index=int(d["index"]),
                   shard=(None if d.get("shard") is None
                          else int(d["shard"])),
                   seconds=float(d.get("seconds", 0.0)))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered script of :class:`FaultSpec` — the whole adversary of
    one run, serializable so the exact same faults replay in CI.

    Example:
        >>> from repro_torch.runtime.fault import FaultPlan
        >>> plan = FaultPlan.parse("kill@512,slow@600~0.05")
        >>> [s.kind for s in plan.specs]
        ['kill', 'slow']
        >>> FaultPlan.from_json(plan.to_json()) == plan
        True
    """
    specs: Tuple[FaultSpec, ...] = ()

    def __bool__(self) -> bool:
        return bool(self.specs)

    def to_json(self) -> str:
        return json.dumps([s.to_wire() for s in self.specs],
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls(specs=tuple(FaultSpec.from_wire(d)
                               for d in json.loads(text)))

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Mini-DSL: comma-separated ``kind@index[#shard][~seconds]``
        (e.g. ``"kill@512"``, ``"hang@40#1~30"``).  An empty string is
        the empty plan; a string starting with ``[`` is taken as the
        JSON form (what ``--fault-plan`` accepts either way)."""
        text = text.strip()
        if not text:
            return cls()
        if text.startswith("["):
            return cls.from_json(text)
        specs: List[FaultSpec] = []
        for part in text.split(","):
            part = part.strip()
            kind, _, rest = part.partition("@")
            if not rest:
                raise ValueError(f"fault spec {part!r} needs kind@index")
            seconds = 0.0
            if "~" in rest:
                rest, _, sec = rest.partition("~")
                seconds = float(sec)
            shard: Optional[int] = None
            if "#" in rest:
                rest, _, sh = rest.partition("#")
                shard = int(sh)
            specs.append(FaultSpec(kind=kind.strip(), index=int(rest),
                                   shard=shard, seconds=seconds))
        return cls(specs=tuple(specs))

    @classmethod
    def seeded(cls, seed: int, *, burst: int,
               kinds: Tuple[str, ...] = ("kill",), count: int = 1,
               seconds: float = 0.05, lo_frac: float = 0.25,
               hi_frac: float = 0.75) -> "FaultPlan":
        """A replayable random adversary: ``count`` faults of ``kinds``
        at distinct request indices drawn from the middle of a
        ``burst``-request run — a pure function of ``seed``."""
        rng = random.Random(seed ^ 0xFA17)
        lo = int(burst * lo_frac)
        hi = max(lo + 1, int(burst * hi_frac))
        idxs = rng.sample(range(lo, hi), min(count, hi - lo))
        return cls(specs=tuple(
            FaultSpec(kind=rng.choice(list(kinds)), index=i,
                      seconds=seconds)
            for i in sorted(idxs)))


class FaultInjector:
    """Stateful per-process trigger for a :class:`FaultPlan`.

    ``fire(shard, index)`` returns the first not-yet-fired spec matching
    ``(shard, index)`` and marks it fired — each scripted fault happens
    exactly once, so a retried request (same rid, hence same index)
    sails through on its second arrival.  Thread-safe: connection
    handler threads all consult one injector.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fired: set = set()
        self._lock = threading.Lock()

    def fire(self, shard: int, index: Optional[int]) -> Optional[FaultSpec]:
        if index is None:
            return None
        with self._lock:
            for i, spec in enumerate(self.plan.specs):
                if i in self._fired:
                    continue
                if spec.index != index:
                    continue
                if spec.shard is not None and spec.shard != shard:
                    continue
                self._fired.add(i)
                return spec
        return None


@dataclasses.dataclass
class FaultTolerantLoop:
    """Checkpoint/restart around a step function; a restored state is
    placed on ``device`` (the card unless given)."""
    ckpt: CheckpointManager
    save_every: int = 50
    max_restarts: int = 3
    device: Any = None

    def run(self, *, init_state: Callable[[], Any], step_fn, num_steps: int,
            fail_at: Optional[int] = None,
            on_metrics=None,
            extra_state: Optional[Callable[[], Dict[str, Any]]] = None,
            on_restore: Optional[Callable[[Optional[Dict[str, Any]], int],
                                          None]] = None) -> Any:
        """Run ``num_steps`` with checkpoint/restart.

        ``init_state()`` -> (params, opt_state); ``step_fn(params, opt,
        step)`` -> (params, opt, metrics).  ``fail_at``: inject a
        SimulatedFailure the first time that step is reached (tests).

        ``extra_state()`` -> JSON-able dict saved with every checkpoint
        (e.g. the BlockService lease ledger); ``on_restore(extra, step)``
        is called once per (re)start BEFORE stepping - with the restored
        extra dict, or ``None`` on a from-scratch start - so runtime
        state outside (params, opt) rewinds with the model.
        """
        restarts = 0
        failed_once = False
        while True:
            try:
                state, start, extra = self._restore_or_init(init_state)
                params, opt_state = state
                if on_restore is not None:
                    on_restore(extra, start)
                for step in range(start, num_steps):
                    if fail_at is not None and step == fail_at \
                            and not failed_once:
                        failed_once = True
                        raise SimulatedFailure(f"injected at step {step}")
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         step)
                    if on_metrics is not None:
                        on_metrics(step, metrics)
                    done = step + 1
                    if done % self.save_every == 0 or done == num_steps:
                        self.ckpt.save(done, {"params": params,
                                              "opt": _opt_to_tree(opt_state)},
                                       extra=extra_state() if extra_state
                                       else None)
                self.ckpt.wait()
                return params, opt_state
            except SimulatedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                # controller restarts us; loop resumes from latest ckpt

    def _restore_or_init(self, init_state):
        # a save still being written when a step failed lands first, so
        # the restart point does not depend on the writer's timing
        self.ckpt.wait()
        latest = self.ckpt.latest()
        if latest is None:
            return init_state(), 0, None
        tree, step, extra = self.ckpt.restore(
            device=engine.resolve_device(self.device))
        params = tree["params"]
        opt_state = _opt_from_tree(tree["opt"])
        return (params, opt_state), step, extra


def _opt_to_tree(opt_state) -> Dict[str, Any]:
    return {"step": opt_state.step, "m": opt_state.m, "v": opt_state.v}


def _opt_from_tree(tree) -> AdamWState:
    step = torch.as_tensor(tree["step"]).to("cpu", torch.int32)
    return AdamWState(step.reshape(()), tree["m"], tree["v"])
