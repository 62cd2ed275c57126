"""Offline-inference benchmark harness: run, measure, verify, report.

``run_offline`` executes one :class:`ContinuousBatcher` schedule and
reduces it to the serving metrics the tier is judged by:

  * throughput — sampled tokens per second of decode wall time;
  * latency   — p50/p99 per-token latency, where one token's latency is
    its decode step's wall time (all live sequences' tokens in a step
    share the step; this is the standard continuous-batching
    accounting, and is what makes p99 an admission/churn tail metric
    rather than a kernel metric);
  * occupancy — mean live slots / capacity over decode steps;
  * calls/step — sampling-engine calls per decode step per class (the
    coalescing meter: one fused call serves the whole batch, so it is
    1.0).

Step wall times end in the tokens' copy to the host, so on the card they
are device time plus host work, not an enqueue time.

``--parity`` re-runs the identical schedule on the two-pass path of the
device's engine backend (``"cuda"`` on the card, ``"torch"`` on the CPU)
and asserts transcript-digest equality - kernel F's token streams are
thereby checked against engine-generated noise on every run of the
harness, not just in unit tests.  ``--fault-plan kill@K`` arms the scripted
adversary (the process dies at decode step K); re-running with the same
``--journal`` replays the journaled prefix bit-identically and the
digest must equal a fault-free run's (the crash-replay acceptance
check).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Optional

from repro_torch.core import engine
from repro_torch.runtime import fault
from repro_torch.service import audit
from repro_torch.inference.sampling import twopass_path
from repro_torch.inference.scheduler import (ContinuousBatcher, RunResult,
                                             ScheduleConfig)


@dataclasses.dataclass
class OfflineReport:
    """JSON-able summary of one offline serving run."""
    config: ScheduleConfig
    result: RunResult
    wall_seconds: float
    parity_digest: Optional[str] = None   # two-pass digest when checked
    device: str = "cpu"                   # where the run ran

    @property
    def tokens_per_s(self) -> float:
        decode = sum(self.result.step_seconds)
        return self.result.total_tokens / decode if decode else 0.0

    def to_json(self) -> Dict:
        lat = self.result.latency_percentiles()
        r = self.result
        return {
            "config": dataclasses.asdict(self.config),
            "decode_steps": r.decode_steps,
            "total_tokens": r.total_tokens,
            "admitted": r.admitted,
            "retired": r.retired,
            "occupancy": round(r.occupancy, 4),
            "tokens_per_s": round(self.tokens_per_s, 1),
            "p50_ms": round(lat["p50_ms"], 3),
            "p99_ms": round(lat["p99_ms"], 3),
            "calls_per_step": r.sampler_stats["calls_per_step"],
            "replayed_steps": r.sampler_stats["replayed_steps"],
            "digest": r.digest,
            "parity_digest": self.parity_digest,
            "wall_seconds": round(self.wall_seconds, 3),
            "device": self.device,
        }


def run_offline(config: ScheduleConfig, *,
                journal_path: Optional[str] = None,
                fault_plan: Optional[fault.FaultPlan] = None,
                parity: bool = False, device=None) -> OfflineReport:
    """One offline continuous-batching run (+ optional parity re-run).

    ``journal_path`` arms the audit journal: a fresh path records the
    run; an existing one restores-and-replays it (the kill-and-restart
    flow is two calls with the same path).  ``parity=True`` re-runs the
    schedule on the two-pass path of the device's engine backend and
    asserts the transcript digests match (skipped when the primary path
    IS a two-pass path).  ``device``: the card unless ``"cpu"`` is given.
    """
    device = engine.resolve_device(device)
    journal = audit.Journal(journal_path) if journal_path else None
    try:
        t0 = time.perf_counter()
        result = ContinuousBatcher(config, journal=journal,
                                   fault_plan=fault_plan,
                                   device=device).run()
        wall = time.perf_counter() - t0
    finally:
        if journal is not None:
            journal.close()

    parity_digest = None
    if parity and config.path == "fused":
        twopass = dataclasses.replace(config, path=twopass_path(device))
        ref = ContinuousBatcher(twopass, device=device).run()
        parity_digest = ref.digest
        if ref.digest != result.digest:
            raise AssertionError(
                f"fused vs two-pass transcript digest mismatch: "
                f"{result.digest} != {ref.digest}")
    return OfflineReport(config=config, result=result, wall_seconds=wall,
                         parity_digest=parity_digest, device=str(device))


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.inference",
        description="offline continuous-batching serving harness")
    p.add_argument("--batch", type=int, default=64,
                   help="slot capacity (decode batch)")
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--sequences", type=int, default=128,
                   help="total sequences to serve")
    p.add_argument("--rate", type=float, default=8.0,
                   help="Poisson arrival rate (sequences per decode step)")
    p.add_argument("--min-len", type=int, default=4)
    p.add_argument("--len-spread", type=int, default=29)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--path", choices=("fused", "cuda", "torch"),
                   default="fused")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain path)")
    p.add_argument("--max-steps", type=int, default=100_000)
    p.add_argument("--journal", default=None,
                   help="audit journal path (existing = restore + replay)")
    p.add_argument("--fault-plan", default="",
                   help='scripted faults, e.g. "kill@12" (decode-step '
                        'indexed)')
    p.add_argument("--digest-out", default=None,
                   help="write the transcript digest to this file")
    p.add_argument("--parity", action="store_true",
                   help="re-run on the two-pass path and assert digest "
                        "parity")
    p.add_argument("--json", action="store_true",
                   help="print the full JSON report")
    args = p.parse_args(argv)

    config = ScheduleConfig(
        capacity=args.batch, vocab=args.vocab, sequences=args.sequences,
        rate=args.rate, min_len=args.min_len, len_spread=args.len_spread,
        seed=args.seed, temperature=args.temperature, top_k=args.top_k,
        path=args.path, max_steps=args.max_steps)
    plan = fault.FaultPlan.parse(args.fault_plan)
    report = run_offline(config, journal_path=args.journal,
                         fault_plan=plan or None, parity=args.parity,
                         device=args.device)
    j = report.to_json()
    if args.digest_out:
        with open(args.digest_out, "w") as f:
            f.write(j["digest"] + "\n")
    if args.json:
        print(json.dumps(j, indent=2, sort_keys=True))
    else:
        print(f"served {j['retired']}/{j['admitted']} sequences, "
              f"{j['total_tokens']} tokens in {j['decode_steps']} steps | "
              f"{j['tokens_per_s']} tok/s | occupancy {j['occupancy']} | "
              f"p50 {j['p50_ms']}ms p99 {j['p99_ms']}ms | "
              f"calls/step {j['calls_per_step']:.2f} | "
              f"digest {j['digest'][:16]} | {j['device']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
