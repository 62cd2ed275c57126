"""One run of a benchmark cell with the port's tracer (``repro_torch.trace``)
on in the measured window: the per-layer numbers that read the program's
own spans and counters, beside the benchmark's.

It sets up and measures a cell as ``bench/harness.run_cell`` does (the
same ``bench/drivers`` module, set-up, window and check), and in addition:

  * enables the tracer just before the window and drains it just after;
  * takes the program's counters before and after the window (deltas);
  * merges the program's spans into the ranges the device trace labels
    its idle gaps with, on the same ``epoch_ns`` mapping: a gap is labelled
    by the innermost span of the window's thread that covers its middle,
    and ``|<name>`` is appended when a span of another thread (the
    producer's) covers it too, e.g. ``host:next|blocks.ring_wait``;
  * reports ``producer_launch_ms`` (mean ``blocks.launch`` per fused
    stack), ``mc_plan_ms`` and ``mc_launch_ms`` (``ops.mc_plans`` and
    ``mc.launch`` host ms per ``blocks.app``), ``leaf_tables_per_call``
    (the window's ``engine.leaf_tables`` over its ``blocks.app`` spans) and
    ``fwd_bwd_ms`` (mean ``train.fwd_bwd`` device ms a step), with every
    span's count, mean and self time (less its children's).

``--profile 0`` leaves the profiler off; with ``--spans 0`` the tracer
stays off as well, so ``--profile 0 --spans 1`` against ``--profile 0
--spans 0`` in one call measures what the program's spans cost end to end.
Prints one JSON line.  On a card:

    python3 tools/trace_cell.py --workload mc-apps --seed 7 --seconds 30
"""
from __future__ import annotations

import argparse
import bisect
import itertools
import json
import statistics
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


class _Ranges:
    """(name, start, end) ranges sorted by start, for the innermost one
    covering a time: the latest-starting range that has not ended."""

    def __init__(self, ranges: List[Tuple[str, int, int]]):
        self.ranges = sorted(ranges, key=lambda r: r[1])
        self.starts = [r[1] for r in self.ranges]
        # the latest end among ranges[:i + 1]: no earlier range covers t
        # once it is <= t
        self.reach = list(itertools.accumulate(
            (r[2] for r in self.ranges), max))

    def innermost(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] > t:
            if self.ranges[i][2] > t:
                return self.ranges[i][0]
            i -= 1
        return None


class ProgramTrace(harness.DeviceTrace):
    """A device trace whose gap labels also read the program's spans."""

    def __init__(self, base: harness.DeviceTrace, spans, epoch_ns: int,
                 thread: str):
        self.__dict__.update(base.__dict__)
        mine, other = [], []
        for s in spans:
            r = (s.name, s.start_ns + epoch_ns, s.end_ns + epoch_ns)
            (mine if s.thread == thread else other).append(r)
        self.mine = _Ranges(self.ranges + mine)
        self.other = _Ranges(other)

    def ops_per_span(self, spans, epoch_ns: int) -> Dict[str, float]:
        """Per span name: device operations starting inside its spans, a
        span (a span counts those of its children too)."""
        starts = sorted(s for _, s, _ in self.ops)
        got: Dict[str, List[int]] = {}
        for sp in spans:
            a = bisect.bisect_left(starts, sp.start_ns + epoch_ns)
            b = bisect.bisect_left(starts, sp.end_ns + epoch_ns)
            got.setdefault(sp.name, []).append(b - a)
        return {k: statistics.fmean(v) for k, v in got.items()}

    def _doing(self, s: int, e: int) -> str:
        mid = (s + e) // 2
        name = self.mine.innermost(mid)
        label = f"host:{name}" if name else "host:other"
        other = self.other.innermost(mid)
        return f"{label}|{other}" if other else label


def span_table(spans) -> Dict[str, Dict[str, Any]]:
    """Per span name: count, mean and self ms (host), mean device ms."""
    kids: Dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            kids[s.parent] = kids.get(s.parent, 0) + (s.end_ns - s.start_ns)
    out: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        d = out.setdefault(s.name, {"count": 0, "ms": 0.0, "self_ms": 0.0,
                                    "device_ms": []})
        d["count"] += 1
        d["ms"] += s.ms
        d["self_ms"] += (s.end_ns - s.start_ns - kids.get(s.id, 0)) * 1e-6
        if s.device_ms is not None:
            d["device_ms"].append(s.device_ms)
    for d in out.values():
        d["mean_ms"] = d["ms"] / d["count"]
        dev = d.pop("device_ms")
        d["device_mean_ms"] = statistics.fmean(dev) if dev else None
    return out


def program_metrics(table: Dict[str, Dict[str, Any]],
                    deltas: Dict[str, int]) -> Dict[str, float]:
    """The per-layer numbers that read the program's spans and counters,
    where the window has what they read."""
    out: Dict[str, float] = {}
    if "blocks.launch" in table:
        out["producer_launch_ms"] = table["blocks.launch"]["mean_ms"]
    apps = table.get("blocks.app", {}).get("count", 0)
    if apps:
        for metric, name in (("mc_plan_ms", "ops.mc_plans"),
                             ("mc_launch_ms", "mc.launch")):
            if name in table:
                out[metric] = table[name]["ms"] / apps
        out["leaf_tables_per_call"] = \
            deltas.get("engine.leaf_tables", 0) / apps
    fb = table.get("train.fwd_bwd", {}).get("device_mean_ms")
    if fb is not None:
        out["fwd_bwd_ms"] = fb
    return out


def run(workload: str, *, seed: int, seconds: float, profile: bool = True,
        spans: bool = True, device="cuda",
        traffic_overrides: Optional[Dict[str, Any]] = None,
        config_overrides: Optional[Dict[str, Any]] = None
        ) -> Dict[str, Any]:
    import torch
    from repro_torch import trace
    t_start = time.time()
    spec = harness.with_held(harness.load_spec())
    cell, config, traffic = harness.cell_files(spec, workload)
    config = {**config, **(config_overrides or {})}
    traffic = {**traffic, **(traffic_overrides or {})}
    device = torch.device(device)
    r = harness.Run(workload=workload, seed=int(seed), seconds=float(seconds),
                    trace=profile, device=device, cell=cell, config=config,
                    traffic=traffic)
    program = harness.driver_module(traffic["driver"]).Cell(r)
    r.sync()
    setup_s = time.time() - t_start
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    r.spans.clear()
    trace.drain()
    before = trace.counters()
    epoch_ns = time.time_ns() - time.perf_counter_ns()
    if spans:
        trace.enable()
    r.t0 = time.perf_counter()
    try:
        program.window(r)
        r.sync()
        r.t1 = time.perf_counter()
    finally:
        trace.disable()
        if prof is not None:
            prof.__exit__(None, None, None)
    records = trace.drain()
    after = trace.counters()
    r.notes["peak_window_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if cuda else 0)
    deltas = {k: v - before.get(k, 0) for k, v in after.items()
              if v != before.get(k, 0)}
    out: Dict[str, Any] = {"workload": workload, "seed": int(seed),
                           "profile": profile, "spans": spans,
                           "setup_s": setup_s}
    if prof is not None:
        base = harness.DeviceTrace.from_profiler(prof, r, epoch_ns)
        r.device_trace = ProgramTrace(base, records, epoch_ns,
                                      threading.current_thread().name)
        del prof
    out["end_to_end"] = program.end_to_end(r)
    program.release()
    checks = program.check(r)
    out["correct"] = all(c.ok for c in checks) and program.failed == 0
    table = span_table(records)
    metrics = program_metrics(table, deltas)
    if profile:
        for m in harness.cell_metrics(spec, workload, "per_layer"):
            value = harness.metric_reader(m["name"])(r)
            if value is not None and m["name"] not in metrics:
                metrics[m["name"]] = value
    out["metrics"] = metrics
    out["spans_by_name"] = table
    out["counters"] = deltas
    if r.device_trace is not None:
        tr = r.device_trace
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = tr.breakdown(n=20)
        out["device_ops_per_span"] = tr.ops_per_span(records, epoch_ns)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_cell: needs a CUDA device", file=sys.stderr)
        return 2
    line = harness.card_line(torch.device("cuda", 0))
    out = run(args.workload, seed=args.seed, seconds=args.seconds,
              profile=bool(args.profile), spans=bool(args.spans))
    out["card"], out["power_limit"] = line["card"], line["power_limit"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
