"""The benchmark's general part: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``, with its plain
reference ``reference/<kind>.py``) and a traffic mix
(``traffic/<name>.json``).  The traffic's ``driver`` names the general
code that drives the program under it (``drivers/<driver>.py``); each
per-layer metric is a reader of its own (``metrics/<metric>.py``).  All of
them are found by name, so a cell, a configuration or a metric is added by
adding files and entries.  A cell held out of ``BENCHMARK.json`` keeps
its entries in ``held/<cell>.json``, where the controls and the tests
still find it.

A run: set-up (inputs from the seed, the program built and warmed on the
cell's shapes), a measured window of ``--seconds``, then, with the
program's state freed, the comparison of what the window produced with the
plain reference.  It prints one JSON line last on standard output, with the
numbers compared, each beside its limit, under ``checks`` (also the last
lines on standard error).
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """The benchmark cannot run here (no card, a bad cell name, ...)."""


def process_start() -> float:
    """The epoch time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


# ---------------------------------------------------------------------------
# The benchmark's data
# ---------------------------------------------------------------------------

def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def with_held(spec: Dict[str, Any], bench: Path = BENCH) -> Dict[str, Any]:
    """``spec`` with the cells held out of ``BENCHMARK.json`` (each file of
    ``held/`` holds a cell's entries, which ``bench/run.py`` does not run),
    for the controls and the tests, which drive them still."""
    out = json.loads(json.dumps(spec))
    for path in sorted((bench / "held").glob("*.json")):
        held = load_json(path)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            out[key] += held.get(key, [])
    return out


def find(entries: List[Dict[str, Any]], name: str, what: str
         ) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchError(f"no {what} named {name!r}; have "
                     f"{[e['name'] for e in entries]}")


def cell_files(spec: Dict[str, Any], workload: str, root: Path = ROOT,
               bench: Path = BENCH) -> Tuple[Dict, Dict, Dict]:
    """(cell, configuration file, traffic file) of a workload."""
    cell = find(spec["workloads"], workload, "workload")
    conf = find(spec["configs"], cell["config"], "configuration")
    config = load_json(root / conf["file"])
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def load_file_module(path: Path, name: str):
    """Import a file by path (metric readers' names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH) -> Callable:
    """The reader ``metrics/<name>.py``, else the one that the metrics
    ``<stem>.<cells>`` share, ``metrics/<stem>.py`` (``idle_pct.decode``
    reads with ``idle_pct.py``)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench / "metrics" / f"{name.split('.', 1)[0]}.py"
    mod = load_file_module(path, f"bench_metric_{path.stem.replace('.', '_')}")
    return mod.read


def driver_module(name: str):
    return importlib.import_module(f"bench.drivers.{name}")


def cell_metrics(spec: Dict[str, Any], workload: str, kind: str
                 ) -> List[Dict[str, Any]]:
    """The end_to_end or per_layer metrics a workload reports."""
    out = []
    for m in spec[kind]:
        cells = m.get("workloads")
        if cells is None and kind == "per_layer":
            moved = find(spec["end_to_end"], m["moves"], "metric")
            cells = moved.get("workloads")
        if cells is None or workload in cells:
            out.append(m)
    return out


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

class Check:
    """One number compared with the reference: correct while value <=
    limit."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit   # NaN fails


class Run:
    """What a driver and the metric readers share: the cell's data, the
    device, host spans and counters, and after a traced window the
    device's trace."""

    def __init__(self, *, workload: str, seed: int, seconds: float,
                 trace: bool, device, cell: Dict, config: Dict,
                 traffic: Dict):
        self.workload, self.seed, self.seconds = workload, seed, seconds
        self.trace, self.device = trace, device
        self.cell, self.config, self.traffic = cell, config, traffic
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.counters: Dict[str, float] = {}
        self.notes: Dict[str, Any] = {}
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.device_trace: Optional["DeviceTrace"] = None

    # -- host instrumentation ---------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span on the host's clock around a call into the program;
        in a traced run the spans label the device's idle gaps."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append((t, time.perf_counter()))

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def span_ms(self, name: str) -> List[float]:
        return [(b - a) * 1e3 for a, b in self.spans.get(name, [])]

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


# ---------------------------------------------------------------------------
# The device's trace
# ---------------------------------------------------------------------------

def _intervals_union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class DeviceTrace:
    """Device operations of a profiled window and the run's host spans,
    in the profiler's clock (epoch nanoseconds), clipped to the window.

    ``epoch_ns`` is the epoch time, in ns, of ``perf_counter() == 0``: the
    host spans are taken on ``perf_counter`` and moved onto the profiler's
    clock by it."""

    def __init__(self, ops: List[Tuple[str, int, int]], run: "Run",
                 epoch_ns: int):
        ns = lambda t: int(t * 1e9) + epoch_ns
        self.w0, self.w1 = ns(run.t0), ns(run.t1)
        self.ops = [(n, max(s, self.w0), min(e, self.w1)) for n, s, e in ops
                    if e > self.w0 and s < self.w1]
        self.ranges = sorted(((name, ns(a), ns(b)) for name, spans in
                              run.spans.items() for a, b in spans),
                             key=lambda r: r[1])
        self._starts = [r[1] for r in self.ranges]
        self.busy = _intervals_union([(s, e) for _, s, e in self.ops])
        self._busy_ends = [e for _, e in self.busy]

    @classmethod
    def from_profiler(cls, prof, run: "Run", epoch_ns: int
                      ) -> "DeviceTrace":
        """The device's operations (kernels, copies, sets) of a profile
        taken with the CUDA activity alone."""
        from torch.autograd import DeviceType
        ops = []
        for e in prof.profiler.kineto_results.events():
            if (e.device_type() == DeviceType.CUDA
                    and not e.is_user_annotation()):
                s = e.start_ns()
                ops.append((e.name(), s, s + e.duration_ns()))
        return cls(ops, run, epoch_ns)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def op_seconds(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(summed seconds, count) of the device operations whose name
        ``match`` accepts."""
        sel = [(s, e) for n, s, e in self.ops if match(n)]
        return sum(e - s for s, e in sel) * 1e-9, len(sel)

    def ops_in(self, match: Callable[[str], bool], span: str
               ) -> List[Tuple[float, float]]:
        """Per ``span`` range: (range seconds, seconds of matching device
        operations that start inside it)."""
        rs = sorted((s, e) for n, s, e in self.ranges if n == span)
        sel = sorted(s_e for n, *s_e in self.ops if match(n))
        out, j = [], 0
        for s, e in rs:
            dev = 0
            while j < len(sel) and sel[j][0] < s:
                j += 1
            k = j
            while k < len(sel) and sel[k][0] < e:
                dev += sel[k][1] - sel[k][0]
                k += 1
            out.append(((e - s) * 1e-9, dev * 1e-9))
        return out

    def busy_in(self, span: str) -> Tuple[float, int]:
        """(device-busy seconds inside the ``span`` ranges, their count)."""
        rs = [(s, e) for n, s, e in self.ranges if n == span]
        busy = 0
        for s, e in rs:
            i = bisect.bisect_right(self._busy_ends, s)
            while i < len(self.busy) and self.busy[i][0] < e:
                a, b = self.busy[i]
                busy += min(b, e) - max(a, s)
                i += 1
        return busy * 1e-9, len(rs)

    def breakdown(self, n: int = 10) -> Dict[str, List[List[Any]]]:
        by_op: Dict[str, int] = {}
        for name, s, e in self.ops:
            by_op[name] = by_op.get(name, 0) + (e - s)
        gaps: Dict[str, int] = {}
        prev = self.w0
        edges = self.busy + [(self.w1, self.w1)]
        for s, e in edges:
            if s > prev:
                doing = self._doing(prev, s)
                gaps[doing] = gaps.get(doing, 0) + s - prev
            prev = max(prev, e)
        top = lambda d: [[k, v * 1e-9] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}

    def _doing(self, s: int, e: int) -> str:
        """The host span covering a gap's middle: the latest-starting one,
        the innermost where spans nest."""
        mid = (s + e) // 2
        i = bisect.bisect_right(self._starts, mid) - 1
        while i >= 0 and self.ranges[i][2] <= mid:
            i -= 1
            if i >= 0 and mid - self.ranges[i][1] > 60e9:
                i = -1
        return f"host:{self.ranges[i][0]}" if i >= 0 else "host:other"


# ---------------------------------------------------------------------------
# The host during the window
# ---------------------------------------------------------------------------

class HostWatch:
    """What the host did while the window ran, for a run whose rate the
    host paces: this process's CPU time and context switches, the garbage
    collector's passes, and each span's mean in the window's two halves."""

    def __init__(self):
        self.gc_s, self.gc_passes, self._gc_t = 0.0, 0, 0.0
        self.ru0 = self._rusage()
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_passes += 1

    @staticmethod
    def _rusage():
        import resource
        return resource.getrusage(resource.RUSAGE_SELF)

    def close(self, run: "Run") -> Dict[str, Any]:
        gc.callbacks.remove(self._on_gc)
        ru, ru0 = self._rusage(), self.ru0
        mid = (run.t0 + run.t1) / 2
        halves = {}
        for name, spans in run.spans.items():
            ms = [[(b - a) * 1e3 for a, b in spans if (a < mid) == first]
                  for first in (True, False)]
            halves[name] = [sum(x) / len(x) if x else None for x in ms]
        return {"user_s": ru.ru_utime - ru0.ru_utime,
                "sys_s": ru.ru_stime - ru0.ru_stime,
                "ctx_switches": ru.ru_nvcsw - ru0.ru_nvcsw,
                "preempted": ru.ru_nivcsw - ru0.ru_nivcsw,
                "gc_s": self.gc_s, "gc_passes": self.gc_passes,
                "span_ms_halves": halves}


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def card_line(device) -> Dict[str, Any]:
    """The card's name and power limit, with the published peaks the
    metrics divide by."""
    import torch
    from bench import peaks
    limit = "unknown"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20)
        if out.returncode == 0:
            limit = out.stdout.strip().split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"card": torch.cuda.get_device_name(device), "power_limit": limit,
            "peaks": peaks.H100_SXM}


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def run_cell(spec: Dict[str, Any], workload: str, *, seed: int,
             seconds: float, trace: bool, device,
             t_start: Optional[float] = None,
             traffic_overrides: Optional[Dict[str, Any]] = None,
             config_overrides: Optional[Dict[str, Any]] = None,
             root: Path = ROOT, bench: Path = BENCH) -> Dict[str, Any]:
    """Set up, measure and check one run; the result object.

    ``device`` is where the program runs; the overrides replace keys of
    the traffic and configuration files (the tests' small sizes); ``root``
    holds the configuration files, ``bench`` the traffic and metrics.
    """
    import torch
    t_start = time.time() if t_start is None else t_start
    cell, config, traffic = cell_files(spec, workload, root, bench)
    config = {**config, **(config_overrides or {})}
    traffic = {**traffic, **(traffic_overrides or {})}
    device = torch.device(device)
    run = Run(workload=workload, seed=int(seed), seconds=float(seconds),
              trace=bool(trace), device=device, cell=cell, config=config,
              traffic=traffic)
    driver = driver_module(traffic["driver"])
    cuda = device.type == "cuda"

    program = driver.Cell(run)
    run.sync()
    setup_s = time.time() - t_start
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        prof = profile(activities=acts)
        prof.__enter__()
    run.spans.clear()               # the set-up's spans are not the window's
    host = HostWatch()
    epoch_ns = time.time_ns() - time.perf_counter_ns()
    run.t0 = time.perf_counter()
    try:
        program.window(run)
        run.sync()
        run.t1 = time.perf_counter()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    host_line = host.close(run)
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.notes["peak_window_bytes"] = peak_window
    if prof is not None:
        run.device_trace = DeviceTrace.from_profiler(prof, run, epoch_ns)
        del prof

    e2e = program.end_to_end(run)
    program.release()
    checks = program.check(run)

    result: Dict[str, Any] = {
        "correct": all(c.ok for c in checks) and program.failed == 0,
        "attempted": program.attempted, "failed": program.failed}
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in cell_metrics(spec, workload, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(spec, workload, "per_layer"):
            value = metric_reader(m["name"], bench)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    dev: Dict[str, Any] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": int(cell.get("chips", 1)),
        "memory_peak_bytes": int(max(peak_setup, peak_window))}
    if trace and run.device_trace is not None:
        dev["busy_s"] = run.device_trace.busy_s
        dev["window_s"] = run.device_trace.window_s
        result["breakdown"] = run.device_trace.breakdown()
    result["device"] = dev
    result["host"] = host_line
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parse_args(argv)
    spec = load_spec()
    cell = find(spec["workloads"], args.workload, "workload")
    import torch
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA device(s); "
              f"available={torch.cuda.is_available()} "
              f"count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(json.dumps(card_line(device)), file=sys.stderr, flush=True)
    result = run_cell(spec, args.workload, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=device, t_start=t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"host": result.pop("host")}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
