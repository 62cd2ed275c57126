"""Readings that set the limits of ``correct``: the program's over many
seeds and the control's, at a cell's own size, in one process a cell.

  python3 bench/controls.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed: the numbers the cell compares, for the
program (a short window at the cell's load) and for its control, the step
that would tempt a later change:

  misrn-bulk   the program's own cheaper decorrelator (fmix32) in place of
               the splitmix64 the configuration states
  mc-apps      the reference's integrand in bfloat16, one precision below
               the float32 the apps compute in; besides, the reference's
               answer over the next window (a kernel reading the wrong
               counters)
  glm4-decode  the reference's matrix products with fp8 operands, one
               precision below the bfloat16 the configuration states
  glm4-train   the same fp8 reference followed through the checked steps
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from bench import harness  # noqa: E402


def _run(spec, workload, seed, seconds, device, **overrides):
    cell, config, traffic = harness.cell_files(spec, workload)
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    return harness.Run(workload=workload, seed=seed, seconds=seconds,
                       trace=False, device=torch.device(device), cell=cell,
                       config=config, traffic=traffic)


def _window(run, program):
    run.spans.clear()
    run.t0 = time.perf_counter()
    program.window(run)
    run.sync()
    run.t1 = time.perf_counter()


def bulk(spec, seed, seconds, device, traffic_overrides=None,
         config_overrides=None):
    out = {}
    for label, deco in (("program", "splitmix64"), ("control", "fmix32")):
        r = harness.run_cell(spec, "misrn-bulk", seed=seed, seconds=seconds,
                             trace=False, device=device,
                             traffic_overrides=traffic_overrides,
                             config_overrides={**(config_overrides or {}),
                                               "deco": deco})
        out[label] = {k: v["value"] for k, v in r["checks"].items()}
    return out


def mc(spec, seed, seconds, device, **kw):
    from bench.drivers import mc as mc_driver
    r = harness.run_cell(spec, "mc-apps", seed=seed, seconds=seconds,
                         trace=False, device=device, **kw)
    run = _run(spec, "mc-apps", seed, seconds, device,
               traffic=kw.get("traffic_overrides", {}))
    t = run.traffic
    dev = torch.device(device)
    control, fault = {}, {}
    for app in ("pi", "option"):
        worst = near = 0.0
        for k in range(int(t["samples"])):
            args = (run.config, app, seed, int(t["lanes"]), int(t["draws"]))
            lo = k * int(t["draws"])
            ref = mc_driver.reference_answer(*args, lo=lo, device=dev)
            low = mc_driver.reference_answer(*args, lo=lo, device=dev,
                                             dtype=torch.bfloat16)
            # an answer drawn from the next window, as a kernel that read
            # the wrong counters would give it
            moved = mc_driver.reference_answer(
                *args, lo=lo + int(t["draws"]), device=dev)
            worst = max(worst, abs(low - ref) / abs(ref))
            near = max(near, abs(moved - ref) / abs(ref))
        control[f"{app}_rel_err"] = worst
        fault[f"{app}_rel_err"] = near
    return {"program": {k: v["value"] for k, v in r["checks"].items()},
            "control": control, "wrong_window": fault}


def decode(spec, seed, seconds, device, traffic_overrides=None,
           config_overrides=None):
    from bench.drivers import decode as dec
    run = _run(spec, "glm4-decode", seed, seconds, device,
               traffic=traffic_overrides or {},
               config=config_overrides or {})
    program = dec.Cell(run)
    _window(run, program)
    program.release()
    picked = program.sample(seed, int(run.traffic["check_sequences"]))
    out = {"program": {"served_gap": max(dec.served_gaps(
               program, run, picked, "float32"))},
           "control": {"served_gap": max(dec.served_gaps(
               program, run, picked, "fp8"))},
           "sequences": len(picked)}
    del program
    return out


def train(spec, seed, seconds, device, traffic_overrides=None,
          config_overrides=None):
    from bench.drivers import train as tr
    run = _run(spec, "glm4-train", seed, 0.0, device,
               traffic=traffic_overrides or {},
               config=config_overrides or {})
    program = tr.Cell(run)
    program.release()
    ref = tr.reference_readings(program.arch, program.opt, seed,
                                program.batches, run.device)
    low = tr.reference_readings(program.arch, program.opt, seed,
                                program.batches, run.device, "fp8")
    control = type("Readings", (), {
        "losses": low["losses"], "grad_norms": low["grad_norms"],
        "change_norms": low["change_norms"]})
    return {"program": tr.readings(program, ref),
            "control": tr.readings(control, ref)}


CELLS = {"misrn-bulk": bulk, "mc-apps": mc, "glm4-decode": decode,
         "glm4-train": train}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, choices=sorted(CELLS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.with_held(harness.load_spec())
    for seed in args.seeds:
        out = CELLS[args.workload](spec, seed, args.seconds, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
