"""Readings that set the limits of ``correct`` in the MoE train cell: the
program's and two controls', at the cell's own size, in one process.

  python3 bench/controls_moe.py --seeds <n> [<n> ...]

Prints one JSON line a seed with the numbers ``granite-moe-train``
compares, for

  program   the program as the cell runs it;
  fp8       the reference with fp8 operands and activations, one precision
            below the bfloat16 the configuration states (``controls.py``'s
            glm4-train control);
  capacity  the program's own capacity routing (capacity factor 1.25 in
            groups of ``moe_group`` tokens), which drops the choices past
            an expert's capacity: the step that would tempt a later change.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from bench import harness  # noqa: E402
from bench.controls import _run  # noqa: E402

WORKLOAD = "granite-moe-train"
CAPACITY = 1.25


def _readings(cell, ref):
    from bench.drivers import train as tr
    return dict(tr.readings(cell, ref),
                dropped_choices=float(getattr(cell, "dropped", 0)))


def _program(spec, seed, device, traffic, config):
    from bench.drivers import moe_train as mt
    run = _run(spec, WORKLOAD, seed, 0.0, device, traffic=traffic,
               config=config)
    cell = mt.Cell(run)
    cell.release()
    return cell


def train(spec, seed, device, traffic_overrides=None, config_overrides=None):
    from bench.drivers import moe_train as mt
    traffic = traffic_overrides or {}
    config = dict(config_overrides or {})
    program = _program(spec, seed, device, traffic, config)
    args = (program.arch, program.opt, seed, program.batches,
            program.dev)
    ref = mt.reference_readings(*args)
    low = mt.reference_readings(*args, precision="fp8")
    fp8 = type("Readings", (), {
        "losses": low["losses"], "grad_norms": low["grad_norms"],
        "change_norms": low["change_norms"]})
    _, base, _ = harness.cell_files(spec, WORKLOAD)
    arch = dict(config.get("arch", base["arch"]), capacity_factor=CAPACITY)
    capacity = _program(spec, seed, device, traffic, dict(config, arch=arch))
    return {"program": _readings(program, ref), "fp8": _readings(fp8, ref),
            "capacity": _readings(capacity, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls_moe: needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for seed in args.seeds:
        out = train(spec, seed, "cuda")
        print(json.dumps({"workload": WORKLOAD, "seed": seed, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
