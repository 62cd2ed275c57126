#!/usr/bin/env python3
"""One of chip_smoke's train paths alone, after the kernel build, on a
card: its readings without the rest of the smoke run.

``--path gemma`` (the default) runs ``chip_smoke.phase_train_path``
(about 4 minutes of call): AdamW card against CPU, kernel A at the path's
draw shapes, the smoke width on card, CPU and CLI, gemma-7b over 8 of 28
layers through ``make_train_step`` (digests, timings, profile) and over
1 layer through ``train`` (resume, service, remat, checkpoints of up to
~25 GB at once).

``--path families`` runs ``chip_smoke.phase_train_families_path``:
kernel A at the path's new draw shapes, ``train`` at the smoke width on
the card against the CPU for nine configs (fail@3 resume and
``--no-service`` on the card for five), the train CLI on mamba2, and
olmoe-1b-7b, mamba2-2.7b, zamba2-7b, whisper-small and qwen2-vl-72b at
published width cut to ``chip_smoke.TRAIN_FAMILY_LAYERS`` through
``make_train_step`` (digests, step 0 checks, timings, peaks, profiles of
olmoe and mamba2).

``--path large`` runs ``chip_smoke.phase_train_large_path``: kernel A at
the chunks of the largest stacked matrices at the depths trained, fail@3
resume and ``--no-service`` at the smoke width on the card, and
granite-moe-3b-a800m, glm4-9b, qwen1.5-32b and granite-34b at published
width cut to ``chip_smoke.TRAIN_LARGE_LAYERS`` through
``make_train_step`` (digests, step 0 checks, timings, peaks, profiles of
granite-moe and qwen1.5-32b).

Prints the card's name and power limit and the free disk under the
checkout first.  Exits non-zero when a check fails or there is no card.

    python3 tools/train_path.py [--path gemma|families|large]
"""
from __future__ import annotations

import argparse
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("gemma", "families", "large"),
                    default="gemma")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("train_path: no CUDA device is available", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}")
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    du = shutil.disk_usage(ROOT)
    cs.log(f"disk at {ROOT}: {du.free / 1e9:.1f} GB free of "
           f"{du.total / 1e9:.1f}")
    t0 = time.perf_counter()
    try:
        cs.run_phase("build", cs.phase_build)
        phase = {"gemma": cs.phase_train_path,
                 "families": cs.phase_train_families_path,
                 "large": cs.phase_train_large_path}[args.path]
        launches = cs.run_phase(f"{args.path} path", phase,
                                torch.device("cuda"), {})
    except cs.SmokeFailure as e:
        print(f"train_path: FAILED: {e}", file=sys.stderr)
        return 1
    cs.log(f"launches {launches}")
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
