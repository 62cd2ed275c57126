#!/usr/bin/env python3
"""One of chip_smoke's model paths alone, after the kernel build, on a
card: its readings without the rest of the smoke run (inside the whole
run, host-bound decode steps run 1.1-1.9x slower).

``--path families`` (the default) runs ``chip_smoke.phase_families_path``:
kernel A at the path's draw shapes and kernel F at each config's
vocabulary against the plain versions, each config at smoke width on the
card against the CPU, olmoe-1b-7b, granite-moe-3b-a800m, mamba2-2.7b,
zamba2-7b and whisper-small served unmodified through ``launch.serve``
(timings, peak memory, dropped MoE choices), decode against forward at 2
layers of each published width, a profile of olmoe and mamba2 decode
steps and the serve CLI on mamba2.

``--path large`` runs ``chip_smoke.phase_large_path``: the same for
glm4-9b (unmodified), qwen1.5-32b, granite-34b and qwen2-vl-72b (published
widths, cut in depth to ``chip_smoke.LARGE_LAYERS``; the vlm with a
1152-token prompt over its 1024 patches), the float8 KV cast against the
CPU, and profiles of qwen1.5-32b and qwen2-vl-72b decode steps; each
serve prints its peak minus the dry run's argument bytes at its shape.

Prints the card's name and power limit first.  Exits non-zero when a check
fails or there is no card.

    python3 tools/families_path.py [--path families|large]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("families", "large"),
                    default="families")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("families_path: no CUDA device is available", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}")
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    device = torch.device("cuda")
    t0 = time.perf_counter()
    try:
        cs.run_phase("build", cs.phase_build)
        phase = (cs.phase_families_path if args.path == "families"
                 else cs.phase_large_path)
        launches = cs.run_phase(f"{args.path} path", phase, device, {})
    except cs.SmokeFailure as e:
        print(f"families_path: FAILED: {e}", file=sys.stderr)
        return 1
    cs.log(f"launches {launches}")
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
