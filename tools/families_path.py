#!/usr/bin/env python3
"""chip_smoke's kernel build and families path alone, on a card: the
readings of the moe, ssm, hybrid and encdec families at full width without
the rest of the smoke run.

Prints the card's name and power limit, then each phase of
``chip_smoke.phase_families_path`` - kernel A at the path's draw shapes
and kernel F at each config's vocabulary against the plain versions, each
config at smoke width on the card against the CPU, olmoe-1b-7b,
granite-moe-3b-a800m, mamba2-2.7b, zamba2-7b and whisper-small served
unmodified through ``launch.serve`` (timings, peak memory, dropped MoE
choices), decode against forward at 2 layers of each published width, a
profile of olmoe and mamba2 decode steps and the serve CLI on mamba2.
Exits non-zero when a check fails or there is no card.

    python3 tools/families_path.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("families_path: no CUDA device is available", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}")
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    try:
        cs.run_phase("build", cs.phase_build)
        launches = cs.run_phase("families path", cs.phase_families_path,
                                torch.device("cuda"), {})
    except cs.SmokeFailure as e:
        print(f"families_path: FAILED: {e}", file=sys.stderr)
        return 1
    cs.log(f"launches {launches}")
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
