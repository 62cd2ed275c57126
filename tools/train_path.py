#!/usr/bin/env python3
"""chip_smoke's kernel build and train path alone, on a card: the
readings of the training substrate at full width without the rest of the
smoke run (about 4 minutes in place of 10).

Prints the card's name and power limit, the free disk under the checkout
(the path's checkpoints take up to 32 GB at once), then each phase of
``chip_smoke.phase_train_path`` - AdamW card against CPU, kernel A at the
path's draw shapes, the smoke width on card, CPU and CLI, gemma-7b over 8
of 28 layers through ``make_train_step`` (digests, timings, profile) and
over 2 layers through ``train`` (resume, service, remat, checkpoints).
Exits non-zero when a check fails or there is no card.

    python3 tools/train_path.py
"""
from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
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
        cs.run_phase("train path", cs.phase_train_path,
                     torch.device("cuda"))
    except cs.SmokeFailure as e:
        print(f"train_path: FAILED: {e}", file=sys.stderr)
        return 1
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
