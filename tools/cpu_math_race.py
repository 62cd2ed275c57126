"""First-call race of the CPU's vector math, counted over fresh processes.

ATen's float ``exp`` / ``log`` / ``sqrt`` / ``sin`` / ``cos`` on the CPU
call MKL's vector math (VML).  Each probe is a fresh process that sets
32 intra-op threads, runs one prelude, then computes ``torch.exp`` over
2^18 floats twice and prints how many elements differ between the two
calls.  Preludes:

- ``none``: nothing, so the first ``exp`` is the process's first VML
  call and is split over the threads;
- ``import``: ``import repro_torch`` (the package settles VML at import);
- ``tiny_exp`` / ``tiny_log``: one VML call of 64 elements on one thread;
- ``tiny_add``: one non-VML op of 64 elements (a control).

    PYTHONPATH=src python tools/cpu_math_race.py [--probes 80] [--parallel 4]

The fault is a race, so its rate depends on the machine's load; run the
preludes interleaved, as this script does, to compare them.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

PRELUDES = {
    "none": "",
    "import": "import repro_torch\n",
    "tiny_exp": "torch.exp(torch.ones(64))\n",
    "tiny_log": "torch.log(torch.ones(64))\n",
    "tiny_add": "torch.ones(64) + 1\n",
}


def probe_code(prelude: str, threads: int = 32, n: int = 1 << 18) -> str:
    """A program that prints the count of elements in which the first two
    ``torch.exp`` calls of the process differ, after ``prelude``."""
    return ("import torch\n"
            f"torch.set_num_threads({threads})\n"
            f"{prelude}"
            f"u = torch.linspace(-3.0, 3.0, {n})\n"
            "a, b = torch.exp(u), torch.exp(u)\n"
            "print(int((a.view(torch.int32) != b.view(torch.int32)).sum()))\n")


def run_probe(prelude: str, timeout: float = 120.0) -> int:
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", probe_code(prelude)], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         check=True)
    return int(out.stdout.strip())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probes", type=int, default=80,
                    help="fresh processes per prelude")
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--preludes", default=",".join(PRELUDES))
    args = ap.parse_args()
    names = args.preludes.split(",")
    jobs = [name for _ in range(args.probes) for name in names]
    with ThreadPoolExecutor(args.parallel) as pool:
        counts = list(pool.map(lambda name: run_probe(PRELUDES[name]), jobs))
    for name in names:
        mine = [c for j, c in zip(jobs, counts) if j == name]
        faulty = [c for c in mine if c]
        print(f"{name}: {len(faulty)} of {len(mine)} processes differ"
              f" (elements differing: {sorted(faulty)})")


if __name__ == "__main__":
    main()
