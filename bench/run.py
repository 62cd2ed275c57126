"""Run one cell of the benchmark once.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  The kernels build into ``build/`` of the checkout on the first run;
every later run loads them from there.
"""
import os
import sys
import time

T_START = time.time()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=min(T_START, harness.process_start())))
