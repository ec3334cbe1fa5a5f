"""Run one benchmark cell and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout that holds the port (``ndt_2d_tpu_torch``)
on a machine with the CUDA devices the cell asks for; exits with a code
other than 0, and prints no result, where either is missing.
"""

import os
import sys
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build caches at fixed paths inside the checkout, so that only a cell's
# first run in a checkout builds.
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(0, ROOT)
# Load from one process with few threads: the port's host work is small
# arrays, where a pool of worker threads only adds jitter.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# ... on two fixed cores of those the process may use, so that the
# scheduler does not move it between runs' different cores.
CPUS = sorted(os.sched_getaffinity(0))
os.sched_setaffinity(0, CPUS[-2:])

from portbench import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(started=STARTED))
