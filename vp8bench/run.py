#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on a CUDA card.

    python3 vp8bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the set-up's parts on an earlier line
and one JSON result as the last line of standard output; each number the
check compares, beside its limit, as the last lines of standard error.
Exits 2 without a result when there is no card, the cell is unknown or a
banned module (JAX, the JAX package) was loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# Load from one process with few threads: the host's cores go to the
# program's own threads (the decoder's entropy thread and dispatch worker,
# the encoder's host pack), not to idle math-library pools. Set before
# torch or numpy is imported.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vp8bench.harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], T0))
