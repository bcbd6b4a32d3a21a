"""Run one cell of BENCHMARK.json on this machine's CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1
its per-layer metrics), `device`, with --trace 1 `breakdown`, and last
`checks`, the numbers compared with their limits (also the last lines
on standard error). Exits non-zero and prints no result when the
machine has fewer CUDA devices than the cell asks for, when the program
is not beside the benchmark, or when JAX or the JAX package is loaded.
"""
import os
import sys
import time

T_PROCESS = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # the checkout's root in place of this folder: the harness's modules
    # are imported as the package `portbench`, never by bare names
    sys.path[0] = ROOT
    from portbench import harness
    harness.cache_dirs(ROOT)
    sys.exit(harness.run(sys.argv[1:], T_PROCESS))
