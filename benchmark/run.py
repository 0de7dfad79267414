"""Run one cell of the port's benchmark; see benchmark/core/harness.py.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T0 = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout, not benchmark/ itself, is where `benchmark` is imported
# from: its folder names must not stand in for other top-level modules
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]

if __name__ == "__main__":
    from benchmark.core import harness

    sys.exit(harness.main(sys.argv[1:], t0=T0))
