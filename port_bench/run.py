"""The port's benchmark: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (see ``harness.py``).
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
