"""The benchmark's command: one run of one cell on this machine's card.

    python3 vobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
run's JSON result; the numbers compared with the reference, each beside
its limit, are the last lines of standard error. Without a CUDA card it
exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vobench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
