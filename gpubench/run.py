"""Run one cell of the benchmark:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with the CUDA devices the cell
asks for. Prints the result as the last line of standard output."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The repository's root in place of this script's folder, whose module
# names (trace, check, ...) would shadow the standard library's.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from gpubench import guard  # noqa: E402

guard.watch_opens()

if __name__ == '__main__':
    from gpubench import core
    sys.exit(core.main(sys.argv[1:], T_START))
