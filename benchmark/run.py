"""One run of one benchmark cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output;
exits 2 without a result when the card the cell needs is missing.
"""

import time

T_START = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this directory, heads the import path
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T_START))
