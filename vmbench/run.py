"""Run one cell of the benchmark and print its result line.

    python3 vmbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Needs a CUDA device; prints each compared
number beside its limit on standard error, and the result as the last
line of standard output.
"""

import time

T_START = time.perf_counter()

import sys                                               # noqa: E402
from pathlib import Path                                 # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout root (for ``vmbench``) and ``src`` (for the program), in
# place of this folder, whose module names would shadow others
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from vmbench.harness import main                         # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
