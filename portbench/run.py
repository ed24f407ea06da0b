#!/usr/bin/env python3
"""The benchmark of ``mygramdb_tpu_torch``, one cell a run:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is the result's JSON object;
the last lines of standard error the numbers compared, each beside its
limit. See ``portbench/README.md``.
"""

import os
import sys
import time

# set-up is counted from the first start of this file
T_START = float(os.environ.get("PORTBENCH_T_START", time.monotonic()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    # One hash seed for every run: the order of the program's sets and
    # dicts of strings, and so its work, is then the same in every process.
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0",
                   PORTBENCH_T_START=repr(T_START))
        os.execve(sys.executable, [sys.executable] + sys.argv, env)
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
