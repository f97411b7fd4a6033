"""Run one cell of the port's benchmark once.

    python3 jetbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout holding ``src/repro_torch``, on a machine with
as many CUDA devices as the cell asks for.  See ``jetbench/README.md``.
"""

import os
import sys
import time

STARTED = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root (this package) and its src/ (the program), not this
# directory, on the module path
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
        os.path.abspath(__file__))]

if __name__ == "__main__":
    from jetbench.harness import main

    sys.exit(main(sys.argv[1:], STARTED))
