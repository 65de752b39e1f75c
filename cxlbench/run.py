"""Run one cell of the port's benchmark once, on the card.

    python3 cxlbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line (the last of standard
output) and, last on standard error, each number the check compared beside
its limit.  Exits non-zero, printing no result, without a CUDA card (or
fewer than the cell asks for), without the port under ``src/``, for an
unknown name, or when JAX or the JAX package was loaded."""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cxlbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
