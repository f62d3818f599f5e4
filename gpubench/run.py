"""The benchmark of `anatomix_tpu_torch` on one NVIDIA H100.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` (at the root of the checkout) and prints
its result as one JSON object on the last line of standard output, and the
numbers its check compared, each beside its limit, as the last lines of
standard error. It needs a CUDA device and exits with another code than 0
without one. Build and kernel caches stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this folder, is where imports start
sys.path[0] = str(Path(__file__).resolve().parents[1])

from gpubench import env  # noqa: E402

env.setup()

from gpubench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
