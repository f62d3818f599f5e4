"""Read a cell's compared numbers on many seeds in one process.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 2 [--control]

Each seed runs the cell as `run.py` does (set-up, a window of `--seconds`,
the check) and prints one line: the seed, each compared number with its
limit, and `correct`. With `--control` the reference in the precision
below the configuration's serves the requests. The limits of
`limits/<cell>.json` are set from these readings: the program's over a
dozen seeds or more, and the control's. Not run by the benchmark itself.
One process serves every seed, since each run of `run.py` is a process of
its own and pays the interpreter, torch, the CUDA context and the kernels'
loading again (some 15 s on the card) before its own set-up.
"""

import sys
import time
from pathlib import Path

# the checkout's root, not this folder, is where imports start
sys.path[0] = str(Path(__file__).resolve().parents[1])

from gpubench import env  # noqa: E402

env.setup()


def main(argv) -> int:
    import argparse
    import json

    import torch

    from gpubench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = harness.run_cell(
            bench, args.workload, seed, args.seconds, False,
            t_start=time.perf_counter(), control=args.control)
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"],
                          "metrics": result["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
