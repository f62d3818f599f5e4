"""The benchmark's run: set-up, the measured window, the check, the result.

`run.py` is the command; this module does the work. A cell of
`BENCHMARK.json` names a configuration (`configs/<config>.json`) and a
traffic mix (`traffic/<traffic>.json`); the mix names its driver
(`drivers/<driver>.py`), which makes the inputs and weights from the seed,
drives the program one request at a time and checks its answers against
the plain reference (`reference/`) with the cell's limits
(`limits/<cell>.json`). Each metric of the cell is read by
`metrics/<metric>.py`, or by the file of the name before its first dot. A later cell, mix, configuration or metric is a new
file and a new entry; nothing here names one.

The window is a closed loop with one client: the next request starts when
the last one has completed (a driver's request ends in a device
synchronize). It ends with the first request that completes after
`seconds` have passed; a rate is the requests completed over the time from
the window's start to that completion.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import random
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "anatomix_tpu")


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


@dataclass
class Record:
    """What a run measured, for the metric readers."""

    setup_s: float
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    failed: int = 0
    spans_s: dict = field(default_factory=dict)
    ops_per_request: float = 0.0
    least_s_per_request: float = 0.0
    trace: object = None  # trace.TraceSummary of a traced stretch

    @property
    def completed(self) -> int:
        return len(self.latencies_s) - self.failed


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: with `trace` its per-layer metrics,
    else its end-to-end ones. A metric without a `workloads` list applies
    to every cell (a per-layer one: every cell that reports what it
    moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def metric_reader(name: str):
    """`metrics/<name>.py`, else the reader of the quantity that `name`
    splits by path (`metrics/<name up to its first dot>.py`): the
    `device_idle_pct.full` of one path and the `.sliding` of another are
    read alike."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(name: str):
    return importlib.import_module(f"gpubench.drivers.{name}").Driver


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True).stdout
        limit = float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device),
            "power_limit_w": limit}


def measure(driver, seconds: float, trace: dict | None, rec: Record):
    """The window. It runs on until the driver's `min_requests` are done
    (the answers its check keeps). With `trace` ({"from": i, "requests":
    n}) the profiler records requests i .. i + n - 1, and the window runs
    on until they are done too."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpubench import trace as tr

    prof = None
    i = 0
    t_start = time.perf_counter()
    while True:
        if trace and i == trace["from"]:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        t0 = time.perf_counter()
        try:
            with record_function("bench/request"):
                driver.request(i)
        except Exception:  # a request that fails is counted, not fatal
            rec.failed += 1
            if rec.failed == 1:
                traceback.print_exc()
        t1 = time.perf_counter()
        rec.latencies_s.append(t1 - t0)
        i += 1
        if prof is not None and i == trace["from"] + trace["requests"]:
            prof.stop()
            traced, prof = prof, None
        if t1 - t_start >= seconds and i >= driver.min_requests and (
                not trace or i >= trace["from"] + trace["requests"]):
            break
    rec.window_s = t1 - t_start
    if trace:
        rec.trace = tr.summarize(traced)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device: str = "cuda",
             control: bool = False, config=None, traffic=None, limits=None):
    """One run of a cell; returns (result dict, checks). `config`,
    `traffic` and `limits` default to the cell's files; tests pass small
    ones and `device='cpu'`."""
    import torch

    cell = find_cell(bench, cell_name)
    config = config or load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = traffic or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = limits or load_json(HERE / "limits" / f"{cell_name}.json")
    dev = torch.device(device)
    torch.manual_seed(seed % (2 ** 63))
    t_driver = time.perf_counter()
    driver = load_driver(traffic["driver"])(
        config, traffic, seed, dev, control=control)
    t_warm = time.perf_counter()
    driver.warm(trace)
    rec = Record(setup_s=time.perf_counter() - t_start)
    print(f"set-up {rec.setup_s:.3f} s: driver {t_warm - t_driver:.3f} s, "
          f"warm-up {time.perf_counter() - t_warm:.3f} s", file=sys.stderr)
    rec.ops_per_request, rec.least_s_per_request = driver.counts()
    plan = None
    if trace:
        plan = {"from": traffic.get("trace_from", 1),
                "requests": traffic["trace_requests"]}
    measure(driver, seconds, plan, rec)
    rec.spans_s = driver.spans
    lat = sorted(rec.latencies_s)
    spans = ", ".join(f"{k} mean {1e3 * sum(v) / len(v):.3f} ms"
                      for k, v in rec.spans_s.items() if v)
    print(f"window {rec.window_s:.3f} s: {len(lat)} requests, latency "
          f"median {1e3 * lat[len(lat) // 2]:.3f} ms, min "
          f"{1e3 * lat[0]:.3f} ms, max {1e3 * lat[-1]:.3f} ms; {spans}",
          file=sys.stderr)
    dinfo = device_info(dev)
    t_check = time.perf_counter()
    checks = [Check(n, float(v), float(limits[n]))
              for n, v in driver.finish().items()]
    print(f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        v = metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace and rec.trace is not None:
        dinfo["busy_s"] = rec.trace.busy_s
        dinfo["window_s"] = rec.trace.window_s
    result = {
        "correct": rec.failed == 0 and all(c.ok for c in checks),
        "attempted": len(rec.latencies_s),
        "failed": rec.failed,
        "metrics": metrics,
        "device": dinfo,
    }
    if trace and rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


def sample_index(seed: int, within: int) -> int:
    """The request, drawn from the seed, whose answer is kept for the
    check beside the window's last one."""
    return random.Random(seed).randrange(within)


def main(argv, t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="put the reference, in the precision below the "
                        "configuration's, in the program's place")
    args = p.parse_args(argv)

    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} devices; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=t_start,
                              control=args.control)
    return emit(result, checks)


def emit(result: dict, checks) -> int:
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output; 3, and no result, if a
    module of JAX or the JAX package is loaded by now (whatever loaded it:
    the program, a driver or a metric reader)."""
    bad = forbidden_modules()
    if bad:
        print("modules of JAX or the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
