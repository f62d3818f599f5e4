"""Local multi-device runs: one process per device, started from Python.

The torch form of the JAX package's single-process multi-device runs (one
process over `jax.devices()`): `spawn(fn, world, device, *args)` starts
`world` ranks with `torch.multiprocessing`'s spawn method, joins them into
one process group on a free localhost port (NCCL with rank r on `cuda:r`
for `device="cuda"`, gloo for `"cpu"`) and calls `fn(rank, world, device,
*args)` in each. It returns the ranks' results in rank order. A rank that
raises ends the run: the other ranks are stopped and the caller gets a
`RuntimeError` holding the failing rank's traceback. A run has no
deadline of its own, since a training run takes hours; a collective that
waits for a rank longer than the process group's timeout
(`multihost.COLLECTIVE_TIMEOUT` unless asked) fails its rank, and that
ends the run.

`fn` and its arguments are pickled by import path, so `fn` must be a
module-level function, and its result a picklable value (numbers, numpy
arrays, CPU tensors). The ranks start from a fresh interpreter, so they
import only what `fn`'s module imports.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from anatomix_tpu_torch.parallel.multihost import COLLECTIVE_TIMEOUT


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_local_group(rank: int, world: int, device: str, port: int,
                     group_timeout: datetime.timedelta = COLLECTIVE_TIMEOUT
                     ) -> torch.device:
    """Join rank `rank` of a `world`-rank group on localhost:`port`, whose
    collectives fail after waiting `group_timeout`; returns this rank's
    device (`cuda:rank` after binding to it, or the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() <= rank:
            raise RuntimeError(f"rank {rank} needs card {rank}, but "
                               f"{torch.cuda.device_count()} are visible")
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        timeout=group_timeout)
    return dev


def _rank_main(rank, fn, world, device, port, results, group_timeout, args):
    try:
        dev = init_local_group(rank, world, device, port, group_timeout)
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        # by value (tensors too), not through shared memory that would
        # outlive this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, then the rank exits
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, device: str, *args,
          group_timeout: datetime.timedelta = COLLECTIVE_TIMEOUT) -> list:
    """Run `fn(rank, world, device_of_rank, *args)` on `world` local ranks
    of a process group whose collectives fail after waiting
    `group_timeout`, and return their results in rank order; raise
    `RuntimeError` with the traceback of the first rank that fails, or if
    a rank stops without reporting. The run itself may take any time."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if torch.device(device).type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, world, device, port, results,
                               group_timeout, args),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    silent_since: dict[int, float] = {}
    try:
        while len(got) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                now = time.monotonic()
                # a rank that stopped without a report (killed, crashed in
                # native code): give its queue a few seconds to drain
                for r, p in enumerate(procs):
                    if r not in got and not p.is_alive():
                        silent_since.setdefault(r, now)
                dead = [r for r, t in silent_since.items()
                        if r not in got and now - t > 5.0]
                if dead:
                    raise RuntimeError(
                        f"spawn: ranks {dead} of {world} stopped without a "
                        f"report (exit codes "
                        f"{[p.exitcode for p in procs]})") from None
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} of {world} failed:\n"
                                   f"{payload}")
            got[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            if len(got) < world and p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
