"""The card's published peaks, the roofline bound, and a cold-cache timer.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 989 TFLOP/s bfloat16 on the tensor cores, 3.35 TB/s of HBM3.

`bound_seconds` is the bound arithmetic of the port's kernel table (PERF.md
Table B, `bound_ms`): the larger of operations over the peak rate and bytes
over the memory bandwidth. `cold_ms` is copied from the port's on-chip
smoke script (`chip_smoke.py`, `cold_ms`): a kernel timed alone from DRAM,
with the L2 cache emptied before each launch; no metric reads it yet, it
is the timer a per-kernel metric of a later benchmark change starts from.
"""

from __future__ import annotations

import statistics

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(ops: float, byts: float) -> float:
    """The least time for `ops` operations and `byts` bytes moved."""
    return max(ops / BF16_FLOPS, byts / HBM_BYTES_PER_S)


def cold_ms(fn, *, reps: int = 50) -> float:
    """Median device ms of one `fn()` from CUDA events, with the L2 cache
    emptied before each (a 256 MiB write): the time of a kernel whose input
    comes from DRAM. The write runs ahead on the stream, so the host's
    set-up of the call hides behind it."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
