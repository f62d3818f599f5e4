"""`trace.summarize` and `device_spans.device_by_span` on a fake event
list: two requests, program ranges inside the first, kernels launched by
torch operations, one through ctypes, one with no launch call, one past
the stretch's end and one before its start; and the readers of the
program's ranges on it."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from gpubench import device_spans, harness, trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _event(eid, name, a, b, device=CPU, parent=None, note=False):
    return SimpleNamespace(
        id=eid, name=name, device_type=device,
        time_range=SimpleNamespace(start=a, end=b), cpu_parent=parent,
        is_user_annotation=note)


def _profile(program=True):
    """`program` False: a program without the input and set-up ranges.
    A device record shares its id with the runtime call that launched it;
    torch operations number theirs apart, so ids may clash."""
    req = _event(1, "bench/request", 0, 100)
    ext = _event(2, "bench/extract", 1, 60, parent=req)
    stitch = _event(3, "sliding/stitch", 10, 20, parent=ext)
    copy = _event(4, "aten::copy_", 11, 13, parent=stitch)
    stats = _event(5, "unet/norm_stats", 30, 40, parent=ext)
    total = _event(6, "aten::sum", 31, 33, parent=stats)
    mul = _event(7, "aten::mul", 70, 72, parent=req)
    events = [
        _event(106, "cudaLaunchKernel", -9, -8),
        req, ext, stitch, copy, stats, total, mul,
        _event(105, "aten::fill_", 16, 17, parent=stitch),
        _event(8, "bench/request", 120, 200),
        _event(101, "cudaMemcpyAsync", 11.5, 12, parent=copy),
        _event(102, "cuLaunchKernel", 15, 15.5),  # through ctypes
        _event(103, "cudaLaunchKernel", 31.5, 32, parent=total),
        _event(104, "cudaLaunchKernel", 70.5, 71, parent=mul),
        _event(107, "cudaLaunchKernel", 150, 151),
        _event(106, "fill_kernel", -4, -2, CUDA),
        _event(101, "copy_kernel", 14, 18, CUDA),
        _event(102, "blend_scatter_kernel", 19, 25, CUDA),
        _event(3, "sliding/stitch", 14, 25, CUDA, note=True),
        _event(103, "reduce_kernel", 34, 50, CUDA),
        _event(104, "mul_kernel", 73, 80, CUDA),
        _event(105, "stray_kernel", 85, 90, CUDA),  # no launch call
        _event(107, "late_kernel", 195, 210, CUDA),
    ]
    if program:
        events += [_event(18, "extract/input", 2, 8, parent=ext),
                   _event(19, "sliding/setup", 8.5, 9.5, parent=ext)]
    return SimpleNamespace(events=lambda: events)


def test_summary_fields():
    t = trace.summarize(_profile())
    assert t.busy_s == pytest.approx(43e-6)
    assert t.window_s == pytest.approx(200e-6)
    assert t.requests == 2
    assert [n for n, _ in t.device_ops] == [
        "reduce_kernel", "mul_kernel", "blend_scatter_kernel",
        "stray_kernel", "late_kernel", "copy_kernel"]
    assert [v for _, v in t.device_ops] == pytest.approx(
        [16e-6, 7e-6, 6e-6, 5e-6, 5e-6, 4e-6])
    assert dict(t.idle_gaps) == pytest.approx({
        "bench/request": 133e-6, "extract/input": 14e-6,
        "bench/extract": 9e-6, "sliding/stitch": 1e-6})
    assert t.ranges_s == pytest.approx({
        "bench/request": 180e-6, "bench/extract": 59e-6,
        "extract/input": 6e-6, "sliding/setup": 1e-6,
        "sliding/stitch": 10e-6, "unet/norm_stats": 10e-6})


def test_device_time_by_launching_range():
    by_span = device_spans.device_by_span(_profile())
    assert by_span == pytest.approx({
        "sliding/stitch": 10e-6,  # a torch copy and a ctypes launch
        "unet/norm_stats": 16e-6,
        "bench/request": 12e-6,  # the last clipped at the stretch's end
        device_spans.OUTSIDE: 5e-6,  # no launch call in the trace
    })
    assert sum(by_span.values()) == pytest.approx(
        trace.summarize(_profile()).busy_s)
    with pytest.raises(RuntimeError):
        device_spans.device_by_span(_profile(), span="bench/none")


@pytest.mark.parametrize("metric, ms", [
    ("input_host_ms.full", 3e-3), ("input_host_ms.sliding", 3e-3),
    ("stitch_setup_ms.sliding", 5e-4)])
def test_program_range_readers(metric, ms):
    def read(program):
        rec = harness.Record(setup_s=0.0,
                             trace=trace.summarize(_profile(program)))
        return harness.metric_reader(metric)(rec)

    assert read(True) == pytest.approx(ms)  # host ms per traced request
    assert read(False) is None  # left out of the result line
