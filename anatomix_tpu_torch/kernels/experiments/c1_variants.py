"""Time the variants of the channel-less space-to-depth (L-c1) in
`c1_variants.cu` against each other and against torch's
`view().permute().contiguous()`, on one card.

    python anatomix_tpu_torch/kernels/experiments/c1_variants.py

Builds the source with nvcc into a temporary directory, checks every
variant bit for bit against the permute, and prints each one's device time
at B2 128^3 and B1 256^3 in f32 and bf16: warm (a loop of 400 launches
between two CUDA events, the input resident in the 50 MB L2 where it fits)
and from DRAM (the L2 emptied by a 256 MiB write before each launch, one
launch between two events, the median of 50).
"""

import ctypes
import os
import statistics
import subprocess
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
NAMES = {0: "one voxel a thread (before)",
         1: "16-byte row runs, hints",
         2: "16-byte row runs",
         3: "one thread a 16-byte output run",
         4: "the same, hints",
         5: "shared-memory staged",
         6: "one thread a 16-byte output run, row in the grid (shipped)"}


def build(tmp: str):
    so = os.path.join(tmp, "libc1variants.so")
    subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
         os.path.join(HERE, "c1_variants.cu")], check=True)
    fn = ctypes.CDLL(so).c1_variant
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def warm_ms(f, reps: int = 400) -> float:
    f()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        f()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def cold_ms(f, flush, reps: int = 50) -> float:
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        f()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("c1_variants: no card")
        return 2
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    print(torch.cuda.get_device_name(0))
    with tempfile.TemporaryDirectory() as tmp:
        fn = build(tmp)
        for dtype in (torch.float32, torch.bfloat16):
            for B, S in ((2, 128), (1, 256)):
                x = torch.randn((B, S, S, S), device=dev).to(dtype)
                h = S // 2

                def perm():
                    return x.view(B, h, 2, h, 2, h, 2).permute(
                        0, 1, 3, 5, 2, 4, 6).contiguous()

                ref = perm().view(B, h, h, h, 8)
                out = torch.empty_like(ref)
                st = torch.cuda.current_stream().cuda_stream
                print(f"{dtype} B{B} {S}^3, bound "
                      f"{2 * x.numel() * x.element_size() / 3.35e9:.4f} ms: "
                      f"permute warm {warm_ms(perm):.4f} cold "
                      f"{cold_ms(perm, flush):.4f}", flush=True)
                for v, name in NAMES.items():
                    def call(v=v):
                        return fn(v, x.data_ptr(), out.data_ptr(), B, h, h,
                                  h, x.element_size(), st)
                    out.zero_()
                    rc = call()
                    torch.cuda.synchronize()
                    ok = rc == 0 and torch.equal(out, ref)
                    print(f"  {v} {name:58s} exact={ok} warm "
                          f"{warm_ms(call):.4f} cold "
                          f"{cold_ms(call, flush):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
