"""Build the port's CUDA kernels and load them with ctypes.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface. Pointers and the stream pass as
`ctypes.c_void_p` from `data_ptr()` and
`torch.cuda.current_stream().cuda_stream`. Libraries are built at first use,
or all at once by `build_all()` (one `nvcc` per source, started together),
into `kernels/_build/<name>-<hash>/`, where the hash covers the source and
the flags. Nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("conv3d", "blend_scatter", "norm_apply", "upsample",
           "flash_attention", "depth_to_space8", "conv3d_wgrad", "reshuffle")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
)

_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}
# compiler output of the builds this process ran (ptxas registers, spills)
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared by several sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_all(names=SOURCES) -> None:
    """Compile every library of `names` not yet built, all in parallel."""
    with _lock:
        todo = [n for n in names if not _lib_path(n).exists()]
        if not todo:
            return
        nvcc = nvcc_path()
        procs = []
        for name in todo:
            path = _lib_path(name)
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for name, path, tmp, proc in procs:
            log, _ = proc.communicate()
            build_logs[name] = log
            (path.parent / "build.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
