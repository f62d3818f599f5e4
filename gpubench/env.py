"""The process environment of a benchmark run, set before torch is imported:
every build and kernel cache in a fixed folder inside the checkout, and no
JAX or Flax pulled in by a library."""

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".gpubench_cache"


def setup() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
