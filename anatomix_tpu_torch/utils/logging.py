"""Scalar logging: JSONL always, TensorBoard when `torch.utils.tensorboard`
imports (the port's copy of `anatomix_tpu/utils/logging.py`; the writer is
imported when a logger is made, never at module import)."""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class ScalarLogger:
    def __init__(self, log_dir: str, purge_step: int | None = None):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl_path = os.path.join(log_dir, "scalars.jsonl")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir, purge_step=purge_step)
        except ImportError:
            pass

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), int(step))
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_text(self, message: str) -> None:
        with open(os.path.join(self.log_dir, "loss_log.txt"), "a") as f:
            f.write(message + "\n")
        print(message)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
