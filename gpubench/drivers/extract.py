"""Feature extraction: each request hands the program one whole volume.

Set-up makes the configuration's weights and a pool of seeded structured
volumes (min-max normalised host arrays, as the extraction CLI hands them
on) and builds the program's extractor,
`anatomix_tpu_torch.extract.make_feature_extractor`, with the mix's
strategy and window settings. Request `i` passes pool volume `i mod pool`
to the extractor (the host-to-device copy is part of it) and waits for the
device; the features stay on the device, as the registration and
segmentation callers keep them.

The check keeps the answer of the request drawn from the seed among the
first `check_within` (a count the window always reaches) and, unless the
mix sets `check_last` false, the window's last. After the window, with the
program freed, the plain reference (`reference/unet.py`, and
`reference/sliding.py` for `sliding`) computes each of their volumes again
in float32, and the driver reports the worst `mean_err` (mean |program -
reference| over the reference's standard deviation) and `max_err` (max
|program - reference| over max |reference|).

With `control`, the reference itself serves the requests, its conv
operands rounded to the precision below the configuration's
(`CONTROL_DTYPE`): the check has to find it wrong.
"""

from __future__ import annotations

import gc
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from gpubench import harness, synth, work
from gpubench.reference import sliding as ref_sliding
from gpubench.reference import unet as ref_unet
from gpubench.reference.sliding import window_starts

CONTROL_DTYPE = {"bfloat16": torch.float8_e4m3fn, "float32": torch.bfloat16}


def resolve_strategy(unet: dict, strategy: str) -> str:
    """`auto` as the extraction API documents it: `full` for batch norm or
    none, else `sliding`."""
    if strategy != "auto":
        return strategy
    return "full" if unet.get("norm", "batch") in ("batch", "none") else (
        "sliding")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, *, control: bool = False):
        self.device = device
        self.unet = config["unet"]
        self.traffic = traffic
        self.strategy = resolve_strategy(self.unet, traffic["strategy"])
        self.roi = tuple(traffic.get("roi", (128, 128, 128)))
        self.size = tuple(traffic["size"])
        self.sd = synth.unet_weights(ref_unet.parameter_shapes(self.unet),
                                     self.unet.get("norm", "batch"), seed,
                                     device)
        self.pool = [synth.structured_volume(self.size, seed, k, device)
                     for k in range(traffic["pool"])]
        self.keep = harness.sample_index(seed, traffic["check_within"])
        self.min_requests = self.keep + 1
        self.kept: dict[str, tuple[int, torch.Tensor]] = {}
        self.spans: dict[str, list[float]] = {"enqueue": []}
        t0 = time.perf_counter()
        if control:
            dtype = CONTROL_DTYPE[config["dtype"]]
            self.extract = lambda v: self.reference(v, dtype)
        else:
            self.extract = self._program()
        print(f"set-up of the program {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)

    def _program(self):
        from anatomix_tpu_torch.extract import make_feature_extractor
        from anatomix_tpu_torch.models.unet import UnetConfig, build_plan

        t = self.traffic
        plan = build_plan(UnetConfig(**self.unet))
        return make_feature_extractor(
            plan, self.sd, strategy=t["strategy"], roi_size=self.roi,
            sw_batch_size=t.get("sw_batch_size", 2),
            overlap=t.get("overlap", 0.8), mode="gaussian",
            sigma_scale=t.get("sigma_scale", 0.25), device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, trace: bool):
        """Every shape the window uses: one request, twice (the second
        finds the allocator's blocks); with `trace`, the profiler once."""
        for i in range(2):
            self.extract(self.pool[i % len(self.pool)])
            self._sync()
        if trace:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                torch.ones(1, device=self.device).add_(1)
                self._sync()

    def request(self, i: int):
        k = i % len(self.pool)
        with record_function("bench/extract"):
            t0 = time.perf_counter()
            y = self.extract(self.pool[k])
            self.spans["enqueue"].append(time.perf_counter() - t0)
        with record_function("bench/sync"):
            self._sync()
        if i == self.keep:
            self.kept["sampled"] = (k, y)
        if self.traffic.get("check_last", True):
            self.kept["last"] = (k, y)

    def counts(self) -> tuple[float, float]:
        n = 1
        for s, r in zip(self.size, self.roi):
            n *= len(window_starts(max(s, r), r, self.traffic.get(
                "overlap", 0.8)))
        return work.extract_counts(self.unet, self.size, self.strategy,
                                   self.roi, n)

    def reference(self, volume, operand_dtype=None) -> torch.Tensor:
        """The features of one host volume (1, D, H, W, 1), by the plain
        reference, as (1, D, H, W, C) f32 on the device."""
        x = torch.as_tensor(volume, device=self.device).permute(0, 4, 1, 2, 3)

        def model(v):
            return ref_unet.forward(self.unet, self.sd, v, operand_dtype)

        if self.strategy == "full":
            stride = 2 ** self.unet["num_downs"]
            pads = [((-s) % stride) for s in x.shape[2:]]
            halves = [(p // 2, p - p // 2) for p in pads]
            xp = F.pad(x, tuple(v for h in reversed(halves) for v in h))
            y = model(xp)
            y = y[(slice(None), slice(None),
                   *(slice(a, a + s) for (a, _), s in zip(halves,
                                                          x.shape[2:])))]
        else:
            t = self.traffic
            y = ref_sliding.sliding_window(
                x, model, self.unet["output_nc"], self.roi,
                t.get("overlap", 0.8), t.get("sigma_scale", 0.25))
        return y.permute(0, 2, 3, 4, 1)

    def finish(self) -> dict[str, float]:
        """Free the program, recompute the kept answers by the reference,
        and return the worst of each compared number."""
        kept = list(self.kept.values())
        self.kept.clear()
        self.extract = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        worst = {"mean_err": 0.0, "max_err": 0.0}
        refs: dict[int, torch.Tensor] = {}
        for k, y in kept:
            if k not in refs:
                refs[k] = self.reference(self.pool[k])
            r = refs[k]
            d = (y.float() - r).abs()
            for name, v in (("mean_err", d.mean() / r.std()),
                            ("max_err", d.max() / r.abs().max())):
                v = float(v)
                worst[name] = v if not v <= worst[name] else worst[name]
        return worst
