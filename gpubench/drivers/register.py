"""Registration: each request hands the program one pair of volumes.

Set-up makes the configuration's weights and a pool of seeded multimodal
pairs (raw host arrays, as the registration CLI reads them) and warms the
path up. Request `i` calls
`anatomix_tpu_torch.registration.pipeline.register_pair` on pair
`i mod pool` with the mix's settings: features of both volumes, the
MIND-SSC merge, the coupled convex stage with inverse consistency and the
Adam instance optimisation; it returns the field on the device, after a
device synchronize.

The check follows the program from its own state. Each kept request
(the one drawn from the seed among the first `check_within` and, unless
the mix sets `check_last` false, the window's last) keeps its field and
the merged features that `register_pair` made for it in the window (seen
by wrapping `registration.pipeline.pair_features`, which the request
calls; a request that does not call it fails, so a program change that
moves that seam has to come with a benchmark change). After the window, with the program freed, against the plain f32
reference (MIND-SSC by `reference/convexadam.py`, the network features by
`reference/unet.py` and `reference/sliding.py`): `feat_max_err`, the
network channels of the merged features, max |program - reference| over
max |reference|; `mind_err`, the 12 MIND-SSC channels, max |program -
reference|; `disp_err`, the field against `reference/convexadam.solve` run
in f32 on the program's own merged features, mean |program - reference|
in voxels.

With `control`, the reference serves the requests in the precisions
below the configuration's: its conv operands in fp8, its solver's
features held in bf16.
"""

from __future__ import annotations

import gc
import sys
import time

import torch
from torch.profiler import record_function

from gpubench import harness, synth, work
from gpubench.drivers.extract import CONTROL_DTYPE
from gpubench.reference import convexadam
from gpubench.reference import sliding as ref_sliding
from gpubench.reference import unet as ref_unet
from gpubench.reference.sliding import window_starts


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, *, control: bool = False):
        self.device = device
        self.unet = config["unet"]
        self.traffic = traffic
        self.roi = tuple(traffic["roi"])
        self.size = tuple(traffic["size"])
        self.sd = synth.unet_weights(ref_unet.parameter_shapes(self.unet),
                                     self.unet.get("norm", "batch"), seed,
                                     device)
        self.pool = [synth.structured_pair(self.size, seed, k, device)
                     for k in range(traffic["pool"])]
        self.keep = harness.sample_index(seed, traffic["check_within"])
        self.min_requests = self.keep + 1
        self.kept: dict[str, tuple] = {}
        self.merged = None  # the last request's merged features
        self.spans: dict[str, list[float]] = {"solver": []}
        self._restore = None
        t0 = time.perf_counter()
        if control:
            self.register = self._control(CONTROL_DTYPE[config["dtype"]],
                                          CONTROL_DTYPE[traffic[
                                              "solver_dtype"]])
        else:
            self.register = self._program()
        print(f"set-up of the program {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)

    def _settings(self) -> dict:
        t = self.traffic
        return {k: t[k] for k in ("lambda_weight", "grid_sp", "disp_hw",
                                  "grid_sp_adam")}

    def _program(self):
        import anatomix_tpu_torch.registration.pipeline as pipe
        from anatomix_tpu_torch.models.unet import UnetConfig, build_plan

        plan = build_plan(UnetConfig(**self.unet))
        inner = pipe.pair_features

        def observed(*args, **kwargs):
            self.merged = inner(*args, **kwargs)
            return self.merged

        pipe.pair_features = observed
        self._restore = lambda: setattr(pipe, "pair_features", inner)
        kw = dict(self._settings(), selected_niter=self.traffic["niter"],
                  selected_smooth=0, ic=True,
                  downscale_feat_scalar=self.traffic[
                      "downscale_feat_scalar"],
                  extract_strategy=self.traffic["strategy"],
                  device=self.device)
        return lambda f, m: pipe.register_pair(f, m, plan, self.sd, **kw)

    def _control(self, unet_dtype, solver_dtype):
        def run(f, m):
            self.merged = tuple(v.to(solver_dtype).float()
                                for v in self._merged(f, m, unet_dtype))
            return self._solve(*self.merged, solver_dtype), 0.0
        return run

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, trace: bool):
        """The pair's shapes, once per pool pair; with `trace`, the
        profiler once."""
        for f, m in self.pool:
            self.register(f, m)
            self._sync()
        if trace:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                torch.ones(1, device=self.device).add_(1)
                self._sync()

    def request(self, i: int):
        k = i % len(self.pool)
        self.merged = None
        with record_function("bench/register"):
            disp, solver_s = self.register(*self.pool[k])
        self._sync()
        if self.merged is None:
            raise RuntimeError(
                "register_pair made no merged features through "
                "registration.pipeline.pair_features, which the check reads")
        self.spans["solver"].append(solver_s)
        answer = (k, disp, self.merged)
        if i == self.keep:
            self.kept["sampled"] = answer
        if self.traffic.get("check_last", True):
            self.kept["last"] = answer

    def counts(self) -> tuple[float, float]:
        n = 1
        for s, r in zip(self.size, self.roi):
            n *= len(window_starts(max(s, r), r, 0.8))
        ops, least = work.extract_counts(self.unet, self.size, "sliding",
                                         self.roi, n)
        return 2 * ops, 2 * least

    def _features(self, img, operand_dtype):
        x = torch.as_tensor(img, device=self.device).float()
        x = ((x - x.min()) / (x.max() - x.min()))[None, None]
        y = ref_sliding.sliding_window(
            x, lambda v: ref_unet.forward(self.unet, self.sd, v,
                                          operand_dtype),
            self.unet["output_nc"], self.roi, 0.8, 0.25)
        return y.permute(0, 2, 3, 4, 1)

    def _merged(self, fixed, moving, operand_dtype=None):
        """The merged features of a pair by the reference."""
        return tuple(convexadam.merged_features(
            torch.as_tensor(v, device=self.device),
            self._features(v, operand_dtype),
            self.traffic["downscale_feat_scalar"]) for v in (fixed, moving))

    def _solve(self, ff, fm, solver_dtype=None):
        with ref_unet.no_tf32():
            return convexadam.solve(ff, fm, niter=self.traffic["niter"],
                                    solver_dtype=solver_dtype,
                                    **self._settings())

    def finish(self) -> dict[str, float]:
        kept = list(self.kept.values())
        self.kept.clear()
        self.register = self.merged = None
        if self._restore is not None:
            self._restore()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        worst = dict.fromkeys(("feat_max_err", "mind_err", "disp_err"),
                              0.0)
        refs: dict[int, tuple] = {}
        for k, disp, merged in kept:
            if k not in refs:
                refs[k] = self._merged(*self.pool[k])
            vals = dict.fromkeys(("feat_max_err", "mind_err"), 0.0)
            for p, r in zip(merged, refs[k]):
                d = (p.float() - r).abs()
                vals["feat_max_err"] = max(vals["feat_max_err"], float(
                    d[..., 12:].max() / r[..., 12:].abs().max()))
                vals["mind_err"] = max(vals["mind_err"],
                                       float(d[..., :12].max()))
            vals["disp_err"] = float(
                (disp.float() - self._solve(*merged)).abs().mean())
            for name, v in vals.items():
                worst[name] = v if not v <= worst[name] else worst[name]
        return worst
