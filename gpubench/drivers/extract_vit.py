"""Feature extraction by the ViT: each request hands the program one whole volume.

The extraction driver (`drivers/extract.py`) for the `anatomix-dev-vit`
configuration: its requests, warm-up, kept answers and check are the same;
set-up, the program, the reference and the counts are the ViT's. Set-up
makes the seeded weights (`synth_vit.py`, in the program's keys) and the
volume pool and builds the extractor users call,
`anatomix_tpu_torch.extract.make_feature_extractor` on the registry's
`PrimusConfig` (bf16 compute, windows of the ViT's bound input, the mix's
overlap, Gaussian sigma and window batch). The check computes the kept
volumes again by `reference/primus.py` through `reference/sliding.py`,
each part of the model in the precision the configuration file states
(`precision`: q, k and v into attention and the decoder in bfloat16, the
rest in float32), TF32 off.

With `control`, the reference serves the requests with every part in
bfloat16 (`CONTROL_DTYPE`): the precision below the stated float32 of the
tokenizer, the residual stream, the linears, the LayerNorms, RoPE and the
MLP, which the check has to find wrong.

Besides `enqueue`, the driver's `spans` hold `v3_least_s`: the least time
of a volume's flash attention (`work_vit.forward_counts(..., 'attention')`
over every window), which `metrics/attention_roofline.py` reads.
"""

from __future__ import annotations

import sys
import time

import torch

from gpubench import harness, synth, synth_vit, work_vit
from gpubench.drivers import extract
from gpubench.reference import primus as ref_primus
from gpubench.reference import sliding as ref_sliding
from gpubench.reference.sliding import window_starts

CONTROL_DTYPE = "bfloat16"


def reference_config(config: dict) -> dict:
    """The registry's `vit_kwargs` with the defaults it leaves out."""
    return dict(config["assumed"]["defaults"], **config["vit"])


class Driver(extract.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, *, control: bool = False):
        self.device = device
        self.vit = config["vit"]
        self.cfg = reference_config(config)
        self.precision = config["precision"]
        self.traffic = traffic
        self.roi = tuple(self.cfg["input_shape"])
        self.size = tuple(traffic["size"])
        self.sd = synth_vit.vit_weights(
            ref_primus.parameter_shapes(self.cfg), self.cfg, seed, device)
        self.pool = [synth.structured_volume(self.size, seed, k, device)
                     for k in range(traffic["pool"])]
        self.keep = harness.sample_index(seed, traffic["check_within"])
        self.min_requests = self.keep + 1
        self.kept: dict[str, tuple[int, torch.Tensor]] = {}
        n = self.windows()
        _, v3_least = work_vit.forward_counts(self.cfg, "attention")
        self.spans: dict[str, list[float]] = {"enqueue": [],
                                              "v3_least_s": [n * v3_least]}
        t0 = time.perf_counter()
        if control:
            every = {part: CONTROL_DTYPE for part in ref_primus.PARTS}
            self.extract = lambda v: self.reference(v, every)
        else:
            self.extract = self._program()
        print(f"set-up of the program {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)

    def _program(self):
        from anatomix_tpu_torch.extract import make_feature_extractor
        from anatomix_tpu_torch.models.vit3d import primus_config

        t = self.traffic
        return make_feature_extractor(
            primus_config(self.vit), self.sd,
            sw_batch_size=t.get("sw_batch_size", 2),
            overlap=t.get("overlap", 0.8), mode="gaussian",
            sigma_scale=t.get("sigma_scale", 0.25), device=self.device)

    def windows(self) -> int:
        n = 1
        for s, r in zip(self.size, self.roi):
            n *= len(window_starts(max(s, r), r, self.traffic.get(
                "overlap", 0.8)))
        return n

    def counts(self) -> tuple[float, float]:
        return work_vit.extract_counts(self.cfg, self.size, self.windows())

    def reference(self, volume, precision=None) -> torch.Tensor:
        """The features of one host volume (1, D, H, W, 1), by the plain
        reference in `precision` (by default the configuration's), as (1,
        D, H, W, C) f32 on the device."""
        x = torch.as_tensor(volume, device=self.device).permute(0, 4, 1, 2, 3)
        t = self.traffic

        def model(v):
            return ref_primus.forward(self.cfg, self.sd, v,
                                      precision or self.precision)

        y = ref_sliding.sliding_window(
            x, model, self.cfg["num_classes"], self.roi,
            t.get("overlap", 0.8), t.get("sigma_scale", 0.25))
        return y.permute(0, 2, 3, 4, 1)
