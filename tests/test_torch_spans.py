"""The port's `record_function` ranges on the extraction path
(`utils/profiling.annotate`): under `torch.profiler` each opens where its
module's docstring says, as often as the work it encloses; with no profiler
running none is entered and the features are the same bits."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anatomix_tpu_torch.extract import make_feature_extractor
from anatomix_tpu_torch.models.unet import Unet, UnetConfig, build_plan
from anatomix_tpu_torch.ops.sliding_window import compute_window_starts
from anatomix_tpu_torch.utils import profiling

ROI, OVERLAP, SW_BATCH = (16, 16, 16), 0.5, 2
SHAPE = (24, 24, 18)
CASES = {
    "instance-sliding": (dict(norm="instance", pooling="Avg",
                              interp="trilinear"), "sliding"),
    "batch-full": (dict(norm="batch"), "full"),
}
OUTER = "test/request"


def _extractor(case):
    kw, strategy = CASES[case]
    plan = build_plan(UnetConfig(input_nc=1, output_nc=4, num_downs=2,
                                 ngf=4, **kw))
    torch.manual_seed(0)
    net = Unet(plan)
    if kw["norm"] == "batch":  # running statistics that a fold changes
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    fn = make_feature_extractor(
        plan, net.state_dict(), strategy=strategy, roi_size=ROI,
        sw_batch_size=SW_BATCH, overlap=OVERLAP, device="cpu",
        compute_dtype=torch.float32)
    return plan, strategy, fn


def _volume():
    rng = np.random.default_rng(3)
    return rng.random((1, *SHAPE, 1)).astype(np.float32)


def _named_parent(event):
    event = event.cpu_parent
    while event is not None and "/" not in event.name:
        event = event.cpu_parent
    return None if event is None else event.name


@pytest.mark.parametrize("case", list(CASES))
def test_spans_under_the_profiler(case):
    plan, strategy, fn = _extractor(case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate(OUTER):
            fn(_volume())
    ranges = [e for e in prof.events()
              if "/" in e.name and e.name != OUTER]
    counts = {}
    for e in ranges:
        counts[e.name] = counts.get(e.name, 0) + 1
        # no program range opens inside another: the forward runs outside
        # the stitch loop's ranges, the input copy before both
        assert _named_parent(e) == OUTER, e.name
    if strategy == "full":  # batch norm folded: no live norm, no windows
        assert counts == {"extract/input": 1}
        return
    starts = compute_window_starts(SHAPE, ROI, OVERLAP)
    chunks = -(-len(starts) // SW_BATCH)
    norms = sum(spec.kind == "norm" for spec in plan.layers)
    assert chunks > 1 and norms > 1
    assert counts == {
        "extract/input": 1, "sliding/setup": 1, "sliding/gather": chunks,
        "sliding/stitch": chunks, "sliding/finish": 1,
        "unet/norm_stats": norms * chunks,
    }
    # the window gather and stitch alternate with the forward, chunk by
    # chunk, after the set-up and before the finish
    order = [e.name for e in sorted(ranges, key=lambda e: e.time_range.start)
             if e.name.startswith("sliding/")]
    assert order == (["sliding/setup"]
                     + ["sliding/gather", "sliding/stitch"] * chunks
                     + ["sliding/finish"])


@pytest.mark.parametrize("case", list(CASES))
def test_no_range_without_a_profiler(case, monkeypatch):
    _, _, fn = _extractor(case)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = fn(_volume())
    assert profiling.annotate("a/b") is profiling.annotate("c/d")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.annotate(OUTER):
        untraced = fn(_volume())
    assert torch.equal(untraced, traced)


def test_vit_forward_spans():
    """A small ViT forward opens `vit/tokenizer`, then `vit/attention` and
    `vit/mlp` once a block, then `vit/decoder`; with no profiler running,
    `annotate` hands out the shared no-op and the output is the same."""
    from anatomix_tpu_torch.models.vit3d import (
        Primus,
        PrimusConfig,
        init_primus_params,
    )

    cfg = PrimusConfig(embed_dim=24, eva_depth=2, eva_numheads=2,
                       input_shape=(16, 16, 16), num_register_tokens=2,
                       num_classes=8, tokenizer_base_features=4,
                       qk_norm=True, scale_attn_inner=True,
                       out_norm="demean")
    model = Primus.from_state_dict(
        cfg, init_primus_params(cfg, torch.Generator().manual_seed(0)),
        device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).random(
        (1, 16, 16, 16, 1)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = model(x, compute_dtype=torch.float32)
    order = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.name.startswith("vit/")]
    assert order == (["vit/tokenizer"]
                     + ["vit/attention", "vit/mlp"] * cfg.eva_depth
                     + ["vit/decoder"])
    assert profiling.annotate("vit/attention") is profiling._OFF
    assert torch.equal(model(x, compute_dtype=torch.float32), traced)
