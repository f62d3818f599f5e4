"""The plain reference agrees with the port's plain float32 CPU path."""

import numpy as np
import pytest
import torch

from gpubench import synth
from gpubench.reference import sliding as ref_sliding
from gpubench.reference import unet as ref_unet

TINY = {
    "6m": dict(dimension=3, input_nc=1, output_nc=4, num_downs=2, ngf=4,
               norm="batch", activation="relu", pad_type="reflect",
               pooling="Max", interp="nearest", norm_eps=1e-5),
    "dev": dict(dimension=3, input_nc=1, output_nc=4, num_downs=2, ngf=4,
                norm="instance", activation="relu", pad_type="reflect",
                pooling="Avg", interp="trilinear", norm_eps=1e-2),
}


def _port_extractor(cfg, sd, strategy, **kw):
    from anatomix_tpu_torch.extract import make_feature_extractor
    from anatomix_tpu_torch.models.unet import UnetConfig, build_plan

    sd = dict(sd)
    plan = build_plan(UnetConfig(**cfg))
    return make_feature_extractor(plan, sd, strategy=strategy, device="cpu",
                                  compute_dtype=torch.float32, **kw)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name", ["6m", "dev"])
def test_unet_matches_the_ports_plain_path(name):
    cfg = TINY[name]
    sd = synth.unet_weights(ref_unet.parameter_shapes(cfg), cfg["norm"], 11,
                            "cpu")
    vol = synth.structured_volume((16, 16, 24), 11, 0, "cpu")
    port = _port_extractor(cfg, sd, "full")(vol)
    x = torch.from_numpy(vol).permute(0, 4, 1, 2, 3)
    ref = ref_unet.forward(cfg, sd, x).permute(0, 2, 3, 4, 1)
    assert ref.shape == port.shape
    assert _rel(port, ref) < 1e-5


def test_sliding_matches_the_ports_plain_path():
    cfg = TINY["dev"]
    sd = synth.unet_weights(ref_unet.parameter_shapes(cfg), cfg["norm"], 5,
                            "cpu")
    vol = synth.structured_volume((20, 12, 18), 5, 1, "cpu")
    roi = (16, 16, 16)
    port = _port_extractor(cfg, sd, "sliding", roi_size=roi, overlap=0.6,
                           sw_batch_size=2)(vol)
    x = torch.from_numpy(vol).permute(0, 4, 1, 2, 3)
    ref = ref_sliding.sliding_window(
        x, lambda w: ref_unet.forward(cfg, sd, w), cfg["output_nc"], roi,
        0.6, 0.25).permute(0, 2, 3, 4, 1)
    assert ref.shape == port.shape
    assert _rel(port, ref) < 1e-5


def test_window_starts_and_gaussian_map():
    assert ref_sliding.window_starts(192, 128, 0.8) == [0, 25, 50, 64]
    assert ref_sliding.window_starts(100, 128, 0.8) == [0]
    m = ref_sliding.gaussian_map((128, 128, 128), 0.25, "cpu")
    assert float(m.max()) == 1.0
    assert float(m.min()) == pytest.approx(float(m[0, 0, 0]))
    assert float(m.min()) >= 1e-3


@pytest.mark.parametrize("magnitude", [1.0, 1e-2])
def test_fp8_rounding_is_coarser_than_bf16(magnitude):
    x = magnitude * torch.randn(10000,
                                generator=torch.Generator().manual_seed(0))
    e8 = (ref_unet.round_to(x, torch.float8_e4m3fn) - x).abs().mean()
    e16 = (ref_unet.round_to(x, torch.bfloat16) - x).abs().mean()
    assert float(e8) > 8 * float(e16)


def test_volumes_and_weights_follow_the_seed():
    big = 2 ** 33 + 17
    a = synth.structured_volume((8, 8, 8), big, 2, "cpu")
    b = synth.structured_volume((8, 8, 8), big, 2, "cpu")
    c = synth.structured_volume((8, 8, 8), big + 1, 2, "cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() == 0.0 and a.max() == 1.0
    shapes = ref_unet.parameter_shapes(TINY["6m"])
    w1 = synth.unet_weights(shapes, "batch", big, "cpu")
    w2 = synth.unet_weights(shapes, "batch", big, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert all(float(w1[k].min()) > 0 for k in shapes if "running_var" in k)


def test_convexadam_matches_the_ports_registration():
    """Merged features and field of a small seeded pair: the reference's
    MIND-SSC, features and solver against `registration.pipeline`'s."""
    from anatomix_tpu_torch.models.unet import UnetConfig, build_plan
    from anatomix_tpu_torch.registration.pipeline import pair_features, solve

    from gpubench.reference import convexadam

    cfg = dict(TINY["6m"], output_nc=16)
    sd = synth.unet_weights(ref_unet.parameter_shapes(cfg), "batch", 3,
                            "cpu")
    f, m = synth.structured_pair((32, 32, 32), 3, 0, "cpu")
    ff, fm = pair_features(f, m, build_plan(UnetConfig(**cfg)), sd,
                           device="cpu")

    def merged(img):
        x = torch.from_numpy(img)
        v = ((x - x.min()) / (x.max() - x.min()))[None, None]
        feat = ref_sliding.sliding_window(
            v, lambda w: ref_unet.forward(cfg, sd, w), 16, (128,) * 3, 0.8,
            0.25).permute(0, 2, 3, 4, 1)
        return convexadam.merged_features(x, feat, 0.1)

    rf, rm = merged(f), merged(m)
    assert _rel(ff, rf) < 1e-5 and _rel(fm, rm) < 1e-5
    kw = dict(grid_sp=2, disp_hw=1, grid_sp_adam=2, lambda_weight=0.75,
              niter=80)
    port = solve(ff, fm)
    assert torch.equal(convexadam.solve(ff, fm, **kw), port)
    assert float((convexadam.solve(rf, rm, **kw) - port).abs().max()) < 1e-4
