"""The operation and byte counts, against counts made by hand."""

import pytest

from gpubench import peaks, work

SIXM = dict(dimension=3, input_nc=1, output_nc=16, num_downs=4, ngf=16,
            norm="batch", pooling="Max", interp="nearest")


def test_one_conv():
    cfg = dict(SIXM, num_downs=0, input_nc=16, ngf=16, output_nc=16)
    # a 0-level net is stem, two bottleneck convs and the exit: take the
    # first conv's line alone
    kind, ops, byts = work._levels(cfg, (128, 128, 128))[0]
    vox = 128 ** 3
    assert kind == "conv"
    assert ops == 2 * 27 * 16 * 16 * vox == 28_991_029_248
    assert byts == 2 * (16 * vox + 16 * vox + 27 * 16 * 16)
    # Table B's 16->16 conv at B2 128^3 reads 0.0801 ms, bytes-bound
    assert peaks.bound_seconds(ops, byts) * 2e3 == pytest.approx(0.0801,
                                                                 abs=1e-4)


def test_6m_unet_at_128():
    ops, _ = work.forward_counts(SIXM, (128, 128, 128))
    # sum of Ci * Co over the convs of each level, level 0 = 128^3
    per_level = {
        0: 1 * 16 + 16 * 16 + 16 * 16 + 48 * 16 + 16 * 16 + 16 * 16,
        1: 16 * 32 + 32 * 32 + 96 * 32 + 32 * 32,
        2: 32 * 64 + 64 * 64 + 192 * 64 + 64 * 64,
        3: 64 * 128 + 128 * 128 + 384 * 128 + 128 * 128,
        4: 128 * 256 + 256 * 256,
    }
    hand = sum(54 * ci_co * (128 >> lvl) ** 3
               for lvl, ci_co in per_level.items())
    assert hand == 346_986_381_312
    assert ops == hand


def test_sliding_counts_every_window_and_the_stitch():
    dev = dict(SIXM, output_nc=32, num_downs=5, ngf=32, norm="instance",
               pooling="Avg", interp="trilinear")
    one, least_one = work.forward_counts(dev, (128, 128, 128))
    assert one == pytest.approx(1.418e12, rel=2e-3)
    ops, least = work.extract_counts(dev, (192, 192, 192), "sliding",
                                     (128, 128, 128), 64)
    assert ops == 64 * one
    assert least > 64 * least_one
