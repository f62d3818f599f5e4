"""The port's kernel modules (`anatomix_tpu_torch/kernels/`).

On the CPU each wrapper runs its plain version; those are held against the
JAX package's Pallas kernels in interpret mode, at the tolerances of the
JAX tests that run them (`tests/test_conv_block.py`,
`tests/test_pallas_conv.py`, `tests/test_sliding_window.py`), and against
the XLA conv at production block extents (ROADMAP F3). The CUDA kernels
themselves are tested in `test_torch_gpu.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.ops.conv import conv3d as jax_conv3d
from anatomix_tpu.ops.pallas.conv3x3 import (
    _depth_to_space,
    _space_to_depth,
    conv3x3_same,
)
from anatomix_tpu.ops.pallas.conv_block import (
    conv_block_sparse,
    conv_block_sparse_skip,
    prepack_sparse,
    prepack_sparse_skip,
)
from anatomix_tpu.ops.pallas.scatter import blend_scatter_fold, lane_tables
from anatomix_tpu.ops.resize import upsample2x as jax_upsample2x
from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.kernels.conv import (
    conv3x3x3_ndhwc,
    conv3x3x3_ndhwc_plain,
    conv3x3x3_upcat_ndhwc,
)
from anatomix_tpu_torch.kernels.scatter import blend_scatter
from anatomix_tpu_torch.ops.conv import dhwio_to_torch, pack_conv_weight
from anatomix_tpu_torch.ops.sliding_window import gaussian_importance_axes


def _packed(w_dhwio: np.ndarray) -> torch.Tensor:
    return pack_conv_weight(dhwio_to_torch(torch.from_numpy(w_dhwio)))


def _maxrel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# -----------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)

@pytest.mark.parametrize(
    "ci,co,pad,act",
    [(3, 5, "zeros", "none"), (16, 16, "reflect", "lrelu"),
     (8, 4, "zeros", "relu")],
)
def test_conv_plain_matches_pallas_sparse_block(ci, co, pad, act):
    """K1 `conv_block_sparse` (block layout, interpret mode). Its epilogue
    hard-codes LeakyReLU slope 0.2 (ROADMAP F2); the port passes it."""
    rng = np.random.default_rng(ci * 10 + co)
    x = rng.standard_normal((2, 8, 8, 8, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    packed = prepack_sparse(w, b, act=act, compute_dtype=jnp.float32)
    ref = np.asarray(_depth_to_space(conv_block_sparse(
        _space_to_depth(jnp.asarray(x)), packed, pad_type=pad,
        interpret=True)))
    got = conv3x3x3_ndhwc(
        torch.from_numpy(x), _packed(w), torch.from_numpy(b), act=act,
        slope=0.2, pad_type=pad, out_dtype=torch.float32)
    assert _maxrel(got, ref) < 2e-2


@pytest.mark.parametrize(
    "cin,cout,pad,s2d",
    [(1, 8, "reflect", "on"), (4, 6, "zeros", "off"),
     (16, 16, "reflect", "on")],
)
def test_conv_plain_matches_pallas_conv3x3(cin, cout, pad, s2d):
    """K2 `_conv3x3_valid` through `conv3x3_same` (interpret mode): the
    Ci=1 entry conv and the direct form."""
    rng = np.random.default_rng(cin * 10 + cout)
    x = rng.standard_normal((2, 8, 8, 8, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = np.asarray(conv3x3_same(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pad_type=pad,
        compute_dtype=jnp.float32, s2d=s2d, interpret=True))
    got = conv3x3x3_ndhwc(torch.from_numpy(x), _packed(w),
                          torch.from_numpy(b), pad_type=pad,
                          out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("c1,c2,co,pad",
                         [(4, 6, 5, "reflect"), (16, 8, 16, "zeros")])
def test_upcat_plain_matches_pallas_skip(c1, c2, co, pad):
    """K3 `conv_block_sparse_skip`: upsample + concat + conv, fused."""
    rng = np.random.default_rng(c1 + c2 + co)
    enc = rng.standard_normal((1, 8, 8, 8, c1)).astype(np.float32)
    small = rng.standard_normal((1, 4, 4, 4, c2)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, c1 + c2, co)) * 0.1).astype(
        np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    packed = prepack_sparse_skip(w, b, c1=c1, act="lrelu",
                                 compute_dtype=jnp.float32)
    ref = np.asarray(_depth_to_space(conv_block_sparse_skip(
        _space_to_depth(jnp.asarray(enc)), jnp.asarray(small), packed,
        pad_type=pad, interpret=True)))
    got = conv3x3x3_upcat_ndhwc(
        torch.from_numpy(enc), torch.from_numpy(small), _packed(w),
        torch.from_numpy(b), act="lrelu", slope=0.2, pad_type=pad,
        out_dtype=torch.float32)
    assert _maxrel(got, ref) < 2e-2


@pytest.mark.parametrize("mode", ["gaussian", "constant"])
def test_scatter_plain_matches_pallas_fold(mode):
    """K4 `blend_scatter_fold` (interpret mode): overlapping windows, one
    masked padding window, the clamp before the mask. The port's canvas
    (D, H, W, C) is the JAX folded canvas (D, H, W*C/128, 128) reshaped."""
    rng = np.random.default_rng(7)
    D, H, W, C, r = 32, 24, 32, 16, 16
    if mode == "gaussian":
        axes, minv = gaussian_importance_axes((r, r, r), 0.25)
    else:
        axes, minv = [np.ones(r)] * 3, 0.0
    starts = np.array([[0, 0, 0], [5, 3, 7], [16, 8, 16], [0, 0, 0]],
                      np.int32)
    mask = np.array([1, 1, 1, 0], np.int32)
    canvas = rng.standard_normal((D, H, W, C)).astype(np.float32)
    out = rng.standard_normal((4, r, r, r, C)).astype(np.float32)
    gdh, gw = lane_tables(axes, C)
    ref = np.asarray(blend_scatter_fold(
        jnp.asarray(canvas.reshape(D, H, W * C // 128, 128)),
        jnp.asarray(out.reshape(4, r, r, r * C // 128, 128)),
        jnp.asarray(starts), jnp.asarray(mask), jnp.asarray(gdh),
        jnp.asarray(gw).reshape(r * C // 128, 128), C=C, minv=float(minv),
        interpret=True)).reshape(D, H, W, C)
    g = [torch.as_tensor(a, dtype=torch.float32) for a in axes]
    got = blend_scatter(torch.from_numpy(canvas.copy()), torch.from_numpy(out),
                        torch.from_numpy(starts), torch.from_numpy(mask),
                        *g, minv)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-6)


# -----------------------------------------------------------------------------
# plain versions against the XLA conv at production block extents (F3)

@pytest.mark.parametrize("pad", ["reflect", "zeros"])
def test_conv_plain_matches_xla_at_64(pad):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 64, 64, 64, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 16, 16)) * 0.1).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    ref = np.asarray(jax_conv3d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), padding="SAME",
                                pad_type=pad))
    got = conv3x3x3_ndhwc(torch.from_numpy(x), _packed(w),
                          torch.from_numpy(b), act="relu", pad_type=pad,
                          out_dtype=torch.float32)
    assert _maxrel(got, np.maximum(ref, 0)) < 1e-5


def test_upcat_plain_matches_xla_at_64():
    rng = np.random.default_rng(12)
    enc = rng.standard_normal((1, 64, 64, 64, 8)).astype(np.float32)
    small = rng.standard_normal((1, 32, 32, 32, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 24, 8)) * 0.1).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    cat = jnp.concatenate(
        [jnp.asarray(enc), jax_upsample2x(jnp.asarray(small))], axis=-1)
    ref = np.asarray(jax_conv3d(cat, jnp.asarray(w), jnp.asarray(b),
                                padding="SAME", pad_type="reflect"))
    got = conv3x3x3_upcat_ndhwc(
        torch.from_numpy(enc), torch.from_numpy(small), _packed(w),
        torch.from_numpy(b), pad_type="reflect", out_dtype=torch.float32)
    assert _maxrel(got, ref) < 1e-5


def test_cpu_wrappers_run_plain_and_count_nothing():
    """A CPU tensor takes the plain version: no build, no launch counted."""
    x = torch.randn(1, 4, 4, 4, 2)
    w = torch.randn(27 * 2, 3)
    b = torch.zeros(3)
    before = conv3x3x3_ndhwc.launches
    y = conv3x3x3_ndhwc(x, w, b, act="relu", pad_type="zeros",
                        out_dtype=torch.float32)
    assert torch.equal(y, conv3x3x3_ndhwc_plain(
        x, w, b, act="relu", pad_type="zeros", out_dtype=torch.float32))
    assert conv3x3x3_ndhwc.launches == before
    assert build.SOURCES == ("conv3d", "blend_scatter", "norm_apply",
                             "upsample", "conv_down", "flash_attention",
                             "depth_to_space8", "conv3d_wgrad", "reshuffle")
    # the ViT's kernels take their plain versions on the CPU too
    from anatomix_tpu_torch.kernels.attention import flash_attention
    from anatomix_tpu_torch.kernels.conv_down import conv_down2_ndhwc
    from anatomix_tpu_torch.kernels.conv_train import (
        conv3x3x3_dgrad_ndhwc,
        conv3x3x3_wgrad_ndhwc,
    )
    from anatomix_tpu_torch.kernels.reshuffle import (
        depth_to_space2_ndhwc,
        depth_to_space8_ndhwc,
        space_to_depth2_ndhwc,
    )

    wrappers = (conv_down2_ndhwc, flash_attention, depth_to_space8_ndhwc,
                conv3x3x3_wgrad_ndhwc, conv3x3x3_dgrad_ndhwc,
                space_to_depth2_ndhwc, depth_to_space2_ndhwc)
    counts = [f.launches for f in wrappers]
    conv_down2_ndhwc(x, w, b)
    q = torch.randn(1, 2, 5, 4)
    flash_attention(q, q, q, 0.5)
    depth_to_space8_ndhwc(torch.randn(1, 1, 1, 1, 512))
    # and the conv's backward kernels (the pretraining step)
    dy = torch.randn(1, 4, 4, 4, 3)
    conv3x3x3_wgrad_ndhwc(x, dy, pad_type="zeros")
    conv3x3x3_dgrad_ndhwc(dy, w, pad_type="zeros")
    # and the block-layout permutations of its train walk
    depth_to_space2_ndhwc(space_to_depth2_ndhwc(x))
    assert [f.launches for f in wrappers] == counts
