"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test skips without CUDA. The file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from anatomix_tpu_torch.kernels.conv import (
    conv3x3x3_cat_ndhwc,
    conv3x3x3_cat_ndhwc_plain,
    conv3x3x3_ndhwc,
    conv3x3x3_ndhwc_plain,
    conv3x3x3_upcat_ndhwc,
    conv3x3x3_upcat_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.norm import (
    norm_apply_ndhwc,
    norm_apply_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.resize import (
    upsample2x_trilinear_ndhwc,
    upsample2x_trilinear_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.scatter import (
    blend_scatter,
    blend_scatter_plain,
)
from anatomix_tpu_torch.ops.norms import tile_maps
from anatomix_tpu_torch.ops.sliding_window import gaussian_importance_axes


def _maxrel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "ci,co,pad,act,S",
    [(1, 16, "reflect", "relu", 32), (16, 16, "zeros", "lrelu", 24),
     (5, 7, "reflect", "elu", 10), (64, 64, "reflect", "tanh", 16)],
)
def test_conv_kernel_matches_plain(cuda, ci, co, pad, act, S):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, S, S + 2, S + 4, ci), generator=g,
                    device=cuda).bfloat16()
    w = (torch.randn((27 * ci, co), generator=g, device=cuda) * 0.1).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda)
    for out_dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        kw = dict(act=act, slope=0.3, pad_type=pad, out_dtype=out_dtype)
        got = conv3x3x3_ndhwc(x, w, b, **kw)
        ref = conv3x3x3_ndhwc_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("c1,c2,co,pad", [(16, 32, 16, "reflect"),
                                          (4, 6, 5, "zeros"),
                                          (0, 8, 8, "reflect")])
def test_upcat_kernel_matches_plain(cuda, c1, c2, co, pad):
    g = torch.Generator(device=cuda).manual_seed(1)
    small = torch.randn((2, 6, 5, 7, c2), generator=g, device=cuda).bfloat16()
    enc = None if c1 == 0 else torch.randn(
        (2, 12, 10, 14, c1), generator=g, device=cuda).bfloat16()
    w = (torch.randn((27 * (c1 + c2), co), generator=g, device=cuda)
         * 0.1).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda)
    kw = dict(act="relu", pad_type=pad, out_dtype=torch.float32)
    got = conv3x3x3_upcat_ndhwc(enc, small, w, b, **kw)
    ref = conv3x3x3_upcat_ndhwc_plain(enc, small, w, b, **kw)
    torch.cuda.synchronize()
    assert _maxrel(got.cpu(), ref.cpu()) < 1e-4


@pytest.mark.gpu
def test_scatter_kernel_matches_plain(cuda):
    r, C = 16, 16
    axes, minv = gaussian_importance_axes((r, r, r), 0.25)
    gd, gh, gw = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                  for a in axes)
    starts = torch.tensor([[0, 0, 0], [5, 3, 7], [0, 0, 0]],
                          dtype=torch.int32, device=cuda)
    mask = torch.tensor([1, 1, 0], dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    out = torch.randn((3, r, r, r, C), generator=g, device=cuda)
    canvas = torch.randn((24, 20, 28, C), generator=g, device=cuda)
    got = blend_scatter(canvas.clone(), out, starts, mask, gd, gh, gw, minv)
    ref = blend_scatter_plain(canvas.clone(), out, starts, mask, gd, gh, gw,
                              minv)
    torch.cuda.synchronize()
    assert _maxrel(got.cpu(), ref.cpu()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("c1,c2,co,pad,S", [(32, 64, 32, "reflect", 12),
                                            (16, 8, 5, "zeros", 9),
                                            (4, 6, 8, "reflect", 6),
                                            (64, 128, 64, "reflect", 4)])
def test_cat_kernel_matches_plain(cuda, c1, c2, co, pad, S):
    """The two-operand conv at one resolution, down to the dev bottleneck's
    4^3 (smaller than the kernel's 16x4x2 output brick)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    enc = torch.randn((2, S, S + 1, S + 2, c1), generator=g,
                      device=cuda).bfloat16()
    up = torch.randn((2, S, S + 1, S + 2, c2), generator=g,
                     device=cuda).bfloat16()
    w = (torch.randn((27 * (c1 + c2), co), generator=g, device=cuda)
         * 0.1).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda)
    for out_dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        kw = dict(act="none", pad_type=pad, out_dtype=out_dtype)
        got = conv3x3x3_cat_ndhwc(enc, up, w, b, **kw)
        ref = conv3x3x3_cat_ndhwc_plain(enc, up, w, b, **kw)
        torch.cuda.synchronize()
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("shape,tiles,act,dtype", [
    ((2, 8, 8, 8, 32), (1, 1, 1), "relu", torch.bfloat16),
    ((2, 8, 8, 8, 32), (1, 1, 1), "relu", torch.float32),
    ((1, 16, 12, 20, 32), (2, 2, 2), "lrelu", torch.float32),
    ((1, 40, 40, 40, 32), (3, 3, 3), "relu", torch.float32),
    ((2, 6, 5, 7, 12), (2, 1, 3), "none", torch.bfloat16),  # C % 8 != 0
    ((2, 6, 5, 7, 12), (2, 1, 3), "elu", torch.float32),
])
def test_norm_apply_kernel_matches_plain(cuda, shape, tiles, act, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    ts = (shape[0],) + tiles + (shape[-1],)
    a = torch.rand(ts, generator=g, device=cuda) + 0.5
    s = torch.randn(ts, generator=g, device=cuda)
    maps = tile_maps(shape[1:4], tiles, cuda)
    got = norm_apply_ndhwc(x, a, s, maps, act=act, slope=0.3)
    ref = norm_apply_ndhwc_plain(x, a, s, maps, act=act, slope=0.3)
    torch.cuda.synchronize()
    assert _maxrel(got.float().cpu(), ref.float().cpu()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 4, 5, 6, 16), (1, 3, 3, 3, 12),
                                   (1, 1, 2, 3, 8)])
def test_upsample_kernel_matches_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(shape, generator=g, device=cuda).bfloat16()
    got = upsample2x_trilinear_ndhwc(x)
    ref = upsample2x_trilinear_ndhwc_plain(x)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _maxrel(got.float().cpu(), ref.float().cpu()) < 1e-2
