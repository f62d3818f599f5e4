"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test skips without CUDA. The file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from anatomix_tpu_torch.kernels.conv import (
    conv3x3x3_ndhwc,
    conv3x3x3_ndhwc_plain,
    conv3x3x3_upcat_ndhwc,
    conv3x3x3_upcat_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.scatter import (
    blend_scatter,
    blend_scatter_plain,
)
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
