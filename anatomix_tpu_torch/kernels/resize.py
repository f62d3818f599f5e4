"""Exact 2x trilinear upsample on NDHWC: wrapper, plain version, counter.

`upsample2x_trilinear_ndhwc` replaces the JAX package's D2 Pallas kernel
(`anatomix_tpu/ops/pallas/upsample.py` upsample2x_trilinear_block_pallas)
with the kernel of `csrc/upsample.cu`, whose header says what bounds it on
the card and what its design does about it. It writes plain NDHWC, not the
TPU's block layout: the port's decoder conv reads it through the
two-operand conv (`kernels/conv.conv3x3x3_cat_ndhwc`).

With `split=True` input and output are the three-term split (..., 3 C)
[hi | lo | hi] of an f32 volume (`ops/conv.split3`): the live-norm UNet's
decoder under the split (`models/unet_fused.py`).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (`ops/resize.upsample2x(x, "trilinear")`).
`.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.ops.conv import merge3, split3
from anatomix_tpu_torch.ops.resize import upsample2x

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns: dict = {}


def _fn():
    fn = _fns.get("upsample2x_trilinear_ndhwc")
    if fn is None:
        fn = build.load("upsample").upsample2x_trilinear_ndhwc
        fn.argtypes = [_P, _P] + [_I] * 6 + [_P]
        fn.restype = ctypes.c_int
        _fns["upsample2x_trilinear_ndhwc"] = fn
    return fn


def upsample2x_trilinear_ndhwc_plain(x: torch.Tensor,
                                     split: bool = False) -> torch.Tensor:
    """f32 arithmetic (`F.interpolate`); returns `x.dtype` (the split of
    the f32 result with `split`)."""
    if split:
        return split3(upsample2x(merge3(x), "trilinear"))
    return upsample2x(x, "trilinear")


def upsample2x_trilinear_ndhwc(x: torch.Tensor,
                               split: bool = False) -> torch.Tensor:
    """(B, d, h, w, C) -> (B, 2d, 2h, 2w, C), torch `align_corners=False`
    trilinear with the edge clamp; with `split` both in the (..., 3 C)
    three-term split."""
    if x.device.type == "cpu":
        return upsample2x_trilinear_ndhwc_plain(x, split)
    if x.dtype != torch.bfloat16 or x.dim() != 5 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous bf16 (B, d, h, w, C) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    B, d, h, w, C = x.shape
    if split and C % 3:
        raise ValueError(f"a split volume has 3 C channels, got {C}")
    out = torch.empty((B, 2 * d, 2 * h, 2 * w, C), dtype=x.dtype,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn()(x.data_ptr(), out.data_ptr(), B, d, h, w,
               C // 3 if split else C, int(split), stream)
    build.check(rc, "upsample2x_trilinear_ndhwc")
    upsample2x_trilinear_ndhwc.launches += 1
    return out


upsample2x_trilinear_ndhwc.launches = 0
