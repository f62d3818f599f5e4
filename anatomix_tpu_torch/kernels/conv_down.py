"""Stride-2 3x3x3 conv (zero padding 1) on NDHWC: wrapper, plain version,
counter.

`conv_down2_ndhwc` replaces the JAX package's V2 Pallas kernel
(`anatomix_tpu/ops/pallas/conv_down.py` conv_down2_block), the ViT
tokenizer's downsample convs, with the kernel of `csrc/conv_down.cu`, whose
header says what bounds it on the card and what its design does about it.
The TPU kernel reads the space-to-depth block tensor; this one reads
channels-last `(B, D, H, W, Ci)` and writes `(B, (D-1)//2+1, ..., Co)`.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (f32 `F.conv3d` through `ops/conv.conv3d_down2`).
`.launches` counts kernel launches. Weights are packed `(27 * Ci, Co)` bf16
as for `kernels/conv.py`, the bias f32, accumulation f32, the output bf16
or f32.
"""

from __future__ import annotations

import ctypes

import torch

from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.kernels.conv import _check_act, _check_common
from anatomix_tpu_torch.ops.activations import EPILOGUE_ACTS, apply_activation
from anatomix_tpu_torch.ops.conv import conv3d_down2, unpack_conv_weight

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fns: dict = {}


def _fn():
    fn = _fns.get("conv_down2_ndhwc")
    if fn is None:
        fn = build.load("conv_down").conv_down2_ndhwc
        # x, w, bias, out; B, D, H, W, ci, co, act; slope; out_f32, stream
        fn.argtypes = [_P] * 4 + [_I] * 7 + [_F, _I, _P]
        fn.restype = ctypes.c_int
        _fns["conv_down2_ndhwc"] = fn
    return fn


def conv_down2_ndhwc_plain(x, w_packed, bias, *, act="none", slope=0.3,
                           out_dtype=torch.bfloat16):
    """f32 arithmetic on the same inputs."""
    w = unpack_conv_weight(w_packed.float(), x.shape[-1])
    y = conv3d_down2(x.float(), w, bias.float())
    return apply_activation(y, act, slope=slope).to(out_dtype)


def conv_down2_ndhwc(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    bias: torch.Tensor,
    *,
    act: str = "none",
    slope: float = 0.3,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """act(conv3x3x3(x, w, stride 2, zero padding 1) + bias) on NDHWC
    `x`."""
    if x.device.type == "cpu":
        return conv_down2_ndhwc_plain(x, w_packed, bias, act=act, slope=slope,
                                      out_dtype=out_dtype)
    _check_act(x, "x")
    B, D, H, W, ci = x.shape
    co = _check_common(x, w_packed, bias, ci, (D, H, W), act, "zeros",
                       out_dtype)
    out = torch.empty((B, (D - 1) // 2 + 1, (H - 1) // 2 + 1,
                       (W - 1) // 2 + 1, co), dtype=out_dtype,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn()(
        x.data_ptr(), w_packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
        B, D, H, W, ci, co, EPILOGUE_ACTS[act], float(slope),
        int(out_dtype == torch.float32), stream,
    )
    build.check(rc, "conv_down2_ndhwc")
    conv_down2_ndhwc.launches += 1
    return out


conv_down2_ndhwc.launches = 0
