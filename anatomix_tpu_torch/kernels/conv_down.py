"""Stride-2 3x3x3 conv (zero padding 1) on NDHWC: wrapper, plain version,
counter.

`conv_down2_ndhwc` replaces the JAX package's V2 Pallas kernel
(`anatomix_tpu/ops/pallas/conv_down.py` conv_down2_block), the ViT
tokenizer's downsample convs, with the stride-2 mode of the wgmma conv
kernels of `csrc/conv3d.cu` (`conv3x3x3_down2_ndhwc`): a halo brick whose
halo is stored split by parity, or the gather ring through the stride-2
index map, as `kernels/conv.conv_plan(..., mode=MODE_S2)` picks; that
file's header says what bounds it on the card and what the design does
about it. The TPU kernel reads the space-to-depth block tensor; this one
reads channels-last `(B, D, H, W, Ci)` and writes `(B, (D-1)//2+1, ...,
Co)`.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (f32 `F.conv3d` through `ops/conv.conv3d_down2`).
`.launches` counts kernel launches. Weights are packed `(27 * Ci, Co)` bf16
as for `kernels/conv.py`, the bias f32, accumulation f32, the output bf16
or f32.

`conv_down2_train(x, w, b)` is the differentiable stride-2 conv of the ViT's
pretraining step (the JAX TPU kernel has no VJP; JAX differentiates XLA's
`conv3d(stride=2)`). The forward runs on V2. The backward runs the stride-2
modes of the conv's gradient kernels (`kernels/conv_train.py`, T-w and T-x
with `stride=2`), which read the output gradient on its own grid. The
zero-inserted route is the reference beside them: with `dy_up` the output
gradient zero-inserted onto the input grid (`dy_up[:, ::2, ::2, ::2] =
dy`, zeros elsewhere), the stride-2 pad-1 conv's dW is the zero-padded
"same" conv's dW of `(x, dy_up)` and its dx the zero-padded "same" conv's
dx of `dy_up`; `conv_down2_backward_plain` computes that on the plain
stride-1 functions.
"""

from __future__ import annotations

import ctypes

import torch

from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.kernels.conv import (
    MODE_S2,
    _check_act,
    _check_common,
    conv_plan,
    workspace,
)
from anatomix_tpu_torch.ops.activations import EPILOGUE_ACTS, apply_activation
from anatomix_tpu_torch.kernels import conv_train
from anatomix_tpu_torch.ops.conv import (
    conv3d_down2,
    pack_conv_weight,
    unpack_conv_weight,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fns: dict = {}


def _fn():
    fn = _fns.get("conv3x3x3_down2_ndhwc")
    if fn is None:
        fn = build.load("conv3d").conv3x3x3_down2_ndhwc
        # x, w, bias, out, ws, plan; B, D, H, W, ci, co, act; slope;
        # out_f32, stream
        fn.argtypes = [_P] * 6 + [_I] * 7 + [_F, _I, _P]
        fn.restype = ctypes.c_int
        _fns["conv3x3x3_down2_ndhwc"] = fn
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
    grid = conv_train.s2_grid((D, H, W))
    out = torch.empty((B, *grid, co), dtype=out_dtype, device=x.device)
    plan = conv_plan(B, grid, ci, co, mode=MODE_S2)
    ws = workspace(plan, out.numel() // co, co, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn()(
        x.data_ptr(), w_packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, plan.as_c(),
        B, D, H, W, ci, co, EPILOGUE_ACTS[act], float(slope),
        int(out_dtype == torch.float32), stream,
    )
    build.check(rc, "conv_down2_ndhwc")
    conv_down2_ndhwc.launches += 1
    return out


conv_down2_ndhwc.launches = 0


# -----------------------------------------------------------------------------
# the differentiable stride-2 conv

def zero_insert(dy: torch.Tensor, spatial) -> torch.Tensor:
    """The stride-2 conv's output gradient (B, d, h, w, Co) on its input
    grid `spatial`: dy at even positions, zeros elsewhere."""
    B, d, h, w, co = dy.shape
    up = dy.new_zeros((B, *spatial, co))
    up[:, ::2, ::2, ::2] = dy
    return up


def conv_down2_backward_plain(x, dy, w_packed):
    """`(dx, dW)` of the stride-2 conv through the zero-inserted gradient,
    on the plain stride-1 gradient functions: dx in dy's dtype, dW f32
    packed (27 * Ci, Co)."""
    up = zero_insert(dy, x.shape[1:4])
    return (conv_train.conv3x3x3_dgrad_ndhwc_plain(up, w_packed,
                                                   pad_type="zeros"),
            conv_train.conv3x3x3_wgrad_ndhwc_plain(x, up, pad_type="zeros"))


class _ConvDown2Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, split):
        if split:
            xin, w_in, xs = conv_train.split_operands(x, w)
            w_fwd = pack_conv_weight(w_in).to(torch.bfloat16)
            w_packed = pack_conv_weight(w).to(torch.bfloat16)
        else:
            xin = xs = x
            w_fwd = w_packed = pack_conv_weight(w).to(x.dtype)
        y = conv_down2_ndhwc(xin, w_fwd, b.float().contiguous(),
                             out_dtype=torch.float32)
        ctx.save_for_backward(xs, w_packed)
        ctx.x_dtype = x.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w_packed = ctx.saved_tensors
        # the same route as the stride-1 conv's backward, in stride-2 mode
        dgrad, wgrad = conv_train._route or (
            conv_train.conv3x3x3_dgrad_ndhwc,
            conv_train.conv3x3x3_wgrad_ndhwc)
        g = dy.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = dgrad(g, w_packed, pad_type="zeros", stride=2,
                       spatial=tuple(x.shape[1:4])).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dw = unpack_conv_weight(
                wgrad(x, g, pad_type="zeros", stride=2), x.shape[-1])
        if ctx.needs_input_grad[2]:
            db = dy.float().sum(dim=(0, 1, 2, 3))
        return dx, dw, db, None


def conv_down2_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     split: bool = False) -> torch.Tensor:
    """Differentiable stride-2 3x3x3 conv (zero padding 1) of NDHWC `x` with
    the f32 torch-layout kernel `w` (O, I, 3, 3, 3) and bias `b`: the
    forward on V2 in `x`'s dtype (weights rounded to it), stored in f32
    (an instance norm follows it in the ViT's tokenizer); dx from T-x, dW
    from T-w in their stride-2 modes, dW and db f32. `split` as in
    `conv_train.conv3x3x3_train`: an f32 `x`, the forward through the
    three-term split, the backward on the bf16 roundings."""
    return _ConvDown2Train.apply(x, w, b, split)
