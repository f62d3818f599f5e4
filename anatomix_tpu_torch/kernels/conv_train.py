"""The backward of the 3x3x3 "same" conv on NDHWC: the weight-gradient and
input-gradient kernels, their plain versions, their counters, and the
differentiable conv of the pretraining step.

`conv3x3x3_wgrad_ndhwc` replaces the JAX package's T-w Pallas kernels
(`anatomix_tpu/ops/pallas/conv_block_train.py` _wgrad_halo_wide,
_wgrad_halo, _wgrad) with the kernel of `csrc/conv3d_wgrad.cu`;
`conv3x3x3_dgrad_ndhwc` replaces T-x (`anatomix_tpu/ops/pallas/
conv_block.py` conv_block_sparse_dx, with the pad adjoint its caller takes
in `conv_block_train.py`) with the transposed conv and pad-adjoint kernels
of `csrc/conv3d.cu`. The sources' headers say what bounds each on the card
and what its design does about it.

`conv3x3x3_train(x, w, b, pad_type)` is the counterpart of
`conv_block_sparse_train` (`conv_block_train.py`): forward on K1
(`conv3x3x3_ndhwc`, act `none`, output in the input's dtype), dx on the
dgrad kernel, dW on the wgrad kernel, db as the f32 sum of dy.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs its plain version (f32 arithmetic, rounded where the kernel rounds).
Each wrapper counts its launches in `.launches`. Layouts: activations and
gradients `(B, D, H, W, C)`, bf16 on the card; packed weights `(27 * Ci,
Co)` (`ops/conv.pack_conv_weight`); dW f32 in the packed layout.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.kernels.conv import conv3x3x3_ndhwc
from anatomix_tpu_torch.ops.conv import (
    pack_conv_weight,
    split3,
    split3_weight,
    unpack_conv_weight,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, dy, dw; B, D, H, W, ci, co, reflect; stream
    "conv3x3x3_wgrad_ndhwc": ("conv3d_wgrad", [_P] * 3 + [_I] * 7 + [_P]),
    # dy, w_t, zero_bias, g_ext, dx; B, D, H, W, co, ci, reflect; stream
    "conv3x3x3_dgrad_ndhwc": ("conv3d", [_P] * 5 + [_I] * 7 + [_P]),
}
_fns: dict = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _pad_mode(pad_type: str) -> str:
    if pad_type not in ("reflect", "zeros"):
        raise ValueError(f"unsupported pad_type {pad_type!r}")
    return "reflect" if pad_type == "reflect" else "constant"


def flip_transpose_packed(w_packed: torch.Tensor, ci: int) -> torch.Tensor:
    """Packed (27 * Ci, Co) weights of a conv -> the packed (27 * Co, Ci)
    weights of its transposed conv (taps reversed, I and O swapped)."""
    co = w_packed.shape[1]
    w = w_packed.reshape(3, 3, 3, ci, co).flip((0, 1, 2)).transpose(3, 4)
    return w.reshape(27 * co, ci).contiguous()


# -----------------------------------------------------------------------------
# plain versions (f32 arithmetic on the same inputs)

def conv3x3x3_wgrad_ndhwc_plain(x, dy, *, pad_type="reflect"):
    """dW (27 * Ci, Co) f32: for each tap, the shifted padded input against
    dy, summed over batch and space."""
    B, D, H, W, ci = x.shape
    co = dy.shape[-1]
    xp = F.pad(x.float().permute(0, 4, 1, 2, 3), (1,) * 6,
               mode=_pad_mode(pad_type)).permute(0, 2, 3, 4, 1)
    g = dy.float().reshape(-1, co)
    rows = []
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                xs = xp[:, kd:kd + D, kh:kh + H, kw:kw + W].reshape(-1, ci)
                rows.append(xs.t() @ g)
    return torch.cat(rows, dim=0)


def _reflect_pad_adjoint(g: torch.Tensor) -> torch.Tensor:
    """Adjoint of a reflect pad of 1 on axes 1-3 of (B, S+2, ..., C): the
    interior, plus each halo face added onto the voxel it mirrors."""
    for ax in (1, 2, 3):
        n = g.shape[ax] - 2
        out = g.narrow(ax, 1, n).clone()
        out.narrow(ax, 1, 1).add_(g.narrow(ax, 0, 1))
        out.narrow(ax, n - 2, 1).add_(g.narrow(ax, n + 1, 1))
        g = out
    return g


def conv3x3x3_dgrad_ndhwc_plain(dy, w_packed, *, pad_type="reflect",
                                out_dtype=None):
    """dx (B, D, H, W, Ci) of the conv: the transposed conv over the (S+2)^3
    grid of the padded input (dy zero outside the volume), then the pad's
    adjoint. Returned in `out_dtype` (default dy's)."""
    _pad_mode(pad_type)
    B, D, H, W, co = dy.shape
    ci = w_packed.shape[0] // 27
    w = w_packed.float().reshape(27, ci, co)
    dyp = F.pad(dy.float(), (0, 0, 2, 2, 2, 2, 2, 2))
    g = None
    for t in range(27):
        kd, kh, kw = t // 9, (t // 3) % 3, t % 3
        sl = dyp[:, 2 - kd:4 - kd + D, 2 - kh:4 - kh + H, 2 - kw:4 - kw + W]
        term = sl @ w[t].t()
        g = term if g is None else g + term
    if pad_type == "reflect":
        dx = _reflect_pad_adjoint(g)
    else:
        dx = g[:, 1:D + 1, 1:H + 1, 1:W + 1]
    return dx.contiguous().to(out_dtype or dy.dtype)


# -----------------------------------------------------------------------------
# kernel wrappers

def _check_bf16_cuda(t, name):
    if t.device.type != "cuda" or t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be a bf16 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() != 5 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (B, D, H, W, C) tensor")


def _check_extents(spatial, pad_type):
    _pad_mode(pad_type)
    if min(spatial) < (2 if pad_type == "reflect" else 1):
        raise ValueError(f"extents {spatial} too small for {pad_type} "
                         "padding")


def conv3x3x3_wgrad_ndhwc(
    x: torch.Tensor, dy: torch.Tensor, *, pad_type: str = "reflect",
) -> torch.Tensor:
    """dW (27 * Ci, Co) f32, packed as `kernels/conv.py` packs weights, of
    the "same" conv of `x` (B, D, H, W, Ci) given its output gradient `dy`
    (B, D, H, W, Co)."""
    if x.device.type == "cpu":
        return conv3x3x3_wgrad_ndhwc_plain(x, dy, pad_type=pad_type)
    _check_bf16_cuda(x, "x")
    _check_bf16_cuda(dy, "dy")
    if dy.device != x.device or dy.shape[:4] != x.shape[:4]:
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} must "
                         "share (B, D, H, W) and a device")
    B, D, H, W, ci = x.shape
    co = dy.shape[4]
    _check_extents((D, H, W), pad_type)
    dw = torch.zeros((27 * ci, co), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn("conv3x3x3_wgrad_ndhwc")(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(), B, D, H, W, ci, co,
        int(pad_type == "reflect"), stream,
    )
    build.check(rc, "conv3x3x3_wgrad_ndhwc")
    conv3x3x3_wgrad_ndhwc.launches += 1
    return dw


conv3x3x3_wgrad_ndhwc.launches = 0


def conv3x3x3_dgrad_ndhwc(
    dy: torch.Tensor, w_packed: torch.Tensor, *, pad_type: str = "reflect",
) -> torch.Tensor:
    """dx (B, D, H, W, Ci) of the "same" conv with packed weights `w_packed`
    (27 * Ci, Co), given its output gradient `dy` (B, D, H, W, Co); bf16 on
    the card."""
    if dy.device.type == "cpu":
        return conv3x3x3_dgrad_ndhwc_plain(dy, w_packed, pad_type=pad_type)
    _check_bf16_cuda(dy, "dy")
    B, D, H, W, co = dy.shape
    if (w_packed.dim() != 2 or w_packed.shape[0] % 27
            or w_packed.shape[1] != co or w_packed.dtype != torch.bfloat16
            or w_packed.device != dy.device):
        raise ValueError(f"packed weights must be bf16 (27*Ci, {co}) on "
                         f"{dy.device}; got {tuple(w_packed.shape)} "
                         f"{w_packed.dtype}")
    _check_extents((D, H, W), pad_type)
    ci = w_packed.shape[0] // 27
    w_t = flip_transpose_packed(w_packed, ci)
    zero_bias = torch.zeros((ci,), dtype=torch.float32, device=dy.device)
    dx = torch.empty((B, D, H, W, ci), dtype=torch.bfloat16, device=dy.device)
    reflect = pad_type == "reflect"
    g_ext = (torch.empty((B, D + 2, H + 2, W + 2, ci), dtype=torch.float32,
                         device=dy.device) if reflect else None)
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    rc = _fn("conv3x3x3_dgrad_ndhwc")(
        dy.data_ptr(), w_t.data_ptr(), zero_bias.data_ptr(),
        g_ext.data_ptr() if reflect else None, dx.data_ptr(), B, D, H, W,
        co, ci, int(reflect), stream,
    )
    build.check(rc, "conv3x3x3_dgrad_ndhwc")
    conv3x3x3_dgrad_ndhwc.launches += 1
    return dx


conv3x3x3_dgrad_ndhwc.launches = 0


# -----------------------------------------------------------------------------
# the differentiable conv

# (dgrad, wgrad) that `conv3x3x3_train`'s backward calls instead of the
# wrappers, inside `backward_route` only
_route = None


@contextlib.contextmanager
def backward_route(dgrad, wgrad):
    """Within the block, `conv3x3x3_train`'s backward calls
    `dgrad(dy, w_packed, pad_type=...)` and `wgrad(x, dy, pad_type=...)` in
    place of `conv3x3x3_dgrad_ndhwc` and `conv3x3x3_wgrad_ndhwc`. A check
    uses it to record what the step's backward launched (functions that
    call the wrappers, whose counts go on as ever) or to run the step's
    backward on the plain versions from the same forward."""
    global _route
    saved, _route = _route, (dgrad, wgrad)
    try:
        yield
    finally:
        _route = saved


def split_operands(x, w):
    """The forward operands of a conv that reads f32 `x` and `w` through
    the three-term split (`ops/conv.split3`): ([hi | lo | hi] of x bf16,
    [w_hi; w_hi; w_lo] f32), and the bf16 `x_hi` its backward reads."""
    xin = split3(x)
    return xin, split3_weight(w), xin[..., :x.shape[-1]].contiguous()


class _Conv3x3x3Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, pad_type, out_dtype, split):
        ci = x.shape[-1]
        bias = (b.float().contiguous() if b is not None else
                torch.zeros((w.shape[0],), dtype=torch.float32,
                            device=x.device))
        if split:
            xin, w_in, xs = split_operands(x, w)
            w_fwd = pack_conv_weight(w_in).to(torch.bfloat16)
            w_packed = pack_conv_weight(w).to(torch.bfloat16)
        else:
            xin = xs = x
            w_fwd = w_packed = pack_conv_weight(w).to(x.dtype)
        y = conv3x3x3_ndhwc(xin, w_fwd, bias, act="none", pad_type=pad_type,
                            out_dtype=out_dtype)
        ctx.save_for_backward(xs, w_packed)
        ctx.pad_type = pad_type
        ctx.ci = ci
        ctx.x_dtype = x.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w_packed = ctx.saved_tensors
        dgrad, wgrad = _route or (conv3x3x3_dgrad_ndhwc,
                                  conv3x3x3_wgrad_ndhwc)
        dy = dy.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = dgrad(dy, w_packed, pad_type=ctx.pad_type).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dw_packed = wgrad(x, dy, pad_type=ctx.pad_type)
            dw = unpack_conv_weight(dw_packed, ctx.ci)
        if ctx.needs_input_grad[2]:
            db = dy.float().sum(dim=(0, 1, 2, 3))
        return dx, dw, db, None, None, None


def conv3x3x3_train(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    pad_type: str = "reflect",
    out_dtype: torch.dtype | None = None,
    split: bool = False,
) -> torch.Tensor:
    """Differentiable 3x3x3 "same" conv of NDHWC `x` with the f32 torch-layout
    kernel `w` (O, I, 3, 3, 3) and optional bias: the forward in `x`'s dtype
    (weights rounded to it), stored in `out_dtype` (default `x`'s),
    gradients from the dgrad and wgrad kernels (the output gradient rounded
    to `x`'s dtype), dW and db in f32. With `split`, `x` is f32 and the
    forward reads `x` and `w` through the bf16 three-term split
    (`ops/conv.split3`, f32 to about 2^-16), while the backward runs on
    their bf16 roundings, as without it; dx is f32."""
    return _Conv3x3x3Train.apply(x, w, b, pad_type, out_dtype or x.dtype,
                                 split)
