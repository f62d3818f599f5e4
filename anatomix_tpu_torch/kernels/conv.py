"""3x3x3 "same" conv kernels on NDHWC: wrappers, plain versions, counters.

`conv3x3x3_ndhwc` replaces the JAX package's K1 and K2 Pallas kernels
(`anatomix_tpu/ops/pallas/conv_block.py` conv_block_sparse_halo /
_halo_wide / _valid / _valid_wide, `ops/pallas/conv3x3.py` _conv3x3_valid);
`conv3x3x3_upcat_ndhwc` replaces K3 (`conv_block.py` conv_block_skip_halo /
_halo_wide / _valid): the decoder conv over concat(enc, nearest-2x(small));
`conv3x3x3_cat_ndhwc` replaces D3 (`conv_block.py`
conv_block_sparse_cat_halo / _halo_wide): the trilinear decoder's conv over
concat(enc, up) with both operands at one resolution. All three launch the
one implicit-GEMM kernel of `csrc/conv3d.cu`, whose header says what bounds
it on the card and what its design does about it.

On a CUDA tensor a wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version (f32 `F.conv3d` through `ops/conv.py`). Each wrapper
counts its kernel launches in `.launches`.

Weights are packed `(27 * Ci, Co)` bf16 (`ops/conv.pack_conv_weight`), the
bias is f32, the input bf16, accumulation f32, and the output bf16 or f32.
"""

from __future__ import annotations

import ctypes

import torch

from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.ops.activations import EPILOGUE_ACTS, apply_activation
from anatomix_tpu_torch.ops.conv import conv3d_same, unpack_conv_weight
from anatomix_tpu_torch.ops.resize import upsample2x

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "conv3x3x3_ndhwc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                        _I, _P],
    "conv3x3x3_upcat_ndhwc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _F, _I, _P],
    "conv3x3x3_cat_ndhwc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _I, _P],
}
_fns: dict = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("conv3d"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


# -----------------------------------------------------------------------------
# plain versions (f32 arithmetic on the same inputs)

def conv3x3x3_ndhwc_plain(
    x, w_packed, bias, *, act="none", slope=0.3, pad_type="reflect",
    out_dtype=torch.bfloat16,
):
    w = unpack_conv_weight(w_packed.float(), x.shape[-1])
    y = conv3d_same(x.float(), w, bias.float(), pad_type=pad_type)
    return apply_activation(y, act, slope=slope).to(out_dtype)


def conv3x3x3_upcat_ndhwc_plain(
    enc, small, w_packed, bias, *, act="none", slope=0.3,
    pad_type="reflect", out_dtype=torch.bfloat16,
):
    up = upsample2x(small.float())
    x = up if enc is None else torch.cat([enc.float(), up], dim=-1)
    return conv3x3x3_ndhwc_plain(
        x, w_packed, bias, act=act, slope=slope, pad_type=pad_type,
        out_dtype=out_dtype,
    )


def conv3x3x3_cat_ndhwc_plain(
    enc, up, w_packed, bias, *, act="none", slope=0.3, pad_type="reflect",
    out_dtype=torch.bfloat16,
):
    x = torch.cat([enc.float(), up.float()], dim=-1)
    return conv3x3x3_ndhwc_plain(
        x, w_packed, bias, act=act, slope=slope, pad_type=pad_type,
        out_dtype=out_dtype,
    )


# -----------------------------------------------------------------------------
# kernel wrappers

def _check_common(ref, w_packed, bias, ci, spatial, act, pad_type, out_dtype):
    dev = ref.device
    co = w_packed.shape[-1] if w_packed.dim() == 2 else -1
    if w_packed.shape != (27 * ci, co) or w_packed.dtype != torch.bfloat16:
        raise ValueError(
            f"packed weights must be bf16 (27*{ci}, Co); got "
            f"{tuple(w_packed.shape)} {w_packed.dtype}"
        )
    if bias.shape != (co,) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be f32 ({co},); got {tuple(bias.shape)}")
    for t in (w_packed, bias):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"weights and bias must be contiguous on {dev}")
    if act not in EPILOGUE_ACTS:
        raise ValueError(f"unsupported epilogue activation {act!r}")
    if pad_type not in ("reflect", "zeros"):
        raise ValueError(f"unsupported pad_type {pad_type!r}")
    if pad_type == "reflect" and min(spatial) < 2:
        raise ValueError(f"reflect padding needs extents >= 2, got {spatial}")
    if min(spatial) < 1:
        raise ValueError(f"empty volume {spatial}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    return co


def _check_act(t, name):
    if t.device.type != "cuda" or t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be a bf16 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() != 5 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (B, D, H, W, C) tensor")


def conv3x3x3_ndhwc(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    bias: torch.Tensor,
    *,
    act: str = "none",
    slope: float = 0.3,
    pad_type: str = "reflect",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """act(conv3x3x3_same(x, w) + bias) on NDHWC `x`."""
    if x.device.type == "cpu":
        return conv3x3x3_ndhwc_plain(
            x, w_packed, bias, act=act, slope=slope, pad_type=pad_type,
            out_dtype=out_dtype,
        )
    _check_act(x, "x")
    B, D, H, W, ci = x.shape
    co = _check_common(x, w_packed, bias, ci, (D, H, W), act, pad_type,
                       out_dtype)
    out = torch.empty((B, D, H, W, co), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn("conv3x3x3_ndhwc")(
        x.data_ptr(), w_packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
        B, D, H, W, ci, co, int(pad_type == "reflect"), EPILOGUE_ACTS[act],
        float(slope), int(out_dtype == torch.float32), stream,
    )
    build.check(rc, "conv3x3x3_ndhwc")
    conv3x3x3_ndhwc.launches += 1
    return out


conv3x3x3_ndhwc.launches = 0


def conv3x3x3_upcat_ndhwc(
    enc: torch.Tensor | None,
    small: torch.Tensor,
    w_packed: torch.Tensor,
    bias: torch.Tensor,
    *,
    act: str = "none",
    slope: float = 0.3,
    pad_type: str = "reflect",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """act(conv3x3x3_same(cat([enc, upsample2x_nearest(small)])) + bias):
    input channels [0, c1) from `enc` (B, D, H, W, c1), [c1, c1 + c2) from
    `small` (B, D/2, H/2, W/2, c2); `enc=None` convolves the upsampled
    tensor alone."""
    if small.device.type == "cpu":
        return conv3x3x3_upcat_ndhwc_plain(
            enc, small, w_packed, bias, act=act, slope=slope,
            pad_type=pad_type, out_dtype=out_dtype,
        )
    _check_act(small, "small")
    B, Ds, Hs, Ws, c2 = small.shape
    D, H, W = 2 * Ds, 2 * Hs, 2 * Ws
    c1 = 0
    if enc is not None:
        _check_act(enc, "enc")
        if enc.device != small.device or enc.shape[:4] != (B, D, H, W):
            raise ValueError(
                f"enc {tuple(enc.shape)} must be (B, 2*d, 2*h, 2*w, c1) of "
                f"small {tuple(small.shape)}, on one device"
            )
        c1 = enc.shape[4]
    co = _check_common(small, w_packed, bias, c1 + c2, (D, H, W), act,
                       pad_type, out_dtype)
    out = torch.empty((B, D, H, W, co), dtype=out_dtype, device=small.device)
    stream = torch.cuda.current_stream(small.device).cuda_stream
    rc = _fn("conv3x3x3_upcat_ndhwc")(
        enc.data_ptr() if enc is not None else None, small.data_ptr(),
        w_packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
        B, D, H, W, c1, c2, co, int(pad_type == "reflect"),
        EPILOGUE_ACTS[act], float(slope), int(out_dtype == torch.float32),
        stream,
    )
    build.check(rc, "conv3x3x3_upcat_ndhwc")
    conv3x3x3_upcat_ndhwc.launches += 1
    return out


conv3x3x3_upcat_ndhwc.launches = 0


def conv3x3x3_cat_ndhwc(
    enc: torch.Tensor,
    up: torch.Tensor,
    w_packed: torch.Tensor,
    bias: torch.Tensor,
    *,
    act: str = "none",
    slope: float = 0.3,
    pad_type: str = "reflect",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """act(conv3x3x3_same(cat([enc, up])) + bias): input channels [0, c1)
    from `enc` (B, D, H, W, c1), [c1, c1 + c2) from `up` (B, D, H, W, c2).
    Packed weights are `(27 * (c1 + c2), Co)` in that concat order."""
    if up.device.type == "cpu":
        return conv3x3x3_cat_ndhwc_plain(
            enc, up, w_packed, bias, act=act, slope=slope, pad_type=pad_type,
            out_dtype=out_dtype,
        )
    _check_act(enc, "enc")
    _check_act(up, "up")
    if enc.device != up.device or enc.shape[:4] != up.shape[:4]:
        raise ValueError(
            f"enc {tuple(enc.shape)} and up {tuple(up.shape)} must share "
            "(B, D, H, W) and a device"
        )
    B, D, H, W, c1 = enc.shape
    c2 = up.shape[4]
    co = _check_common(up, w_packed, bias, c1 + c2, (D, H, W), act,
                       pad_type, out_dtype)
    out = torch.empty((B, D, H, W, co), dtype=out_dtype, device=up.device)
    stream = torch.cuda.current_stream(up.device).cuda_stream
    rc = _fn("conv3x3x3_cat_ndhwc")(
        enc.data_ptr(), up.data_ptr(), w_packed.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, D, H, W, c1, c2, co, int(pad_type == "reflect"),
        EPILOGUE_ACTS[act], float(slope), int(out_dtype == torch.float32),
        stream,
    )
    build.check(rc, "conv3x3x3_cat_ndhwc")
    conv3x3x3_cat_ndhwc.launches += 1
    return out


conv3x3x3_cat_ndhwc.launches = 0
