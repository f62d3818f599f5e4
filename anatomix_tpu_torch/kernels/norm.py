"""Instance-norm apply + activation on NDHWC: wrapper, plain version,
counter.

`norm_apply_ndhwc` replaces the JAX package's D1 Pallas kernel
(`anatomix_tpu/ops/pallas/norm_apply.py` norm_apply_block) with the kernel
of `csrc/norm_apply.cu`, whose header says what bounds it on the card and
what its design does about it. It computes

    y[b, z, y, x, c] = act(x * a[b, tz, ty, tx, c] + s[b, tz, ty, tx, c]
                           [+ r[b, z, y, x, c]]) [+ 0.1 x]

with the tile of each voxel given by three int32 maps (`ops/norms.tile_maps`),
so even and uneven tiles and the global norm (one tile) are one kernel.
The caller computes `(a, s)` from the statistics (`ops/norms.fold_affine`,
which also folds an `instance_affine` scale and bias). On the card `x` is
bf16 or f32, the optional residual `r` bf16 (the ViT tokenizer's
`lrelu(IN(conv2(...)) + r)`) and the output bf16. With `split=True` the
output is the three-term split `(..., 3 C)` [hi | lo | hi] of the f32
value (`ops/conv.split3`), the operand form of a conv that reads it as f32,
and a residual is taken in that form too (read as hi + lo). With
`post_res=True` it adds `0.1 x` after the activation: the end of a residual
UNet's block, `act(norm(conv)) + 0.1 conv`, (a, s) the batch norm's running
affine (one tile), the instance norm's, or ones and zeros without a norm.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version. `.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.ops.activations import EPILOGUE_ACTS, apply_activation
from anatomix_tpu_torch.ops.conv import merge3, split3
from anatomix_tpu_torch.ops.norms import expand_tiles

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fns: dict = {}


def _fn():
    fn = _fns.get("norm_apply_ndhwc")
    if fn is None:
        fn = build.load("norm_apply").norm_apply_ndhwc
        # x, x_f32, a, s, zmap, ymap, xmap, residual, out; B, D, H, W, C,
        # t0, t1, t2; act, slope, split, post_res, stream
        fn.argtypes = [_P, _I] + [_P] * 7 + [_I] * 8 + [_I, _F, _I, _I, _P]
        fn.restype = ctypes.c_int
        _fns["norm_apply_ndhwc"] = fn
    return fn


def norm_apply_ndhwc_plain(x, a, s, tile_maps, *, act="none", slope=0.3,
                           out_dtype=torch.bfloat16, residual=None,
                           split=False, post_res=False):
    """f32 arithmetic on the same inputs."""
    y = x.float() * expand_tiles(a, tile_maps) + expand_tiles(s, tile_maps)
    if residual is not None:
        y = y + (merge3(residual) if split else residual.float())
    y = apply_activation(y, act, slope=slope)
    if post_res:
        y = y + 0.1 * x.float()
    return split3(y) if split else y.to(out_dtype)


def norm_apply_ndhwc(
    x: torch.Tensor,           # (B, D, H, W, C) bf16 or f32
    a: torch.Tensor,           # (B, t0, t1, t2, C) f32 per-tile scale
    s: torch.Tensor,           # (B, t0, t1, t2, C) f32 per-tile shift
    tile_maps,                 # int32 (D,), (H,), (W,): voxel -> tile
    *,
    act: str = "none",
    slope: float = 0.3,
    out_dtype: torch.dtype = torch.bfloat16,
    residual: torch.Tensor | None = None,  # x's shape, bf16 on the card
    split: bool = False,
    out: torch.Tensor | None = None,
    post_res: bool = False,
) -> torch.Tensor:
    """act(x * a[tile] + s[tile] [+ residual]) [+ 0.1 x with `post_res`]
    per (sample, tile, channel), stored in `out_dtype` (bf16 on the card),
    or with `split` as the bf16 (..., 3 C) [hi | lo | hi] of the f32 value,
    a residual then in that form; written into `out` when given
    (contiguous, of the result's shape and dtype)."""
    if x.device.type == "cpu":
        y = norm_apply_ndhwc_plain(x, a, s, tile_maps, act=act,
                                   slope=slope, out_dtype=out_dtype,
                                   residual=residual, split=split,
                                   post_res=post_res)
        return y if out is None else out.copy_(y)
    dev = x.device
    if (x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 5
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous bf16 or f32 (B, D, H, W, "
                         f"C) tensor, got {x.dtype} {tuple(x.shape)}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the kernel stores bf16, got out_dtype {out_dtype}")
    B, D, H, W, C = x.shape
    out_shape = (B, D, H, W, 3 * C) if split else tuple(x.shape)
    zmap, ymap, xmap = tile_maps
    t0, t1, t2 = a.shape[1:4] if a.dim() == 5 else (-1, -1, -1)
    for t, shape in ((a, (B, t0, t1, t2, C)), (s, (B, t0, t1, t2, C))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"a and s must be contiguous f32 (B, t0, t1, "
                             f"t2, C) on {dev}, got {tuple(t.shape)}")
    for m, n in ((zmap, D), (ymap, H), (xmap, W)):
        if (m.dtype != torch.int32 or tuple(m.shape) != (n,)
                or m.device != dev or not m.is_contiguous()):
            raise ValueError("tile maps must be contiguous int32 (D,), "
                             f"(H,), (W,) on {dev}")
    if act not in EPILOGUE_ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    if residual is not None and (
            residual.dtype != torch.bfloat16
            or tuple(residual.shape) != out_shape
            or residual.device != dev or not residual.is_contiguous()):
        raise ValueError(f"residual must be contiguous bf16 {out_shape} "
                         f"on {dev}, got {residual.dtype} "
                         f"{tuple(residual.shape)}")
    if out is None:
        out = torch.empty(out_shape, dtype=torch.bfloat16, device=dev)
    elif (tuple(out.shape) != out_shape or out.dtype != torch.bfloat16
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous bf16 {out_shape} on "
                         f"{dev}, got {out.dtype} {tuple(out.shape)}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn()(
        x.data_ptr(), int(x.dtype == torch.float32), a.data_ptr(),
        s.data_ptr(), zmap.data_ptr(), ymap.data_ptr(), xmap.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        B, D, H, W, C,
        t0, t1, t2, EPILOGUE_ACTS[act], float(slope), int(split),
        int(post_res), stream,
    )
    build.check(rc, "norm_apply_ndhwc")
    norm_apply_ndhwc.launches += 1
    return out


norm_apply_ndhwc.launches = 0
