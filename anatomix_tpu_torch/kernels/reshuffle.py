"""The layout permutations of the port: wrappers, plain versions, counters.

`depth_to_space8_ndhwc` replaces the JAX package's V1 Pallas kernel
(`anatomix_tpu/ops/pallas/reshuffle.py` depth_to_space8, its `emit=
"spatial"` form with the optional f32 subtract) with the kernel of
`csrc/depth_to_space8.cu`, whose header says what bounds it on the card and
what its design does about it. Input `(B, d, h, w, 512 * C)` bf16 with the
channel order `(a1, a2, a3, c)` of the three stacked transposed-conv GEMMs,
`a_i = z_i * 4 + y_i * 2 + x_i`; output f32 `(B, 8d, 8h, 8w, C)` at
`D = 8 dz + 4 z1 + 2 z2 + z3` (likewise H, W), minus `sub[b, channel]`
where `sub` (B, 512 * C) f32 is given.

`space_to_depth2_ndhwc` and `depth_to_space2_ndhwc` replace the L Pallas
kernels `space_to_depth` and `depth_to_space` of the same JAX file with
the kernels of `csrc/reshuffle.cu`: `(B, 2d, 2h, 2w, C)` <-> the block
layout `(B, d, h, w, 8 C)`, channel `((ad * 2 + ah) * 2 + aw) * C + c`
holding voxel `(2 i + ad, 2 j + ah, 2 k + aw)`, for any 2- or 4-byte dtype
and any C (the ViT decoder's odd 99 and 49 included).

Three more kernels of `csrc/reshuffle.cu` replace the rest of that file's
layout kernels, the exits and the entry of the ViT's stage-wise decoder and
v1 tokenizer:
- `depth_to_space_interleave_ndhwc` (`depth_to_space_interleave`): the
  block layout, bf16 or f32, to `(B, 2d, 2h, 2w, C)` in `out_dtype`, minus
  `sub` `(B, 8 C)` f32 per lane (the demean mean, tiled 8 times) in f32,
  rounded once;
- `depth_to_space_fold_ndhwc` (`depth_to_space_fold`): the same values as
  the folded rows `(B, 2d, 2h, 2w C / 128, 128)` the TPU's stitch reads,
  which on this card are a view of the channels-last bytes; bf16 out by
  default, as the JAX stage path emits;
- `space_to_depth_c1_ndhwc` (`space_to_depth_c1`): a channel-less
  `(B, 2d, 2h, 2w)` volume to `(B, d, h, w, 8)`, lane `(ad * 2 + ah) * 2 +
  aw`, any 2- or 4-byte dtype.
`space_to_depth2` and `depth_to_space2` are their differentiable forms: the
backward of each is the other, as in the JAX package's
`space_to_depth_vjp` / `depth_to_space_vjp`. The pretraining step's train
walk goes through them at the max pool and the nearest upsample
(`models/unet_train_block.py`).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version (a reshape and a permute). `.launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from anatomix_tpu_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns: dict = {}


_SIGNATURES = {
    # y, sub, out; B, d, h, w, C; stream
    "depth_to_space8_ndhwc": ("depth_to_space8", [_P] * 3 + [_I] * 5 + [_P]),
    # in, out; B, d, h, w, C, element bytes; stream
    "space_to_depth2_ndhwc": ("reshuffle", [_P] * 2 + [_I] * 6 + [_P]),
    "depth_to_space2_ndhwc": ("reshuffle", [_P] * 2 + [_I] * 6 + [_P]),
    # yb, sub, out; B, d, h, w, C, in_f32, out_f32; stream
    "depth_to_space_interleave_ndhwc": ("reshuffle",
                                        [_P] * 3 + [_I] * 7 + [_P]),
    "depth_to_space_fold_ndhwc": ("reshuffle", [_P] * 3 + [_I] * 7 + [_P]),
    # x, out; B, d, h, w, element bytes; stream
    "space_to_depth_c1_ndhwc": ("reshuffle", [_P] * 2 + [_I] * 5 + [_P]),
}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def depth_to_space8_ndhwc_plain(y, sub=None):
    """f32 arithmetic on the same inputs."""
    B, d, h, w, c512 = y.shape
    C = c512 // 512
    t = y.float()
    if sub is not None:
        t = t - sub.float()[:, None, None, None, :]
    # (z1, y1, x1, z2, y2, x2, z3, y3, x3, c) -> interleave each bit with
    # its coarse axis, coarsest bit first
    t = t.reshape(B, d, h, w, 2, 2, 2, 2, 2, 2, 2, 2, 2, C)
    t = t.permute(0, 1, 4, 7, 10, 2, 5, 8, 11, 3, 6, 9, 12, 13)
    return t.reshape(B, 8 * d, 8 * h, 8 * w, C)


def depth_to_space8_ndhwc(
    y: torch.Tensor,                 # (B, d, h, w, 512 * C) bf16
    sub: torch.Tensor | None = None,  # (B, 512 * C) f32
) -> torch.Tensor:
    """(B, d, h, w, 512 C) -> (B, 8d, 8h, 8w, C) f32, minus `sub`."""
    if y.device.type == "cpu":
        return depth_to_space8_ndhwc_plain(y, sub)
    if (y.dtype != torch.bfloat16 or y.dim() != 5 or y.shape[-1] % 512
            or not y.is_contiguous()):
        raise ValueError(f"y must be a contiguous bf16 (B, d, h, w, 512*C) "
                         f"tensor, got {y.dtype} {tuple(y.shape)}")
    B, d, h, w, c512 = y.shape
    if sub is not None and (
            sub.dtype != torch.float32 or tuple(sub.shape) != (B, c512)
            or sub.device != y.device or not sub.is_contiguous()):
        raise ValueError(f"sub must be contiguous f32 {(B, c512)} on "
                         f"{y.device}, got {sub.dtype} {tuple(sub.shape)}")
    C = c512 // 512
    out = torch.empty((B, 8 * d, 8 * h, 8 * w, C), dtype=torch.float32,
                      device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = _fn("depth_to_space8_ndhwc")(
        y.data_ptr(), None if sub is None else sub.data_ptr(),
        out.data_ptr(), B, d, h, w, C, stream)
    build.check(rc, "depth_to_space8_ndhwc")
    depth_to_space8_ndhwc.launches += 1
    return out


depth_to_space8_ndhwc.launches = 0


# -----------------------------------------------------------------------------
# factor-2 space-to-depth and depth-to-space (the block layout)

def space_to_depth2_ndhwc_plain(x):
    """(B, 2d, 2h, 2w, C) -> (B, d, h, w, 8 C), by reshape and permute."""
    B, D, H, W, C = x.shape
    t = x.reshape(B, D // 2, 2, H // 2, 2, W // 2, 2, C)
    t = t.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return t.reshape(B, D // 2, H // 2, W // 2, 8 * C).contiguous()


def depth_to_space2_ndhwc_plain(xb):
    """(B, d, h, w, 8 C) -> (B, 2d, 2h, 2w, C), by reshape and permute."""
    B, d, h, w, c8 = xb.shape
    t = xb.reshape(B, d, h, w, 2, 2, 2, c8 // 8)
    t = t.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return t.reshape(B, 2 * d, 2 * h, 2 * w, c8 // 8).contiguous()


def _check_reshuffle(t, name):
    if t.dim() != 5 or not t.is_contiguous() or t.element_size() not in (
            2, 4):
        raise ValueError(f"{name} must be a contiguous (B, D, H, W, C) tensor "
                         f"of 2- or 4-byte elements, got {t.dtype} "
                         f"{tuple(t.shape)}")


def space_to_depth2_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, 2d, 2h, 2w, C) -> the block layout (B, d, h, w, 8 C)."""
    if x.device.type == "cpu":
        return space_to_depth2_ndhwc_plain(x)
    _check_reshuffle(x, "x")
    B, D, H, W, C = x.shape
    if D % 2 or H % 2 or W % 2:
        raise ValueError(f"extents {(D, H, W)} must be even")
    out = torch.empty((B, D // 2, H // 2, W // 2, 8 * C), dtype=x.dtype,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn("space_to_depth2_ndhwc")(
        x.data_ptr(), out.data_ptr(), B, D // 2, H // 2, W // 2, C,
        x.element_size(), stream)
    build.check(rc, "space_to_depth2_ndhwc")
    space_to_depth2_ndhwc.launches += 1
    return out


space_to_depth2_ndhwc.launches = 0


def depth_to_space2_ndhwc(xb: torch.Tensor) -> torch.Tensor:
    """The block layout (B, d, h, w, 8 C) -> (B, 2d, 2h, 2w, C)."""
    if xb.device.type == "cpu":
        return depth_to_space2_ndhwc_plain(xb)
    _check_reshuffle(xb, "xb")
    B, d, h, w, c8 = xb.shape
    if c8 % 8:
        raise ValueError(f"channels {c8} must be a multiple of 8")
    out = torch.empty((B, 2 * d, 2 * h, 2 * w, c8 // 8), dtype=xb.dtype,
                      device=xb.device)
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    rc = _fn("depth_to_space2_ndhwc")(
        xb.data_ptr(), out.data_ptr(), B, d, h, w, c8 // 8,
        xb.element_size(), stream)
    build.check(rc, "depth_to_space2_ndhwc")
    depth_to_space2_ndhwc.launches += 1
    return out


depth_to_space2_ndhwc.launches = 0


class _SpaceToDepth2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return space_to_depth2_ndhwc(x)

    @staticmethod
    def backward(ctx, g):
        return depth_to_space2_ndhwc(g.contiguous())


class _DepthToSpace2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xb):
        return depth_to_space2_ndhwc(xb)

    @staticmethod
    def backward(ctx, g):
        return space_to_depth2_ndhwc(g.contiguous())


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """Differentiable `space_to_depth2_ndhwc`; its backward is
    `depth_to_space2_ndhwc`."""
    return _SpaceToDepth2.apply(x)


def depth_to_space2(xb: torch.Tensor) -> torch.Tensor:
    """Differentiable `depth_to_space2_ndhwc`; its backward is
    `space_to_depth2_ndhwc`."""
    return _DepthToSpace2.apply(xb)


# -----------------------------------------------------------------------------
# the ViT's stage-wise exits and its v1 tokenizer's channel-less entry

_SUB_DTYPES = (torch.bfloat16, torch.float32)


def depth_to_space_sub_plain(yb, sub=None, out_dtype=torch.float32):
    """(B, d, h, w, 8 C) -> (B, 2d, 2h, 2w, C) in `out_dtype`: f32
    arithmetic (the subtract of `sub` (B, 8 C) f32 per lane), rounded once."""
    t = yb.float()
    if sub is not None:
        t = t - sub.float()[:, None, None, None, :]
    return depth_to_space2_ndhwc_plain(t).to(out_dtype)


def fold_rows(vol: torch.Tensor) -> torch.Tensor:
    """A contiguous (B, D, H, W, C) volume as the folded rows (B, D, H,
    W C / 128, 128): the same bytes, no copy."""
    B, D, H, W, C = vol.shape
    if (W * C) % 128:
        raise ValueError(f"folded rows need W * C a multiple of 128, got "
                         f"W={W}, C={C}")
    return vol.view(B, D, H, W * C // 128, 128)


def fold_supported(C: int, w: int) -> bool:
    """The TPU fold kernel's envelope (`reshuffle.fold_supported`): the
    folded row of 2 C lanes packs whole 128-lane rows."""
    g = 128 // (2 * C) if 2 * C <= 128 and 128 % (2 * C) == 0 else 0
    return g > 0 and w % g == 0


def depth_to_space_interleave_ndhwc_plain(yb, sub=None,
                                          out_dtype=torch.float32):
    return depth_to_space_sub_plain(yb, sub, out_dtype)


def depth_to_space_fold_ndhwc_plain(yb, sub=None, out_dtype=torch.bfloat16):
    return fold_rows(depth_to_space_sub_plain(yb, sub, out_dtype))


def _launch_d2s_sub(name, yb, sub, out_dtype):
    if (yb.dim() != 5 or yb.dtype not in _SUB_DTYPES or yb.shape[-1] % 8
            or not yb.is_contiguous()):
        raise ValueError(f"{name}: yb must be a contiguous bf16 or f32 "
                         f"(B, d, h, w, 8*C) tensor, got {yb.dtype} "
                         f"{tuple(yb.shape)}")
    if out_dtype not in _SUB_DTYPES:
        raise ValueError(f"{name}: out_dtype must be bf16 or f32, got "
                         f"{out_dtype}")
    B, d, h, w, c8 = yb.shape
    if sub is not None and (
            sub.dtype != torch.float32 or tuple(sub.shape) != (B, c8)
            or sub.device != yb.device or not sub.is_contiguous()):
        raise ValueError(f"{name}: sub must be contiguous f32 {(B, c8)} on "
                         f"{yb.device}, got {sub.dtype} {tuple(sub.shape)}")
    out = torch.empty((B, 2 * d, 2 * h, 2 * w, c8 // 8), dtype=out_dtype,
                      device=yb.device)
    stream = torch.cuda.current_stream(yb.device).cuda_stream
    rc = _fn(name)(
        yb.data_ptr(), None if sub is None else sub.data_ptr(),
        out.data_ptr(), B, d, h, w, c8 // 8,
        int(yb.dtype == torch.float32), int(out_dtype == torch.float32),
        stream)
    build.check(rc, name)
    return out


def depth_to_space_interleave_ndhwc(
    yb: torch.Tensor,                 # (B, d, h, w, 8 C) bf16 or f32
    sub: torch.Tensor | None = None,  # (B, 8 C) f32
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, d, h, w, 8 C) -> (B, 2d, 2h, 2w, C) in `out_dtype`, minus `sub`
    in f32."""
    if yb.device.type == "cpu":
        return depth_to_space_interleave_ndhwc_plain(yb, sub, out_dtype)
    out = _launch_d2s_sub("depth_to_space_interleave_ndhwc", yb, sub,
                          out_dtype)
    depth_to_space_interleave_ndhwc.launches += 1
    return out


depth_to_space_interleave_ndhwc.launches = 0


def depth_to_space_fold_ndhwc(
    yb: torch.Tensor,                 # (B, d, h, w, 8 C) bf16 or f32
    sub: torch.Tensor | None = None,  # (B, 8 C) f32
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, d, h, w, 8 C) -> the folded rows (B, 2d, 2h, 2w C / 128, 128) in
    `out_dtype`, minus `sub` in f32; inside `fold_supported` only."""
    B, d, h, w, c8 = yb.shape
    if not fold_supported(c8 // 8, w):
        raise ValueError(f"fold unsupported for C={c8 // 8}, w={w}")
    if yb.device.type == "cpu":
        return depth_to_space_fold_ndhwc_plain(yb, sub, out_dtype)
    out = _launch_d2s_sub("depth_to_space_fold_ndhwc", yb, sub, out_dtype)
    depth_to_space_fold_ndhwc.launches += 1
    return fold_rows(out)


depth_to_space_fold_ndhwc.launches = 0


def space_to_depth_c1_ndhwc_plain(x4):
    """(B, 2d, 2h, 2w) -> (B, d, h, w, 8), by reshape and permute."""
    B, D, H, W = x4.shape
    t = x4.reshape(B, D // 2, 2, H // 2, 2, W // 2, 2)
    t = t.permute(0, 1, 3, 5, 2, 4, 6)
    return t.reshape(B, D // 2, H // 2, W // 2, 8).contiguous()


def space_to_depth_c1_ndhwc(x4: torch.Tensor) -> torch.Tensor:
    """A channel-less (B, 2d, 2h, 2w) volume -> the block layout (B, d, h,
    w, 8)."""
    if x4.device.type == "cpu":
        return space_to_depth_c1_ndhwc_plain(x4)
    if x4.dim() != 4 or not x4.is_contiguous() or x4.element_size() not in (
            2, 4):
        raise ValueError(f"x4 must be a contiguous (B, D, H, W) tensor of 2- "
                         f"or 4-byte elements, got {x4.dtype} "
                         f"{tuple(x4.shape)}")
    B, D, H, W = x4.shape
    if D % 2 or H % 2 or W % 2:
        raise ValueError(f"extents {(D, H, W)} must be even")
    out = torch.empty((B, D // 2, H // 2, W // 2, 8), dtype=x4.dtype,
                      device=x4.device)
    stream = torch.cuda.current_stream(x4.device).cuda_stream
    rc = _fn("space_to_depth_c1_ndhwc")(
        x4.data_ptr(), out.data_ptr(), B, D // 2, H // 2, W // 2,
        x4.element_size(), stream)
    build.check(rc, "space_to_depth_c1_ndhwc")
    space_to_depth_c1_ndhwc.launches += 1
    return out


space_to_depth_c1_ndhwc.launches = 0
