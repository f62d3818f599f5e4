"""Instance norm on NDHWC in two kernels: the statistics folded into an
affine (`norm_stats_ndhwc`), then the apply + activation
(`norm_apply_ndhwc`); wrappers, plain versions, counters.

`norm_apply_ndhwc` replaces the JAX package's D1 Pallas kernel
(`anatomix_tpu/ops/pallas/norm_apply.py` norm_apply_block) with the kernel
of `csrc/norm_apply.cu`, whose header says what bounds it on the card and
what its design does about it. It computes

    y[b, z, y, x, c] = act(x * a[b, tz, ty, tx, c] + s[b, tz, ty, tx, c]
                           [+ r[b, z, y, x, c]]) [+ 0.1 x]

with the tile of each voxel given by three int32 maps (`ops/norms.tile_maps`),
so even and uneven tiles and the global norm (one tile) are one kernel.
The caller computes `(a, s)` from the statistics: on the card with
`norm_stats_ndhwc` (`csrc/norm_apply.cu`, which replaces no Pallas kernel:
the JAX package leaves these reductions to XLA), whose plain version is
`ops/norms.instance_norm_stats` then `ops/norms.fold_affine` (which also
folds an `instance_affine` scale and bias). On the card `x` is
bf16 or f32, the optional residual `r` bf16 (the ViT tokenizer's
`lrelu(IN(conv2(...)) + r)`) and the output bf16. With `split=True` the
output is the three-term split `(..., 3 C)` [hi | lo | hi] of the f32
value (`ops/conv.split3`), the operand form of a conv that reads it as f32,
and a residual is taken in that form too (read as hi + lo). With
`post_res=True` it adds `0.1 x` after the activation: the end of a residual
UNet's block, `act(norm(conv)) + 0.1 conv`, (a, s) the batch norm's running
affine (one tile), the instance norm's, or ones and zeros without a norm.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version. `.launches` counts kernel launches
(`norm_stats_ndhwc`: its calls, each two launches).
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.ops.activations import EPILOGUE_ACTS, apply_activation
from anatomix_tpu_torch.ops.conv import merge3, split3
from anatomix_tpu_torch.ops.norms import (
    expand_tiles,
    fold_affine,
    instance_norm_stats,
    tile_sizes,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fns: dict = {}


# argtypes of each C entry of csrc/norm_apply.cu
_ARGTYPES = {
    # x, x_f32, a, s, zmap, ymap, xmap, residual, out; B, D, H, W, C,
    # t0, t1, t2; act, slope, split, post_res, stream
    "norm_apply_ndhwc": [_P, _I] + [_P] * 7 + [_I] * 8 + [_I, _F, _I, _I, _P],
    # x, x_f32, vec, offs, part, scale, bias, a, s; B, D, H, W, C, t0, t1,
    # t2, nblk; eps, stream
    "norm_stats_ndhwc": [_P, _I, _I] + [_P] * 6 + [_I] * 9 + [_F, _P],
}


def _fn(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("norm_apply"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


# pass-1 blocks to start on each SM; threads a block (csrc/norm_apply.cu
# STATS_THREADS)
_BLOCKS_PER_SM, _STATS_THREADS = 8, 256
_MIN_VOXELS_PER_LANE = 16


def stats_plan(C: int, tiles: int, min_tile_voxels: int, vec_width: int,
               sms: int) -> int:
    """Pass 1's blocks per tile (`nblk`) of `norm_stats_ndhwc` for `tiles`
    (sample, tile) pairs of C channels, the smallest tile `min_tile_voxels`
    voxels, `vec_width` channels a thread (4 f32 or 8 bf16, else 1), on a
    card of `sms` SMs. A block holds min(groups, 256) channel groups, each
    over 256 // that lanes. Every tile takes `nblk` blocks: enough for
    _BLOCKS_PER_SM blocks on each SM in all, but no more than leaves each
    lane _MIN_VOXELS_PER_LANE voxels of the smallest tile."""
    groups = C // vec_width
    per_block = min(groups, _STATS_THREADS)
    lanes = _STATS_THREADS // per_block
    chunks = -(-groups // per_block)
    want = -(-sms * _BLOCKS_PER_SM // (tiles * chunks))
    room = -(-min_tile_voxels // (lanes * _MIN_VOXELS_PER_LANE))
    return max(1, min(want, room))


@functools.lru_cache(maxsize=64)
def _tile_bounds(sizes: tuple, device: torch.device) -> torch.Tensor:
    """int32 [z bounds | y bounds | x bounds] of the tiles of `sizes`."""
    bounds = [e for sz in sizes for e in itertools.accumulate(sz, initial=0)]
    return torch.tensor(bounds, dtype=torch.int32).to(device)


def norm_stats_ndhwc_plain(x, tile_counts=(1, 1, 1), *, eps, scale=None,
                           bias=None):
    """`ops/norms.instance_norm_stats` then `fold_affine`."""
    mean, var = instance_norm_stats(x, tile_counts)
    return fold_affine(mean, var, eps, scale, bias)


def norm_stats_ndhwc(
    x: torch.Tensor,              # (B, D, H, W, C) bf16 or f32
    tile_counts=(1, 1, 1),        # tiles per spatial axis (`tile_sizes`)
    *,
    eps: float,
    scale: torch.Tensor | None = None,  # (C,) f32: instance_affine
    bias: torch.Tensor | None = None,
):
    """f32 `(a, s)`, each (B, t0, t1, t2, C), with `x * a + s` the instance
    norm of `x` per (sample, tile, channel), `scale` and `bias` folded in:
    the `(a, s)` that `norm_apply_ndhwc` takes. The statistics are f32 sums
    of x and x^2 per thread and block, summed across blocks in double, with
    `var = max(E[x^2] - E[x]^2, 0)` as `instance_norm_stats`."""
    if x.device.type == "cpu":
        return norm_stats_ndhwc_plain(x, tile_counts, eps=eps, scale=scale,
                                      bias=bias)
    dev = x.device
    if (x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 5
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous bf16 or f32 (B, D, H, W, "
                         f"C) tensor, got {x.dtype} {tuple(x.shape)}")
    B, D, H, W, C = x.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (C,) or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 ({C},) on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)}")
    sizes = tuple(map(tuple, tile_sizes((D, H, W), tile_counts)))
    t0, t1, t2 = map(len, sizes)
    width = 4 if x.dtype == torch.float32 else 8
    vec = C % width == 0 and x.data_ptr() % 16 == 0
    nblk = stats_plan(C, B * t0 * t1 * t2,
                      min(sizes[0]) * min(sizes[1]) * min(sizes[2]),
                      width if vec else 1,
                      torch.cuda.get_device_properties(dev)
                      .multi_processor_count)
    a = torch.empty((B, t0, t1, t2, C), dtype=torch.float32, device=dev)
    s = torch.empty_like(a)
    part = torch.empty(B * t0 * t1 * t2 * nblk * 2 * C, dtype=torch.float32,
                       device=dev)
    offs = _tile_bounds(sizes, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn("norm_stats_ndhwc")(
        x.data_ptr(), int(x.dtype == torch.float32), int(vec),
        offs.data_ptr(), part.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), a.data_ptr(),
        s.data_ptr(), B, D, H, W, C, t0, t1, t2, nblk, float(eps), stream,
    )
    build.check(rc, "norm_stats_ndhwc")
    norm_stats_ndhwc.launches += 1
    return a, s


norm_stats_ndhwc.launches = 0


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
    rc = _fn("norm_apply_ndhwc")(
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
