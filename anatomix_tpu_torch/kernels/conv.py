"""3x3x3 "same" conv kernels on NDHWC: wrappers, plain versions, counters.

`conv3x3x3_ndhwc` replaces the JAX package's K1 and K2 Pallas kernels
(`anatomix_tpu/ops/pallas/conv_block.py` conv_block_sparse_halo /
_halo_wide / _valid / _valid_wide, `ops/pallas/conv3x3.py` _conv3x3_valid);
`conv3x3x3_upcat_ndhwc` replaces K3 (`conv_block.py` conv_block_skip_halo /
_halo_wide / _valid): the decoder conv over concat(enc, nearest-2x(small));
`conv3x3x3_cat_ndhwc` replaces D3 (`conv_block.py`
conv_block_sparse_cat_halo / _halo_wide): the trilinear decoder's conv over
concat(enc, up) with both operands at one resolution. All three launch the
implicit-GEMM wgmma kernels of `csrc/conv3d.cu` (a halo brick and a gather
ring), whose header says what bounds them on the card and what their
designs do about it; so does V2, the stride-2 conv of `kernels/conv_down.py`
(a parity-split halo brick or the gather ring in its stride-2 mode).
`conv_plan` is their launch plan (which kernel, tile, N tile, split of K),
a pure function of the shapes, passed to C with every launch.

On a CUDA tensor a wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version (f32 `F.conv3d` through `ops/conv.py`). Each wrapper
counts its kernel launches in `.launches`.

Weights are packed `(27 * Ci, Co)` bf16 (`ops/conv.pack_conv_weight`), the
bias is f32, the input bf16, accumulation f32, and the output bf16 or f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.ops.activations import EPILOGUE_ACTS, apply_activation
from anatomix_tpu_torch.ops.conv import conv3d_same, unpack_conv_weight
from anatomix_tpu_torch.ops.resize import upsample2x

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w, bias, out, ws, plan; B, D, H, W, ci, co, reflect, act; slope;
    # out_f32, stream
    "conv3x3x3_ndhwc": [_P] * 6 + [_I] * 8 + [_F, _I, _P],
    # enc, small/up, w, bias, out, ws, plan; B, D, H, W, c1, c2, co,
    # reflect, act; slope; out_f32, stream
    "conv3x3x3_upcat_ndhwc": [_P] * 7 + [_I] * 9 + [_F, _I, _P],
    "conv3x3x3_cat_ndhwc": [_P] * 7 + [_I] * 9 + [_F, _I, _P],
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
# the launch plan of csrc/conv3d.cu

NUM_SMS = 132            # H100 SXM
TILE_M = 128             # output voxels per tile (two warpgroups x m64)
STEP_K = 64              # K rows per ring stage
RING_STAGES = 4          # the gather kernel's ring depth (`ConvPlan.stages`)
SMEM_PER_SM = 227 * 1024
BRICK_HALO = 10 * 10 * 6  # the halo of an 8 x 8 x 4 output tile
BRICK_HALO_S2 = 9 * 9 * 5  # the gradient an 8 x 8 x 4 tile of it reads
BRICK_HALO_S2F = 17 * 17 * 9  # the input an 8 x 8 x 4 stride-2 tile reads
S2F_CHUNK = 8             # the stride-2 brick's K chunk: one 16-byte voxel
S2F_STEPS = 14            # its K16 steps a chunk: 27 taps in pairs
BRICK_SMEM = 100 * 1024   # at most: 2 blocks per SM
BRICK_MIN_CHUNK = 16      # a wide conv's K chunk in the halo brick, at least
# what a launch computes (the C side's `ConvArgs.mode`)
MODE_S1 = 0               # the stride-1 conv
MODE_S2_DGRAD = 1         # the stride-2 conv's input gradient
MODE_S2 = 2               # the stride-2 conv (V2)


class ConvPlan(NamedTuple):
    """How `csrc/conv3d.cu` cuts one launch: the N tile `bn`; the M tile as
    a brick of 2^bx x 2^by x 2^bz voxels of the tiled grid times 2^bb batch
    items (bx + by + bz + bb = 7: 128 rows); the tiles per axis; the N
    tiles; and the split of the K steps over `splits` blocks of
    `steps_per_split` steps each, through a ring of `stages` stages.
    `brick` 1 selects the halo-brick kernel (an 8 x 8 x 4 tile; bx, by, bz
    = 3, 3, 2), which walks K in `chunk`-channel chunks. The order of the
    fields is the C side's `PlanField`."""
    bn: int
    bx: int
    by: int
    bz: int
    bb: int
    tiles_x: int
    tiles_y: int
    tiles_z: int
    tiles_b: int
    n_tiles: int
    splits: int
    steps_per_split: int
    brick: int = 0
    stages: int = RING_STAGES
    chunk: int = 0

    @property
    def m_tiles(self) -> int:
        return self.tiles_x * self.tiles_y * self.tiles_z * self.tiles_b

    def as_c(self):
        return (ctypes.c_int * len(self))(*self)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _log2ceil(n: int) -> int:
    return max(0, (n - 1).bit_length())


def n_tile(co: int) -> int:
    """The N tile for `co` output columns: the smallest of 16, 32, 64 that
    holds them, else 128."""
    for bn in (16, 32, 64):
        if co <= bn:
            return bn
    return 128


def brick_bits(B: int, grid, total: int) -> tuple[int, int, int, int]:
    """log2 extents (x, y, z, batch) of a tile of 2^total voxels over a
    (B, gz, gy, gx) grid: up to 8 x 4 x 4 first (a compact brick, for the
    taps' re-reads), then the rest of each axis in turn, then the batch,
    which takes whatever bits are left (masked where it runs out)."""
    gz, gy, gx = grid
    ext = [_log2ceil(gx), _log2ceil(gy), _log2ceil(gz)]
    bits, left = [0, 0, 0], total
    for i, cap in enumerate((3, 2, 2)):
        bits[i] = min(cap, ext[i], left)
        left -= bits[i]
    for i in range(3):
        more = min(ext[i] - bits[i], left)
        bits[i] += more
        left -= more
    return bits[0], bits[1], bits[2], left


def conv_plan(B: int, grid, ci: int, co: int, *,
              mode: int = MODE_S1) -> ConvPlan:
    """The launch plan of `csrc/conv3d.cu` for a conv of Ci -> `co`
    channels whose tiled grid is `grid` = (gz, gy, gx) with batch `B`, by
    `mode`: `MODE_S1` a stride-1 conv (K = 27 taps x Ci, Ci padded to a
    multiple of 8); `MODE_S2` the stride-2 conv (V2), tiled over its output
    grid, K the same; `MODE_S2_DGRAD` the stride-2 conv's input gradient,
    tiled over the gradient's grid, whose 8 parity classes of 1-8 taps are
    never split. The halo-brick kernels take the convs `brick_chunk` gives a
    chunk.
    Otherwise, where the tiles leave SMs idle (fewer blocks than
    `NUM_SMS`), K is split over as many blocks as fill every SM once, at
    least 4 steps each."""
    bn = n_tile(co)
    gz, gy, gx = grid
    chunk = brick_chunk(B, grid, ci, bn, mode)
    if chunk:
        return ConvPlan(bn, 3, 3, 2, 0, _cdiv(gx, 8), _cdiv(gy, 8),
                        _cdiv(gz, 4), B, _cdiv(co, bn), 1, 0, 1, 0, chunk)
    bx, by, bz, bb = brick_bits(B, grid, 7)
    tiles = (_cdiv(gx, 1 << bx), _cdiv(gy, 1 << by), _cdiv(gz, 1 << bz),
             _cdiv(B, 1 << bb))
    n_tiles = _cdiv(co, bn)
    steps = _cdiv((8 if mode == MODE_S2_DGRAD else 27) * _cdiv(ci, 8) * 8,
                  STEP_K)
    blocks = tiles[0] * tiles[1] * tiles[2] * tiles[3] * n_tiles
    splits, stages = 1, RING_STAGES
    if mode != MODE_S2_DGRAD and blocks < NUM_SMS:
        # a split grid of N tile 128 runs a 3-stage ring: 96 KB, two blocks
        # per SM, so the split fills the card with twice the blocks
        stages = 3 if bn == 128 else RING_STAGES
        stage = TILE_M * STEP_K * 2 + STEP_K * bn * 2
        per_sm = max(1, SMEM_PER_SM // (stages * stage))
        splits = max(1, min(NUM_SMS * per_sm // blocks, steps // 4))
    per_split = _cdiv(steps, splits)
    return ConvPlan(bn, bx, by, bz, bb, *tiles, n_tiles,
                    _cdiv(steps, per_split), per_split, 0, stages)


def brick_chunk(B: int, grid, ci: int, bn: int, mode: int = MODE_S1) -> int:
    """The K chunk (channels, a multiple of 16 dividing Ci padded to 16) of
    the halo-brick kernel for this conv, or 0 where the gather kernel runs
    it. The brick takes N tiles up to 64. A narrow conv (Ci padded to 16 at
    most 64) takes it in one chunk where its halo and weights fit
    `BRICK_SMEM` (the stride-2 gradient's smaller halo: twice that, one
    block per SM); a wider one in the largest chunk of at least
    `BRICK_MIN_CHUNK` channels that fits, where its tiles fill the card.
    The stride-2 conv's parity-split brick walks Ci padded to 8 in chunks
    of `S2F_CHUNK` through two buffers, where its tiles fill the card."""
    if bn > 64:
        return 0
    gz, gy, gx = grid
    tiles = _cdiv(gx, 8) * _cdiv(gy, 8) * _cdiv(gz, 4) * B
    if mode == MODE_S2:
        # two chunk buffers and the halo's source map: one block per SM
        fits = (2 * (BRICK_HALO_S2F * 16 + S2F_STEPS * 16 * bn * 2)
                + BRICK_HALO_S2F * 4 <= SMEM_PER_SM)
        return S2F_CHUNK if fits and tiles >= NUM_SMS else 0
    cp16 = _cdiv(ci, 16) * 16
    if mode == MODE_S2_DGRAD:
        fits = 2 * cp16 * (BRICK_HALO_S2 + 27 * bn) <= 2 * BRICK_SMEM
        return cp16 if cp16 <= 64 and fits else 0
    for chunk in range(min(cp16, 64), 15, -16):
        if cp16 % chunk or 2 * chunk * (BRICK_HALO + 27 * bn) > BRICK_SMEM:
            continue
        if chunk == cp16:
            return chunk
        return chunk if (chunk >= BRICK_MIN_CHUNK
                         and tiles >= NUM_SMS) else 0
    return 0


def workspace(plan: ConvPlan, n_out: int, co: int, device):
    """The f32 split-K partials (splits, n_out, co) of a split plan, or
    None."""
    if plan.splits == 1:
        return None
    return torch.empty((plan.splits, n_out, co), dtype=torch.float32,
                       device=device)


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
    plan = conv_plan(B, (D, H, W), ci, co)
    ws = workspace(plan, B * D * H * W, co, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn("conv3x3x3_ndhwc")(
        x.data_ptr(), w_packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, plan.as_c(),
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
    plan = conv_plan(B, (D, H, W), c1 + c2, co)
    ws = workspace(plan, B * D * H * W, co, small.device)
    stream = torch.cuda.current_stream(small.device).cuda_stream
    rc = _fn("conv3x3x3_upcat_ndhwc")(
        enc.data_ptr() if enc is not None else None, small.data_ptr(),
        w_packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, plan.as_c(),
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
    plan = conv_plan(B, (D, H, W), c1 + c2, co)
    ws = workspace(plan, B * D * H * W, co, up.device)
    stream = torch.cuda.current_stream(up.device).cuda_stream
    rc = _fn("conv3x3x3_cat_ndhwc")(
        enc.data_ptr(), up.data_ptr(), w_packed.data_ptr(), bias.data_ptr(),
        out.data_ptr(), ws.data_ptr() if ws is not None else None,
        plan.as_c(), B, D, H, W, c1, c2, co, int(pad_type == "reflect"),
        EPILOGUE_ACTS[act], float(slope), int(out_dtype == torch.float32),
        stream,
    )
    build.check(rc, "conv3x3x3_cat_ndhwc")
    conv3x3x3_cat_ndhwc.launches += 1
    return out


conv3x3x3_cat_ndhwc.launches = 0
