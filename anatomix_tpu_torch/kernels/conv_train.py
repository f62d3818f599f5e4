"""The backward of the 3x3x3 "same" conv on NDHWC: the weight-gradient and
input-gradient kernels, their plain versions, their counters, and the
differentiable conv of the pretraining step.

`conv3x3x3_wgrad_ndhwc` replaces the JAX package's T-w Pallas kernels
(`anatomix_tpu/ops/pallas/conv_block_train.py` _wgrad_halo_wide,
_wgrad_halo, _wgrad) with the kernel of `csrc/conv3d_wgrad.cu`;
`conv3x3x3_dgrad_ndhwc` replaces T-x (`anatomix_tpu/ops/pallas/
conv_block.py` conv_block_sparse_dx, with the pad adjoint its caller takes
in `conv_block_train.py`) with the transposed conv of `csrc/conv3d.cu`;
under reflect, replicate or circular padding its store is split
(`pad_dgrad_store`: every voxel off the shell straight into dx, the shell's
sources into a scratch) and the shell pass `pad_shell_ndhwc` sums the rest.
The sources' headers say what bounds each on the card and what its design
does about it. With `stride=2` both run the stride-2
pad-1 conv's gradients (the ViT tokenizer's down convs) from its output
gradient on its own grid, with no zeros inserted; their plain versions,
`conv3x3x3_wgrad_s2_ndhwc_plain` and `conv3x3x3_dgrad_s2_ndhwc_plain`,
follow the strided formulas. `wgrad_plan` is the wgrad kernel's launch
plan, a pure function of the shapes, passed to C with every launch.

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
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.kernels.conv import (
    MODE_S2_DGRAD,
    NUM_SMS,
    RING_STAGES,
    SMEM_PER_SM,
    STEP_K,
    TILE_M,
    _cdiv,
    brick_bits,
    check_pad_extents,
    conv3x3x3_ndhwc,
    conv_plan,
    n_tile,
    pad_code,
    workspace,
)
from anatomix_tpu_torch.ops.conv import (
    pack_conv_weight,
    pad_axes,
    pad_modes,
    split3,
    split3_weight,
    unpack_conv_weight,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, dy, dw, ws, plan; B, D, H, W, ci, co, pad, stride; stream
    "conv3x3x3_wgrad_ndhwc": ("conv3d_wgrad", [_P] * 5 + [_I] * 8 + [_P]),
    # dy, w_t, zero_bias, g_ext, dx, ws, plan; B, D, H, W, co, ci, pad;
    # stream
    "conv3x3x3_dgrad_ndhwc": ("conv3d", [_P] * 7 + [_I] * 7 + [_P]),
    # dy, w_t, zero_bias, dx, plan; B, d, h, w, D, H, W, co, ci; stream
    "conv3x3x3_dgrad_s2_ndhwc": ("conv3d", [_P] * 5 + [_I] * 9 + [_P]),
    # g_ext, dx; B, D, H, W, C, pad; stream
    "pad_shell_ndhwc": ("conv3d", [_P] * 2 + [_I] * 6 + [_P]),
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


def flip_transpose_packed(w_packed: torch.Tensor, ci: int) -> torch.Tensor:
    """Packed (27 * Ci, Co) weights of a conv -> the packed (27 * Co, Ci)
    weights of its transposed conv (taps reversed, I and O swapped), in one
    gather."""
    co = w_packed.shape[1]
    w = w_packed.reshape(27, ci, co).transpose(1, 2)
    return torch.index_select(w, 0, _reversed_taps(w_packed.device)).reshape(
        27 * co, ci)


@functools.lru_cache(maxsize=None)
def _reversed_taps(device) -> torch.Tensor:
    return torch.arange(26, -1, -1, device=device)


def transpose_packed(w_packed: torch.Tensor, ci: int) -> torch.Tensor:
    """Packed (27 * Ci, Co) weights -> (27 * Co, Ci), row tap * Co + co:
    each tap's matrix transposed, the taps in their order."""
    co = w_packed.shape[1]
    return w_packed.reshape(27, ci, co).transpose(1, 2).reshape(
        27 * co, ci).contiguous()


def s2_grid(spatial) -> tuple[int, int, int]:
    """The output grid of the stride-2 pad-1 conv of a `spatial` input."""
    return tuple((n - 1) // 2 + 1 for n in spatial)


class WgradPlan(NamedTuple):
    """How `csrc/conv3d_wgrad.cu` cuts one launch: the N tile `bn`; the
    64-position brick of dy's grid as 2^bx x 2^by x 2^bz positions times
    2^bb batch items (bx + by + bz + bb = 6); the bricks per axis; the
    128-row tiles of dW's 27 * Ci (Ci padded to a multiple of 8) rows and
    its N tiles; and the split of the bricks over `splits` blocks of
    `bricks_per_split` each. `halo` 1 selects the halo-brick kernel: one
    block holds all of dW's rows (`m_tiles` then counts 64-row tiles) for
    bricks of 8 x 4 x 4 positions (bx, by, bz = 3, 2, 2). The order of the
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
    m_tiles: int
    n_tiles: int
    splits: int
    bricks_per_split: int
    halo: int = 0

    @property
    def n_bricks(self) -> int:
        return self.tiles_x * self.tiles_y * self.tiles_z * self.tiles_b

    def as_c(self):
        return (ctypes.c_int * len(self))(*self)


# the longest run of 64-position bricks one block of the gather ring
# reduces in its wgmma accumulator: that f32 accumulation's error grows
# with the run. On the dev step's 128^3 convs, runs of 5462 and 1772
# bricks read 1.6e-3 and 6e-4 of max |dW| from the plain version (NVIDIA
# H100); the 6M and ViT paths' runs, up to 1024 bricks (the 6M
# segmentation step's 64^3 96 -> 32 at batch 3), stay under 5.5e-4.
# Longer grids take more splits, summed in split order by the reduce
# kernel; no plan of the 6M and ViT paths reaches the cap.
WGRAD_MAX_RUN = 1024


def wgrad_plan(B: int, grid, ci: int, co: int, stride: int = 1
               ) -> WgradPlan:
    """The launch plan of `csrc/conv3d_wgrad.cu` for dy's (B, gz, gy, gx)
    grid: the positions are split over as many blocks as fill every SM
    once (each dW tile's blocks reduce disjoint runs of bricks, at least 4
    each), whatever the grid's size, and into runs of at most
    `WGRAD_MAX_RUN` bricks. A narrow stride-1 conv (each warpgroup's share
    of dW's 64-row tiles at most 11 at Co <= 16, 4 at Co <= 32) takes the
    halo-brick kernel."""
    bn = n_tile(co)
    gz, gy, gx = grid
    cp = _cdiv(ci, 8) * 8
    m64 = _cdiv(27 * cp, 64)
    if stride == 1 and _cdiv(m64, 2) <= {16: 11, 32: 4}.get(bn, 0):
        tiles = (_cdiv(gx, 8), _cdiv(gy, 4), _cdiv(gz, 4), B)
        n_bricks = tiles[0] * tiles[1] * tiles[2] * tiles[3]
        n_tiles = _cdiv(co, bn)
        stage = cp // 8 * 360 * 16 + 128 * bn * 2
        per_sm = max(1, SMEM_PER_SM // (RING_STAGES * stage))
        splits = max(1, min(NUM_SMS * per_sm // n_tiles, n_bricks // 4))
        per_split = _cdiv(n_bricks, splits)
        return WgradPlan(bn, 3, 2, 2, 0, *tiles, m64, n_tiles,
                         _cdiv(n_bricks, per_split), per_split, 1)
    bx, by, bz, bb = brick_bits(B, grid, 6)
    tiles = (_cdiv(gx, 1 << bx), _cdiv(gy, 1 << by), _cdiv(gz, 1 << bz),
             _cdiv(B, 1 << bb))
    n_bricks = tiles[0] * tiles[1] * tiles[2] * tiles[3]
    m_tiles = _cdiv(27 * cp, TILE_M)
    n_tiles = _cdiv(co, bn)
    stage = TILE_M * STEP_K * 2 + STEP_K * bn * 2
    per_sm = max(1, SMEM_PER_SM // (RING_STAGES * stage))
    splits = max(1, min(NUM_SMS * per_sm // (m_tiles * n_tiles),
                        n_bricks // 4), _cdiv(n_bricks, WGRAD_MAX_RUN))
    per_split = _cdiv(n_bricks, splits)
    return WgradPlan(bn, bx, by, bz, bb, *tiles, m_tiles, n_tiles,
                     _cdiv(n_bricks, per_split), per_split)


def wgrad_workspace(plan: WgradPlan, ci: int, co: int, device):
    """The f32 per-split partials (splits, 27 * Ci, Co) of a plan of more
    than one split, which the reduce kernel sums in split order, or None
    (one split stores straight into dW)."""
    if plan.splits == 1:
        return None
    return torch.empty((plan.splits, 27 * ci, co), dtype=torch.float32,
                       device=device)


# -----------------------------------------------------------------------------
# plain versions (f32 arithmetic on the same inputs)

def conv3x3x3_wgrad_ndhwc_plain(x, dy, *, pad_type="reflect", stride=1):
    """dW (27 * Ci, Co) f32: for each tap, the shifted padded input against
    dy, summed over batch and space (`stride` 2: the stride-2 conv's,
    `conv3x3x3_wgrad_s2_ndhwc_plain`)."""
    if stride == 2:
        _check_s2_pad(pad_type)
        return conv3x3x3_wgrad_s2_ndhwc_plain(x, dy)
    B, D, H, W, ci = x.shape
    co = dy.shape[-1]
    xp = pad_axes(x.float().permute(0, 4, 1, 2, 3), ((1, 1),) * 3,
                  pad_type).permute(0, 2, 3, 4, 1)
    g = dy.float().reshape(-1, co)
    rows = []
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                xs = xp[:, kd:kd + D, kh:kh + H, kw:kw + W].reshape(-1, ci)
                rows.append(xs.t() @ g)
    return torch.cat(rows, dim=0)


def _check_s2_pad(pad_type):
    if pad_type != "zeros":
        raise ValueError("the stride-2 conv pads with zeros, got "
                         f"{pad_type!r}")


def conv3x3x3_wgrad_s2_ndhwc_plain(x, dy):
    """dW (27 * Ci, Co) f32 of the stride-2 pad-1 conv of `x` (B, D, H, W,
    Ci) given its output gradient `dy` (B, d, h, w, Co), d = (D + 1) // 2:
    dW[tap * Ci + c, co] = sum over (b, o) of x_zpad[b, 2 o + tap - 1, c]
    * dy[b, o, co], each tap's input read at stride 2."""
    ci, co = x.shape[-1], dy.shape[-1]
    d, h, w = dy.shape[1:4]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    g = dy.float().reshape(-1, co)
    rows = []
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                xs = xp[:, kd:kd + 2 * d - 1:2, kh:kh + 2 * h - 1:2,
                        kw:kw + 2 * w - 1:2].reshape(-1, ci)
                rows.append(xs.t() @ g)
    return torch.cat(rows, dim=0)


def conv3x3x3_dgrad_s2_ndhwc_plain(dy, w_packed, spatial, *, out_dtype=None):
    """dx (B, D, H, W, Ci) of the stride-2 pad-1 conv with packed weights
    `w_packed` (27 * Ci, Co) on a `spatial` = (D, H, W) input, from its
    output gradient `dy` (B, d, h, w, Co): each tap adds dy @ w_tap^T at the
    input positions 2 o + tap - 1 it was read from (on each axis an even
    position takes tap 1, an odd one taps 0 and 2). Returned in
    `out_dtype` (default dy's)."""
    B, d, h, w, co = dy.shape
    D, H, W = spatial
    ci = w_packed.shape[0] // 27
    wt = w_packed.float().reshape(27, ci, co)
    g = dy.new_zeros((B, D + 2, H + 2, W + 2, ci), dtype=torch.float32)
    dyf = dy.float()
    for t in range(27):
        kd, kh, kw = t // 9, (t // 3) % 3, t % 3
        g[:, kd:kd + 2 * d - 1:2, kh:kh + 2 * h - 1:2,
          kw:kw + 2 * w - 1:2] += dyf @ wt[t].t()
    return g[:, 1:D + 1, 1:H + 1, 1:W + 1].contiguous().to(
        out_dtype or dy.dtype)


def face_targets(n: int, mode: str) -> tuple[int, int] | None:
    """The indices of an n-extent axis that its halo faces 0 and n + 1 are
    added onto by the adjoint of a pad of 1 (`csrc/conv3d.cu` face_lo,
    face_hi): reflect (1, n - 2), replicate (0, n - 1), circular (n - 1,
    0); None for zeros, whose faces drop."""
    return {"reflect": (1, n - 2), "replicate": (0, n - 1),
            "circular": (n - 1, 0)}.get(mode)


def _pad_adjoint(g: torch.Tensor, pad_type) -> torch.Tensor:
    """Adjoint of a pad of 1 on axes 1-3 of (B, S+2, ..., C) by each
    axis's mode: the interior, plus face 0 and then face S + 1 added onto
    the voxels they were read from (`face_targets`), axis D first."""
    for ax, mode in zip((1, 2, 3), pad_modes(pad_type)):
        n = g.shape[ax] - 2
        out = g.narrow(ax, 1, n).clone()
        faces = face_targets(n, mode)
        if faces is not None:
            out.narrow(ax, faces[0], 1).add_(g.narrow(ax, 0, 1))
            out.narrow(ax, faces[1], 1).add_(g.narrow(ax, n + 1, 1))
        g = out
    return g


# The pad adjoint as the kernels split it. Along an axis of extent S,
# dx[i] = g[i + 1] (+ g[0] if i == lo) (+ g[S + 1] if i == hi), (lo, hi)
# the face targets of the axis's mode: only dx voxels with some axis index
# in {lo, hi} (the shell) sum more than one extended-grid voxel, and those
# sources (some axis coordinate a face, or one past a shell index: the
# shell sources) reach no other dx voxel. The split store writes every
# other extended voxel e straight into dx[e - 1] and the shell sources into
# the scratch g_ext; the shell pass sums each shell voxel's sources in
# `_pad_adjoint`'s order, so the route gives its bits. A zeros axis (a
# lifted 1-D or 2-D net's) has no shell, and its faces go to g_ext unread.

def pad_sources(i: int, n: int, mode: str) -> list[int]:
    """The extended-grid indices whose gradient lands on index i of an
    n-extent axis padded by `mode`, in the order `_pad_adjoint` adds them
    (`csrc/conv3d.cu` pad_sources): i + 1, then 0 if face 0 lands on i,
    then n + 1 if face n + 1 does."""
    faces = face_targets(n, mode) or (None, None)
    return [i + 1] + [0] * (i == faces[0]) + [n + 1] * (i == faces[1])


def _axis_shell(n: int, mode: str) -> tuple[list[int], list[int]]:
    """The shell indices of an axis (where its faces land), sorted, and
    the others."""
    shell = sorted(set(face_targets(n, mode) or ()))
    return shell, [i for i in range(n) if i not in shell]


@functools.lru_cache(maxsize=64)
def pad_shell_voxels(D: int, H: int, W: int, pad_type="reflect"
                     ) -> torch.Tensor:
    """(N, 3) long: the (z, y, x) of every dx voxel with some axis index in
    its axis's shell, in the shell kernel's item order: the (z, y) rows
    that lie in the shell whole (z in the z shell, then y in the y shell),
    x fastest, then the x shell's voxels of the other rows."""
    mz, my, mx = pad_modes(pad_type)
    (zs, zo), (ys, yo), (xs, _) = (_axis_shell(D, mz), _axis_shell(H, my),
                                   _axis_shell(W, mx))
    rows = [(z, y) for z in zs for y in range(H)]
    rows += [(z, y) for z in zo for y in ys]
    vox = [(z, y, x) for z, y in rows for x in range(W)]
    vox += [(z, y, x) for z in zo for y in yo for x in xs]
    return torch.tensor(vox, dtype=torch.long).reshape(-1, 3)


def shell_source_mask(D: int, H: int, W: int, pad_type="reflect",
                      device=None) -> torch.Tensor:
    """(D+2, H+2, W+2) bool: the extended-grid voxels with some axis
    coordinate a face or one past a shell index, the shell's sources."""
    def axis(n, mode):
        m = torch.zeros(n + 2, dtype=torch.bool, device=device)
        m[[0, n + 1] + [i + 1 for i in _axis_shell(n, mode)[0]]] = True
        return m
    mz, my, mx = (axis(n, m) for n, m in zip((D, H, W), pad_modes(pad_type)))
    return mz[:, None, None] | my[None, :, None] | mx[None, None, :]


def pad_split_store_plain(g: torch.Tensor, pad_type="reflect"):
    """The split store of the extended-grid result `g` (B, S+2, ..., C):
    (dx, g_ext) f32, dx (B, D, H, W, C) holding g[e] at e - 1 for every
    extended voxel e that is no shell source, g_ext holding g at the shell
    sources. What the kernel does not write is NaN here, so a read of it
    shows."""
    B, D2, H2, W2, C = g.shape
    src = shell_source_mask(D2 - 2, H2 - 2, W2 - 2, pad_type,
                            g.device)[..., None]
    nan = torch.tensor(float("nan"), device=g.device)
    g = g.float()
    g_ext = torch.where(src, g, nan)
    dx = torch.where(src[1:-1, 1:-1, 1:-1], nan, g[:, 1:-1, 1:-1, 1:-1])
    return dx, g_ext


def _shell_sources(idx: torch.Tensor, n: int, mode: str):
    """Per voxel index on an n-extent axis, its 3 source slots as
    `csrc/conv3d.cu` pad_sources fills them, and which are in use."""
    lo, hi = face_targets(n, mode) or (-1, -1)
    first = idx == lo
    s = torch.stack([idx + 1, torch.where(first, 0, n + 1),
                     torch.full_like(idx, n + 1)], dim=1)
    count = 1 + first.long() + (idx == hi).long()
    return s, torch.arange(3, device=idx.device) < count[:, None]


def pad_shell_plain(g_ext: torch.Tensor, dx: torch.Tensor,
                    pad_type="reflect") -> torch.Tensor:
    """The shell pass on (B, D+2, H+2, W+2, C) `g_ext`: every dx (B, D, H,
    W, C) voxel with some axis index in its shell becomes the f32 sum of
    its sources (z innermost, then y, then x, as `_pad_adjoint` adds
    them), in dx's dtype; in place, no other voxel written. Reads g_ext at
    the shell sources only."""
    B, D, H, W, C = dx.shape
    v = pad_shell_voxels(D, H, W, pad_type).to(g_ext.device)
    if not len(v):
        return dx
    (sz, vz), (sy, vy), (sx, vx) = (
        _shell_sources(v[:, a], n, m) for a, (n, m) in enumerate(
            zip((D, H, W), pad_modes(pad_type))))
    g = g_ext.float()
    acc = None
    for k in range(3):
        ay = None
        for j in range(3):
            az = None
            for i in range(3):
                t = g[:, sz[:, i], sy[:, j], sx[:, k]]
                az = t if az is None else torch.where(vz[:, i, None],
                                                      az + t, az)
            ay = az if ay is None else torch.where(vy[:, j, None], ay + az,
                                                   ay)
        acc = ay if acc is None else torch.where(vx[:, k, None], acc + ay,
                                                 acc)
    dx[:, v[:, 0], v[:, 1], v[:, 2]] = acc.to(dx.dtype)
    return dx


def pad_adjoint_split(g: torch.Tensor, pad_type="reflect") -> torch.Tensor:
    """`_pad_adjoint` as the kernels run it: the split store, then the
    shell pass (f32, the same bits)."""
    dx, g_ext = pad_split_store_plain(g, pad_type)
    return pad_shell_plain(g_ext, dx, pad_type)


def _transposed_conv_ext(dy, w_packed):
    """The transposed conv of dy (B, D, H, W, Co) with packed weights
    (27 * Ci, Co) over the (S+2)^3 grid of the padded input (dy zero
    outside the volume), f32."""
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
    return g


def conv3x3x3_dgrad_ndhwc_plain(dy, w_packed, *, pad_type="reflect",
                                out_dtype=None, stride=1, spatial=None):
    """dx (B, D, H, W, Ci) of the conv: the transposed conv over the (S+2)^3
    grid of the padded input (dy zero outside the volume), then the pad's
    adjoint. Returned in `out_dtype` (default dy's). `stride` 2: the
    stride-2 conv's on a `spatial` input
    (`conv3x3x3_dgrad_s2_ndhwc_plain`)."""
    if stride == 2:
        _check_s2_pad(pad_type)
        return conv3x3x3_dgrad_s2_ndhwc_plain(dy, w_packed, spatial,
                                              out_dtype=out_dtype)
    g = _transposed_conv_ext(dy, w_packed)
    return _pad_adjoint(g, pad_type).contiguous().to(out_dtype or dy.dtype)


# -----------------------------------------------------------------------------
# kernel wrappers

def _check_bf16_cuda(t, name):
    if t.device.type != "cuda" or t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be a bf16 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() != 5 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (B, D, H, W, C) tensor")


def conv3x3x3_wgrad_ndhwc(
    x: torch.Tensor, dy: torch.Tensor, *, pad_type: str = "reflect",
    stride: int = 1,
) -> torch.Tensor:
    """dW (27 * Ci, Co) f32, packed as `kernels/conv.py` packs weights, of
    the "same" conv of `x` (B, D, H, W, Ci) given its output gradient `dy`
    (B, D, H, W, Co); with `stride` 2, of the stride-2 pad-1 conv given its
    output gradient on its own grid (B, (D+1)//2, (H+1)//2, (W+1)//2, Co)
    (`pad_type` "zeros")."""
    if x.device.type == "cpu":
        return conv3x3x3_wgrad_ndhwc_plain(x, dy, pad_type=pad_type,
                                           stride=stride)
    _check_bf16_cuda(x, "x")
    _check_bf16_cuda(dy, "dy")
    B, D, H, W, ci = x.shape
    if stride == 2:
        _check_s2_pad(pad_type)
        grid = s2_grid((D, H, W))
    elif stride == 1:
        grid = (D, H, W)
    else:
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if dy.device != x.device or dy.shape[:4] != (B, *grid):
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} must "
                         f"share a device, dy's grid (B, D, H, W) {grid}")
    co = dy.shape[4]
    check_pad_extents((D, H, W), pad_type)
    dw = torch.empty((27 * ci, co), dtype=torch.float32, device=x.device)
    plan = wgrad_plan(B, grid, ci, co, stride)
    ws = wgrad_workspace(plan, ci, co, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn("conv3x3x3_wgrad_ndhwc")(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
        ws.data_ptr() if ws is not None else None, plan.as_c(), B, D, H, W,
        ci, co, pad_code(pad_type), stride, stream,
    )
    build.check(rc, "conv3x3x3_wgrad_ndhwc")
    conv3x3x3_wgrad_ndhwc.launches += 1
    return dw


conv3x3x3_wgrad_ndhwc.launches = 0


def conv3x3x3_dgrad_ndhwc(
    dy: torch.Tensor, w_packed: torch.Tensor, *, pad_type: str = "reflect",
    stride: int = 1, spatial=None,
) -> torch.Tensor:
    """dx (B, D, H, W, Ci) of the "same" conv with packed weights `w_packed`
    (27 * Ci, Co), given its output gradient `dy` (B, D, H, W, Co); bf16 on
    the card. With `stride` 2: of the stride-2 pad-1 conv of a `spatial` =
    (D, H, W) input, given its output gradient on its own grid
    (B, (D+1)//2, (H+1)//2, (W+1)//2, Co) (`pad_type` "zeros")."""
    if dy.device.type == "cpu":
        return conv3x3x3_dgrad_ndhwc_plain(dy, w_packed, pad_type=pad_type,
                                           stride=stride, spatial=spatial)
    ci = _check_dgrad_operands(dy, w_packed)
    B, d, h, w, co = dy.shape
    if stride == 2:
        _check_s2_pad(pad_type)
        if spatial is None or s2_grid(spatial) != (d, h, w):
            raise ValueError(f"dy's grid {(d, h, w)} is not the stride-2 "
                             f"output grid of {spatial}")
        D, H, W = spatial
        dx = torch.empty((B, D, H, W, ci), dtype=torch.bfloat16,
                         device=dy.device)
        plan = conv_plan(B, (d, h, w), co, ci, mode=MODE_S2_DGRAD)
        # held until the launch is enqueued (see `_dgrad_launch`)
        w_t = transpose_packed(w_packed, ci)
        bias = _zero_bias(ci, dy.device)
        rc = _fn("conv3x3x3_dgrad_s2_ndhwc")(
            dy.data_ptr(), w_t.data_ptr(), bias.data_ptr(), dx.data_ptr(),
            plan.as_c(), B, d, h, w, D, H, W, co, ci,
            torch.cuda.current_stream(dy.device).cuda_stream,
        )
        build.check(rc, "conv3x3x3_dgrad_s2_ndhwc")
        conv3x3x3_dgrad_ndhwc.launches += 1
        return dx
    if stride != 1:
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    check_pad_extents((d, h, w), pad_type)
    pad = pad_code(pad_type)
    if pad:
        dx, g_ext = _pad_store(dy, w_packed, ci, pad)
        return _shell_launch(g_ext, dx, pad)
    return _dgrad_launch(dy, w_packed, ci, None, 0)


conv3x3x3_dgrad_ndhwc.launches = 0


def _check_dgrad_operands(dy, w_packed) -> int:
    """Ci of the packed weights, after checking dy and them for the card."""
    _check_bf16_cuda(dy, "dy")
    co = dy.shape[4]
    if (w_packed.dim() != 2 or w_packed.shape[0] % 27
            or w_packed.shape[1] != co or w_packed.dtype != torch.bfloat16
            or w_packed.device != dy.device):
        raise ValueError(f"packed weights must be bf16 (27*Ci, {co}) on "
                         f"{dy.device}; got {tuple(w_packed.shape)} "
                         f"{w_packed.dtype}")
    return w_packed.shape[0] // 27


@functools.lru_cache(maxsize=None)
def _zero_bias(ci, device):
    """The transposed convs' bias: (ci,) f32 zeros, read only."""
    return torch.zeros((ci,), dtype=torch.float32, device=device)


def _dgrad_launch(dy, w_packed, ci, g_ext, pad):
    """The stride-1 transposed conv into a new bf16 dx: over the volume
    (zeros), or with `g_ext` over the grid grown by 1 in the split store of
    the adjoint of `pad` (a `pad_code`)."""
    B, D, H, W, co = dy.shape
    dx = torch.empty((B, D, H, W, ci), dtype=torch.bfloat16, device=dy.device)
    fold = g_ext is not None
    grid = (D + 2, H + 2, W + 2) if fold else (D, H, W)
    plan = conv_plan(B, grid, co, ci)
    ws = workspace(plan, B * grid[0] * grid[1] * grid[2], ci, dy.device)
    # the flipped weights are held until the launch is enqueued: a tensor
    # freed before it (a temporary whose pointer alone is passed) gives its
    # memory to the next allocation on the stream, and the first call's
    # `_zero_bias` filled it with zeros ahead of the kernel
    w_t = flip_transpose_packed(w_packed, ci)
    bias = _zero_bias(ci, dy.device)
    rc = _fn("conv3x3x3_dgrad_ndhwc")(
        dy.data_ptr(), w_t.data_ptr(), bias.data_ptr(),
        g_ext.data_ptr() if fold else None, dx.data_ptr(),
        ws.data_ptr() if ws is not None else None, plan.as_c(), B, D, H, W,
        co, ci, pad, torch.cuda.current_stream(dy.device).cuda_stream,
    )
    build.check(rc, "conv3x3x3_dgrad_ndhwc")
    conv3x3x3_dgrad_ndhwc.launches += 1
    return dx


def pad_dgrad_store(dy: torch.Tensor, w_packed: torch.Tensor,
                    pad_type="reflect"):
    """The first launch of the padded conv's input gradient: the transposed
    conv over the (S+2)^3 grid grown by 1, with the split store of the
    adjoint of `pad_type` (not zeros on every axis). Returns (dx, g_ext):
    dx (B, D, H, W, Ci) bf16 written at every voxel off the shell, g_ext
    (B, D+2, H+2, W+2, Ci) f32 at the shell's sources only;
    `pad_shell_ndhwc(g_ext, dx, pad_type)` completes dx. Counted in
    `conv3x3x3_dgrad_ndhwc.launches`. On the CPU: the plain transposed conv
    and `pad_split_store_plain` (NaN where the kernel writes nothing)."""
    if dy.device.type == "cpu":
        dx, g_ext = pad_split_store_plain(
            _transposed_conv_ext(dy, w_packed), pad_type)
        return dx.to(dy.dtype), g_ext
    ci = _check_dgrad_operands(dy, w_packed)
    check_pad_extents(dy.shape[1:4], pad_type)
    pad = pad_code(pad_type)
    if not pad:
        raise ValueError("zero padding has no split store")
    return _pad_store(dy, w_packed, ci, pad)


def _pad_store(dy, w_packed, ci, pad):
    B, D, H, W, _ = dy.shape
    g_ext = torch.empty((B, D + 2, H + 2, W + 2, ci), dtype=torch.float32,
                        device=dy.device)
    return _dgrad_launch(dy, w_packed, ci, g_ext, pad), g_ext


def pad_shell_ndhwc(g_ext: torch.Tensor, dx: torch.Tensor,
                    pad_type="reflect") -> torch.Tensor:
    """The padded input gradient's shell pass, in place: every voxel of dx
    (B, D, H, W, C) bf16 with some axis index in its shell becomes the f32
    sum of its sources in g_ext (B, D+2, H+2, W+2, C) f32
    (`pad_shell_plain`), rounded once; no other voxel is written.
    Returns dx."""
    if g_ext.device.type == "cpu":
        return pad_shell_plain(g_ext, dx, pad_type)
    _check_bf16_cuda(dx, "dx")
    B, D, H, W, C = dx.shape
    if (g_ext.device != dx.device or g_ext.dtype != torch.float32
            or not g_ext.is_contiguous()
            or g_ext.shape != (B, D + 2, H + 2, W + 2, C)):
        want = (B, D + 2, H + 2, W + 2, C)
        raise ValueError(f"g_ext must be a contiguous f32 {want} tensor on "
                         f"{dx.device}, got {tuple(g_ext.shape)} "
                         f"{g_ext.dtype}")
    check_pad_extents((D, H, W), pad_type)
    pad = pad_code(pad_type)
    if not pad:
        raise ValueError("zero padding has no shell")
    return _shell_launch(g_ext, dx, pad)


pad_shell_ndhwc.launches = 0


def _shell_launch(g_ext, dx, pad):
    rc = _fn("pad_shell_ndhwc")(
        g_ext.data_ptr(), dx.data_ptr(), *dx.shape, pad,
        torch.cuda.current_stream(dx.device).cuda_stream)
    build.check(rc, "pad_shell_ndhwc")
    pad_shell_ndhwc.launches += 1
    return dx


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
