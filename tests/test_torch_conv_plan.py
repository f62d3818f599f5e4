"""The launch plans of the two wgmma conv kernels, held on the CPU.

`kernels/conv.py` `conv_plan` cuts a conv for `csrc/conv3d.cu` (the M tile
as a brick of the output grid with the batch folded in, the N tile, the
split of K; with `mode=MODE_S2` the stride-2 conv V2, whose first stage
runs a halo brick with its halo split by parity, mirrored here in numpy
from the kernel's index map) and `kernels/conv_train.py` `wgrad_plan` cuts
the weight
gradient for `csrc/conv3d_wgrad.cu` (dW's row tiles, the position bricks,
their split). Each C launcher checks a plan's extents; these tests decode
the plans as the kernels do (`tile_voxel`, the halo-brick tile, the brick
decode of `wgrad_kernel`) and check that every output voxel, every K row
and every position is covered exactly once, and that the deep small-grid
convs fill the card.
"""

import numpy as np
import pytest
import torch

from anatomix_tpu_torch.kernels.conv import (
    MODE_S2,
    MODE_S2_DGRAD,
    NUM_SMS,
    S2F_CHUNK,
    S2F_STEPS,
    STEP_K,
    conv_plan,
)
from anatomix_tpu_torch.kernels.conv_train import s2_grid, wgrad_plan
from anatomix_tpu_torch.ops.conv import conv3d_down2, unpack_conv_weight


def _cdiv(a, b):
    return -(-a // b)


def _tile_voxels(plan, B, grid):
    """(tile, row) -> (b, z, y, x) of the tiled grid for every row of every
    m-tile, as `conv3d.cu` decodes them, and whether the voxel exists."""
    gz, gy, gx = grid
    if plan.brick:
        tx, ty, tz = plan.tiles_x, plan.tiles_y, plan.tiles_z
        t = np.arange(plan.m_tiles)[:, None]
        r = np.arange(256)[None, :]
        x = (t % tx) * 8 + r % 8
        y = (t // tx % ty) * 8 + r // 8 % 8
        z = (t // (tx * ty) % tz) * 4 + r // 64
        b = t // (tx * ty * tz) + 0 * r
    else:
        bx, by, bz, bb = plan.bx, plan.by, plan.bz, plan.bb
        assert bx + by + bz + bb == 7
        t = np.arange(plan.m_tiles)[:, None]
        r = np.arange(128)[None, :]
        tx = t % plan.tiles_x
        ty = t // plan.tiles_x % plan.tiles_y
        tz = t // (plan.tiles_x * plan.tiles_y) % plan.tiles_z
        tb = t // (plan.tiles_x * plan.tiles_y * plan.tiles_z)
        x = (tx << bx) + (r & ((1 << bx) - 1))
        y = (ty << by) + ((r >> bx) & ((1 << by) - 1))
        z = (tz << bz) + ((r >> (bx + by)) & ((1 << bz) - 1))
        b = (tb << bb) + (r >> (bx + by + bz))
    valid = (x < gx) & (y < gy) & (z < gz) & (b < B)
    return b, z, y, x, valid


def _check_cover(plan, B, grid, ci, co, taps):
    b, z, y, x, valid = _tile_voxels(plan, B, grid)
    gz, gy, gx = grid
    idx = ((b * gz + z) * gy + y) * gx + x
    hits = np.bincount(idx[valid], minlength=B * gz * gy * gx)
    assert hits.min() == 1 and hits.max() == 1, "each voxel in one tile row"
    assert plan.n_tiles * plan.bn >= co > (plan.n_tiles - 1) * plan.bn
    if plan.brick:
        assert plan.splits == 1
        return
    # K rows: taps x Ci padded to 8, in steps of 64 split over `splits`
    # blocks, none of them empty (an empty split would leave its slice of
    # the workspace unwritten)
    k_total = taps * _cdiv(ci, 8) * 8
    steps = _cdiv(k_total, STEP_K)
    split_of = np.minimum(np.arange(k_total) // STEP_K
                          // plan.steps_per_split, plan.splits)
    per_split = np.bincount(split_of, minlength=plan.splits + 1)
    assert per_split[plan.splits] == 0, "every K row in some split"
    assert (per_split[:plan.splits] > 0).all(), "no empty split"
    assert plan.splits * plan.steps_per_split >= steps


@pytest.mark.parametrize("B,grid,ci,co", [
    (2, (4, 4, 4), 3 * 1024, 1024),          # dev bottleneck, split
    (2, (8, 8, 8), 3 * 512 + 3 * 1024, 512),  # dev decoder D3, split
    (2, (8, 8, 8), 256, 256),
    (1, (5, 6, 7), 40, 24),                   # ragged tiles, one batch item
    (2, (9, 10, 11), 96, 33),                 # N not a multiple of 8
    (3, (3, 5, 2), 64, 64),                   # batch folded past its end
    (2, (128, 128, 128), 16, 16),             # halo brick
    (2, (130, 130, 130), 16, 48),             # the reflect dgrad's grid
    (1, (12, 9, 17), 1, 16),                  # the Ci = 1 stem, brick
    (2, (32, 32, 32), 64 + 128, 64),
    # the dev pretraining step's reflect dgrads (dy's Co in, dx's Ci out,
    # the grid grown by 1): the bottleneck at 4^3, the first decoder conv
    # after the concat at 8^3 (1536 channels out), the 128^3 concat
    (2, (6, 6, 6), 1024, 512),
    (2, (6, 6, 6), 1024, 1024),
    (2, (10, 10, 10), 512, 1536),
    (2, (130, 130, 130), 32, 96),
    # a lifted 2-D UNet's slices (an extent of 1 on D) and a 1-D UNet's
    # lines (extents of 1 on D and H)
    (4, (1, 512, 512), 1, 16),
    (4, (1, 512, 512), 16, 16),
    (2, (1, 1, 4096), 1, 16),
    (4, (1, 64, 64), 128, 256),
])
def test_conv_plan_covers_every_voxel_and_k_row_once(B, grid, ci, co):
    plan = conv_plan(B, grid, ci, co)
    _check_cover(plan, B, grid, ci, co, 27)


@pytest.mark.parametrize("B,spatial,co,ci", [
    (2, (128, 128, 128), 64, 32),   # the ViT tokenizer's first stage: brick
    (2, (64, 64, 64), 128, 64),
    (2, (32, 32, 32), 256, 128),
    (1, (15, 16, 17), 16, 8),       # odd extents
    (1, (7, 9, 11), 32, 96),
])
def test_stride2_dgrad_plan_covers_dy_grid(B, spatial, co, ci):
    """The stride-2 input gradient is tiled over dy's grid and never
    split; its classes run inside each tile (brick) or on the grid's third
    axis (8 taps at most)."""
    grid = s2_grid(spatial)
    plan = conv_plan(B, grid, co, ci, mode=MODE_S2_DGRAD)
    assert plan.splits == 1
    _check_cover(plan, B, grid, co, ci, 8)


@pytest.mark.parametrize("B,spatial,ci,co", [
    (2, (128, 128, 128), 3 * 32, 64),   # the ViT tokenizer's three stages
    (2, (64, 64, 64), 3 * 64, 128),     # (on the three-term split)
    (2, (32, 32, 32), 3 * 128, 256),
    (1, (15, 16, 17), 12, 20),          # odd extents, B = 1, ragged widths
    (1, (63, 64, 65), 8, 16),           # odd extents on the brick
    (2, (9, 7, 11), 40, 136),           # N tile 128 past its end
])
def test_stride2_plan_covers_every_output_voxel_and_k_row_once(B, spatial,
                                                                ci, co):
    """The stride-2 conv is tiled over its output grid ((n - 1) // 2 + 1
    per axis) with K = 27 taps x Ci padded to 8."""
    grid = s2_grid(spatial)
    plan = conv_plan(B, grid, ci, co, mode=MODE_S2)
    _check_cover(plan, B, grid, ci, co, 27)
    if plan.brick:
        assert plan.chunk == S2F_CHUNK and plan.bn <= 64


def test_stride2_plan_picks_brick_or_ring_and_fills_the_card():
    """The bytes-bound first tokenizer stage runs the parity-split brick;
    the deeper two the gather ring at N tile 128, the last split so that
    at least 132 blocks run (128 tiles otherwise)."""
    first = conv_plan(2, s2_grid((128,) * 3), 96, 64, mode=MODE_S2)
    assert first.brick and first.m_tiles * first.n_tiles >= NUM_SMS
    for spatial, ci, co in [((64,) * 3, 192, 128), ((32,) * 3, 384, 256)]:
        plan = conv_plan(2, s2_grid(spatial), ci, co, mode=MODE_S2)
        assert not plan.brick and plan.bn == 128
        assert plan.m_tiles * plan.n_tiles * plan.splits >= NUM_SMS, plan
    last = conv_plan(2, (16, 16, 16), 384, 256, mode=MODE_S2)
    assert last.splits > 1


def test_stride2_plan_is_a_pure_function():
    a = conv_plan(2, (16, 16, 16), 384, 256, mode=MODE_S2)
    b = conv_plan(2, (16, 16, 16), 384, 256, mode=MODE_S2)
    assert a == b and list(a.as_c()) == list(a)


# The stride-2 brick's parity-split halo, as `csrc/conv3d.cu` lays it out
# (`s2f_ext`, `s2f_base`, `s2f_tap_voxel`, `s2f_step`): an 8 x 8 x 4 output
# tile's 17 x 17 x 9 input halo as 8 class bricks in class order (bits
# pz py px), each x fastest; a class-p axis holds input 2 (o0 + c) + p - 1.

def _s2f_ext(n, p):
    return n + 1 - p


def _s2f_base(cls):
    return sum(_s2f_ext(4, c >> 2) * _s2f_ext(8, (c >> 1) & 1)
               * _s2f_ext(8, c & 1) for c in range(cls))


def _s2f_tap_voxel(tap, zl):
    kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
    py, px = int(kh == 1), int(kw == 1)
    ey, ex = _s2f_ext(8, py), _s2f_ext(8, px)
    return (_s2f_base(4 * (kd == 1) + 2 * py + px)
            + ((zl + (kd == 2)) * ey + (kh == 2)) * ex + (kw == 2))


def _s2f_step(s):
    if s < 9:
        return 3 * s, 3 * s + 2, 1
    if s < 12:
        return 9 * (s - 9) + 1, 9 * (s - 9) + 7, _s2f_ext(8, 1)
    if s == 12:
        return 4, 22, _s2f_ext(8, 1) * _s2f_ext(8, 1)
    return 13, -1, 0


def _halo_sources(z0, y0, x0):
    """(iz, iy, ix) of every halo voxel, in the kernel's voxel order."""
    out = []
    for cls in range(8):
        pz, py, px = cls >> 2, (cls >> 1) & 1, cls & 1
        ez, ey, ex = _s2f_ext(4, pz), _s2f_ext(8, py), _s2f_ext(8, px)
        cz, cy, cx = np.meshgrid(np.arange(ez), np.arange(ey), np.arange(ex),
                                 indexing="ij")
        out.append(np.stack([2 * (z0 + cz) + pz - 1, 2 * (y0 + cy) + py - 1,
                             2 * (x0 + cx) + px - 1], -1).reshape(-1, 3))
    return np.concatenate(out)


def _brick_down2(x, w):
    """The stride-2 brick's arithmetic in numpy (float64): per output tile
    the halo by the index map (zeros outside the volume), then per K16
    step two taps' A operands as the kernel's descriptors address them
    (row r of plane zl: voxel start + (r // 8) * class x extent + r % 8;
    the second K half `lead` voxels on) against their weight rows."""
    B, D, H, W, C = x.shape
    oD, oH, oW = s2_grid((D, H, W))
    wt = w.reshape(27, C, -1)
    out = np.zeros((B, oD, oH, oW, wt.shape[-1]))
    r = np.arange(64)
    for b in range(B):
        for z0 in range(0, oD, 4):
            for y0 in range(0, oH, 8):
                for x0 in range(0, oW, 8):
                    src = _halo_sources(z0, y0, x0)
                    ok = ((src >= 0) & (src < [D, H, W])).all(-1)
                    halo = np.zeros((len(src) + 8, C))
                    iz, iy, ix = np.clip(src, 0, [D - 1, H - 1, W - 1]).T
                    halo[:len(src)][ok] = x[b, iz, iy, ix][ok]
                    for zl in range(4):
                        acc = 0.0
                        for s in range(S2F_STEPS):
                            ta, tb, lead = _s2f_step(s)
                            rows = (_s2f_tap_voxel(ta, zl) + r // 8
                                    * _s2f_ext(8, int(ta % 3 == 1)) + r % 8)
                            acc = acc + halo[rows] @ wt[ta]
                            if tb >= 0:
                                acc = acc + halo[rows + lead] @ wt[tb]
                        acc = acc.reshape(8, 8, -1)
                        z = z0 + zl
                        if z < oD:
                            ny, nx = min(8, oH - y0), min(8, oW - x0)
                            out[b, z, y0:y0 + ny, x0:x0 + nx] = acc[:ny, :nx]
    return out


def test_parity_halo_steps_cover_every_tap_once():
    """The 14 K16 steps pair 27 taps, each once, plus one zero half; both
    taps of a step lie in one parity class, `lead` voxels apart."""
    taps = []
    for s in range(S2F_STEPS):
        ta, tb, lead = _s2f_step(s)
        taps += [ta] + ([tb] if tb >= 0 else [])
        if tb >= 0:
            for zl in range(4):
                assert _s2f_tap_voxel(tb, zl) - _s2f_tap_voxel(ta, zl) == lead
    assert sorted(taps) == list(range(27))
    assert _s2f_base(8) == 17 * 17 * 9


@pytest.mark.parametrize("spatial", [(8, 16, 16), (9, 15, 17), (7, 5, 19)])
def test_parity_halo_index_map_reproduces_conv3d_down2(spatial):
    """The halo split by parity, read through the kernel's descriptors,
    gives `ops/conv.conv3d_down2` (f32) to 1e-6 of max |ref|, odd extents
    included."""
    rng = np.random.default_rng(3)
    C, co = 5, 6
    x = rng.standard_normal((1, *spatial, C)).astype(np.float32)
    w = rng.standard_normal((27 * C, co)).astype(np.float32)
    got = _brick_down2(x.astype(np.float64), w.astype(np.float64))
    ref = conv3d_down2(torch.from_numpy(x),
                       unpack_conv_weight(torch.from_numpy(w), C)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_conv_plan_fills_the_card_where_it_must():
    """At least 132 blocks at 4^3 3072 -> 1024 and 8^3 [1536 + 3072] -> 512
    (split K, the weights read once over the card); one split at 128^3
    16 -> 16."""
    for B, grid, ci, co in [(2, (4, 4, 4), 3072, 1024),
                            (2, (8, 8, 8), 1536 + 3072, 512),
                            (2, (8, 8, 8), 1536, 512)]:
        plan = conv_plan(B, grid, ci, co)
        blocks = plan.m_tiles * plan.n_tiles * plan.splits
        assert plan.splits > 1 and blocks >= NUM_SMS, (grid, plan)
        # the batch is folded into the M tile: no tile row is padding
        _, _, _, _, valid = _tile_voxels(plan, B, grid)
        assert valid.all()
    plan = conv_plan(2, (128, 128, 128), 16, 16)
    assert plan.splits == 1


def test_conv_plan_is_a_pure_function():
    a = conv_plan(2, (8, 8, 8), 4608, 512)
    b = conv_plan(2, (8, 8, 8), 4608, 512)
    assert a == b and list(a.as_c()) == list(a)


@pytest.mark.parametrize("B,grid,ci,co,stride", [
    (2, (128, 128, 128), 16, 16, 1),   # halo brick, 7 m64 tiles
    (2, (128, 128, 128), 48, 16, 1),   # halo brick, 21 m64 tiles
    (1, (9, 10, 11), 2, 32, 1),
    (2, (8, 8, 8), 256, 256, 1),
    (2, (64, 64, 64), 32, 64, 2),      # the stride-2 gradient's grid
    (1, (8, 8, 9), 5, 12, 2),
    (3, (3, 4, 5), 24, 40, 1),
    # the dev pretraining step's widest weight gradients
    (2, (4, 4, 4), 512, 1024, 1),
    (2, (4, 4, 4), 1024, 1024, 1),
    (2, (8, 8, 8), 1536, 512, 1),
    (2, (128, 128, 128), 96, 32, 1),
    (2, (128, 128, 128), 1, 32, 1),
    # the 6M segmentation step's 64^3 weight gradients at batch 3
    (3, (64, 64, 64), 96, 32, 1),
    (3, (64, 64, 64), 32, 32, 1),
    (3, (64, 64, 64), 16, 32, 1),
    # lifted 2-D and 1-D UNets: extents of 1
    (4, (1, 512, 512), 16, 16, 1),
    (2, (1, 1, 4096), 1, 16, 1),
])
def test_wgrad_plan_covers_every_position_and_row_once(B, grid, ci, co,
                                                        stride):
    plan = wgrad_plan(B, grid, ci, co, stride)
    gz, gy, gx = grid
    if plan.halo:
        bx, by, bz, bb = 3, 2, 2, 0
        assert plan.m_tiles * 64 >= 27 * _cdiv(ci, 8) * 8
        assert stride == 1
    else:
        bx, by, bz, bb = plan.bx, plan.by, plan.bz, plan.bb
        assert plan.m_tiles * 128 >= 27 * _cdiv(ci, 8) * 8
    # 64 positions a brick (the halo brick: 8 x 4 x 4 = 128)
    assert bx + by + bz + bb == (7 if plan.halo else 6)
    t = np.arange(plan.n_bricks)[:, None]
    p = np.arange(64 << (1 if plan.halo else 0))[None, :]
    if plan.halo:
        x = (t % plan.tiles_x) * 8 + p % 8
        y = (t // plan.tiles_x % plan.tiles_y) * 4 + p // 8 % 4
        z = (t // (plan.tiles_x * plan.tiles_y) % plan.tiles_z) * 4 + p // 32
        b = t // (plan.tiles_x * plan.tiles_y * plan.tiles_z) + 0 * p
    else:
        tx = t % plan.tiles_x
        ty = t // plan.tiles_x % plan.tiles_y
        tz = t // (plan.tiles_x * plan.tiles_y) % plan.tiles_z
        tb = t // (plan.tiles_x * plan.tiles_y * plan.tiles_z)
        x = (tx << bx) + (p & ((1 << bx) - 1))
        y = (ty << by) + ((p >> bx) & ((1 << by) - 1))
        z = (tz << bz) + ((p >> (bx + by)) & ((1 << bz) - 1))
        b = (tb << bb) + (p >> (bx + by + bz))
    valid = (x < gx) & (y < gy) & (z < gz) & (b < B)
    idx = ((b * gz + z) * gy + y) * gx + x
    hits = np.bincount(idx[valid], minlength=B * gz * gy * gx)
    assert hits.min() == 1 and hits.max() == 1
    # the bricks split into `splits` non-empty runs
    runs = np.bincount(np.arange(plan.n_bricks) // plan.bricks_per_split)
    assert len(runs) == plan.splits and runs.min() > 0
    assert plan.n_tiles * plan.bn >= co


def test_wgrad_plan_caps_the_gather_rings_run():
    """The gather ring's blocks reduce at most `WGRAD_MAX_RUN` bricks each
    (the accumulation error grows with the run): the dev step's 128^3
    convs split further (96 -> 32: 64 runs of 1024 bricks, not 12 of
    5462); the 6M and ViT shapes keep their plans, the longest of them
    the 6M segmentation step's 64^3 96 -> 32 at batch 3, whose 12 runs of
    1024 bricks sit at the cap."""
    from anatomix_tpu_torch.kernels.conv_train import WGRAD_MAX_RUN

    for ci, co in [(96, 32), (32, 32)]:
        plan = wgrad_plan(2, (128, 128, 128), ci, co)
        assert not plan.halo and plan.bricks_per_split <= WGRAD_MAX_RUN
        assert plan.splits * plan.bricks_per_split >= plan.n_bricks
    assert wgrad_plan(2, (128, 128, 128), 96, 32).splits == 64
    for B, grid, ci, co, splits in [(2, (64,) * 3, 96, 32, 12),
                                    (2, (64,) * 3, 32, 32, 37),
                                    (2, (64,) * 3, 64, 64, 18),
                                    (3, (64,) * 3, 96, 32, 12),
                                    (3, (64,) * 3, 32, 32, 37),
                                    (3, (128,) * 3, 48, 16, 132)]:
        assert wgrad_plan(B, grid, ci, co).splits == splits
    plan = wgrad_plan(3, (64,) * 3, 96, 32)
    assert plan.bricks_per_split == WGRAD_MAX_RUN


def test_wgrad_plan_fills_the_card_at_small_grids():
    """The stride-2 gradients of the ViT tokenizer and the 16^3 stage keep
    at least 100 blocks in flight (the 108 tiles of dW at 256 -> 256 fill
    the card without a split)."""
    for B, spatial, ci, co in [(2, (128,) * 3, 32, 64),
                               (2, (64,) * 3, 64, 128),
                               (2, (32,) * 3, 128, 256)]:
        plan = wgrad_plan(B, s2_grid(spatial), ci, co, 2)
        assert plan.m_tiles * plan.n_tiles * plan.splits >= 100, plan
    plan = wgrad_plan(2, (16, 16, 16), 256, 256)
    assert plan.m_tiles * plan.n_tiles * plan.splits >= 100
