"""The launch plans of the two wgmma conv kernels, held on the CPU.

`kernels/conv.py` `conv_plan` cuts a conv for `csrc/conv3d.cu` (the M tile
as a brick of the output grid with the batch folded in, the N tile, the
split of K) and `kernels/conv_train.py` `wgrad_plan` cuts the weight
gradient for `csrc/conv3d_wgrad.cu` (dW's row tiles, the position bricks,
their split). Each C launcher checks a plan's extents; these tests decode
the plans as the kernels do (`tile_voxel`, the halo-brick tile, the brick
decode of `wgrad_kernel`) and check that every output voxel, every K row
and every position is covered exactly once, and that the deep small-grid
convs fill the card.
"""

import numpy as np
import pytest

from anatomix_tpu_torch.kernels.conv import NUM_SMS, STEP_K, conv_plan
from anatomix_tpu_torch.kernels.conv_train import s2_grid, wgrad_plan


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
    plan = conv_plan(B, grid, co, ci, stride2_dgrad=True)
    assert plan.splits == 1
    _check_cover(plan, B, grid, co, ci, 8)


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
