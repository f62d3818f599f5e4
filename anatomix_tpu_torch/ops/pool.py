"""Pooling on NDHWC volumes.

* `max_pool` / `avg_pool`: the UNet's `Pool(2)` downsampling (torch
  `ceil_mode=False`: a trailing odd voxel is dropped); registration also
  pools its merged features to the grid spacing with `avg_pool(x, grid_sp)`.
* `max_pool_block`: the max pool of the pretraining step's train walk on
  the block layout.
* `avg_pool3d`: the JAX package's `avg_pool3d` (torch's
  `F.avg_pool3d(count_include_pad=True)`, any padding) on NDHWC volumes;
  `box_filter`'s step. The registration modules that hold NCDHW tensors
  (MIND's patch SSD, the correlation volume's smoothing, the mask
  smoothing, the coupled-convex field) call `F.avg_pool3d` directly.
* `box_filter`: repeated stride-1 zero-padded box smoothing, the
  reference's `apply_avg_pool3d` (the instance optimisation's field and
  `smooth_disp`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _as3(v) -> tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), window, window)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    y = F.avg_pool3d(x.permute(0, 4, 1, 2, 3).float(), window, window)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(x.dtype)


def avg_pool3d(x: torch.Tensor, kernel_size, *, stride=1,
               padding=0) -> torch.Tensor:
    """`F.avg_pool3d(count_include_pad=True)` on NDHWC `x`: zero padding
    by `padding` on each side (any width; torch's own argument takes at
    most half the kernel, so the pad is explicit), every window's sum
    divided by the whole kernel volume. Computed in f32, returned in `x`'s
    dtype."""
    k, s, p = _as3(kernel_size), _as3(stride), _as3(padding)
    y = F.pad(x.permute(0, 4, 1, 2, 3).float(),
              tuple(v for pi in reversed(p) for v in (pi, pi)))
    y = F.avg_pool3d(y, k, s)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def box_filter(x: torch.Tensor, kernel_size: int,
               num_repeats: int) -> torch.Tensor:
    """`num_repeats` stride-1 zero-padded box means of width
    `kernel_size` (odd) on NDHWC `x`."""
    for _ in range(num_repeats):
        x = avg_pool3d(x, kernel_size, stride=1, padding=kernel_size // 2)
    return x


class _MaxPoolBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xb):
        B, d, h, w, c8 = xb.shape
        y = xb.view(B, d, h, w, 8, c8 // 8).amax(dim=4)
        ctx.save_for_backward(xb, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        xb, y = ctx.saved_tensors
        groups = xb.view(*y.shape[:4], 8, y.shape[4])
        taken = None
        parts = []
        for g in range(8):
            eq = groups[..., g, :] == y
            first = eq if taken is None else eq & ~taken
            taken = eq if taken is None else taken | eq
            parts.append(torch.where(first, dy, torch.zeros_like(dy)))
        return torch.stack(parts, dim=4).reshape(xb.shape)


def max_pool_block(xb: torch.Tensor) -> torch.Tensor:
    """2x max pool of a volume in the block layout (B, d, h, w, 8 C) of
    `kernels/reshuffle.space_to_depth2`, where each 2^3 window is one voxel's
    8 channel groups: (B, d, h, w, C) out. Its gradient goes to the first
    maximum of each window in (d, h, w) scan order, torch's rule (the JAX
    package's `_max_pool_block`): post-ReLU maps tie at 0.0 all the time."""
    return _MaxPoolBlock.apply(xb)
