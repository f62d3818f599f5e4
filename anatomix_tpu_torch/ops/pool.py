"""2x pooling on NDHWC volumes (the UNet's `Pool(2)` downsampling, torch
`ceil_mode=False`: a trailing odd voxel is dropped), and the max pool of the
pretraining step's train walk on the block layout."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), window, window)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    y = F.avg_pool3d(x.permute(0, 4, 1, 2, 3).float(), window, window)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(x.dtype)


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
