"""2x pooling on NDHWC volumes (the UNet's `Pool(2)` downsampling, torch
`ceil_mode=False`: a trailing odd voxel is dropped)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), window, window)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    y = F.avg_pool3d(x.permute(0, 4, 1, 2, 3).float(), window, window)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(x.dtype)
