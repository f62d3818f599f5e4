"""The UNet decoder's 2x upsampling on NDHWC volumes (plain versions).

Nearest is torch's legacy nearest (`src = floor(dst / 2)`), the 6M
`anatomix` decoder. Trilinear is `nn.Upsample(scale_factor=2,
mode="trilinear", align_corners=False)`, the `anatomix-dev` decoder:
computed in f32 and returned in the input dtype. On the card the fused
forward runs the `upsample2x_trilinear_ndhwc` kernel (`kernels/resize.py`)
instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x(x: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    if mode == "nearest":
        for axis in (1, 2, 3):
            x = torch.repeat_interleave(x, 2, dim=axis)
        return x
    if mode == "trilinear":
        y = F.interpolate(x.permute(0, 4, 1, 2, 3).float(), scale_factor=2,
                          mode="trilinear", align_corners=False)
        return y.permute(0, 2, 3, 4, 1).contiguous().to(x.dtype)
    raise ValueError(f"unsupported upsample mode {mode!r}")
