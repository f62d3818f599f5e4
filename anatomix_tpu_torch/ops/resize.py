"""Resampling of NDHWC volumes (plain versions).

`upsample2x` is the UNet decoder's 2x upsampling. Nearest is torch's legacy
nearest (`src = floor(dst / 2)`), the 6M `anatomix` decoder. Trilinear is
`nn.Upsample(scale_factor=2, mode="trilinear", align_corners=False)`, the
`anatomix-dev` decoder: computed in f32 and returned in the input dtype. On
the card the fused forward runs the `upsample2x_trilinear_ndhwc` kernel
(`kernels/resize.py`) instead.

`resize3d` is `F.interpolate(..., size=...)` to any size, the registration
stack's resampling: stage 1's field to full resolution, the instance
optimisation's field to its grid and back, and the EDT infill's ::2
subsample back to full size.
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


def resize3d(x: torch.Tensor, size: tuple[int, int, int], *,
             mode: str = "trilinear",
             align_corners: bool = False) -> torch.Tensor:
    """Resize the spatial axes of NDHWC `x` to `size` with torch's rules:
    'nearest' is the legacy `floor(dst * in / out)`, 'trilinear' takes
    `align_corners` (False: half-pixel centres, negative sources clamped to
    0). Trilinear computes in f32 and returns `x`'s dtype."""
    if tuple(size) == tuple(x.shape[1:4]):
        return x
    y = x.permute(0, 4, 1, 2, 3)
    if mode == "nearest":
        y = F.interpolate(y, size=tuple(size), mode="nearest")
    elif mode == "trilinear":
        y = F.interpolate(y.float(), size=tuple(size), mode="trilinear",
                          align_corners=align_corners)
    else:
        raise ValueError(f"Unsupported resize mode: {mode}")
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)
