"""3D `grid_sample` on channels-last volumes (the port of
`anatomix_tpu/ops/grid_sample.py`, whose semantics are torch's
`F.grid_sample` on 5-D input, so the port calls it):

* volume (N, D, H, W, C), grid (N, d, h, w, 3) with grid[..., 0] = x (the
  W axis), 1 = y (H), 2 = z (D), in [-1, 1];
* align_corners=False: pix = ((coord + 1) * size - 1) / 2; True:
  pix = (coord + 1) / 2 * (size - 1);
* zero padding: an out-of-range corner tap contributes zero;
* nearest rounds half to even (torch's `nearbyint`, JAX's `rint`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(vol: torch.Tensor, grid: torch.Tensor, *,
                mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """Sample `vol` (N, D, H, W, C) at the normalized `grid` (N, d, h, w,
    3); returns (N, d, h, w, C) in `vol`'s dtype. Zero padding only."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"Unsupported grid_sample mode: {mode}")
    out = F.grid_sample(vol.permute(0, 4, 1, 2, 3), grid.to(vol.dtype),
                        mode=mode, padding_mode="zeros",
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 4, 1)


def identity_grid(spatial: tuple[int, int, int], *,
                  align_corners: bool = False,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """Normalized identity grid (1, D, H, W, 3) in f32, as
    `F.affine_grid(eye(3, 4), (1, 1, D, H, W), align_corners=...)`: with
    align_corners=False each axis runs from -1 + 1/size to 1 - 1/size."""
    def axis_coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, dtype=torch.float32,
                                  device=device)
        return ((torch.arange(size, dtype=torch.float32, device=device)
                 + 0.5) * (2.0 / size) - 1.0)

    zz, yy, xx = torch.meshgrid(*(axis_coords(s) for s in spatial),
                                indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)[None]
