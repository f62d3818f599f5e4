"""Displacement-field utilities: inverse consistency, warping,
regularisers, Jacobian determinant (the port of
`anatomix_tpu/registration/warp.py`).

Volumes are (1, H, W, D, C); displacement fields (1, H, W, D, 3), either
with channels (dH, dW, dD) in voxels, or normalised and (x, y, z)-ordered
for `grid_sample` (x along D), flipped between the two as the reference
does. Sampling is `ops/grid_sample.grid_sample` (`F.grid_sample`, zero
padding, align_corners=False).
"""

from __future__ import annotations

import torch

from anatomix_tpu_torch.ops.grid_sample import grid_sample, identity_grid
from anatomix_tpu_torch.ops.pool import box_filter
from anatomix_tpu_torch.utils.profiling import annotate


def diffusion_regularizer(disp_sample: torch.Tensor,
                          lambda_weight: float) -> torch.Tensor:
    """`lambda_weight` times the summed mean squared first differences
    along the three spatial axes of (1, H, W, D, 3)."""
    d = disp_sample[0]
    loss = (
        ((d[:, 1:, :] - d[:, :-1, :]) ** 2).mean()
        + ((d[1:, :, :] - d[:-1, :, :]) ** 2).mean()
        + ((d[:, :, 1:] - d[:, :, :-1]) ** 2).mean()
    )
    return lambda_weight * loss


def inverse_consistency(disp1: torch.Tensor, disp2: torch.Tensor,
                        iterations: int = 20):
    """Fixed-point inverse-consistency iterations on two normalised (x, y,
    z)-ordered fields: disp_i <- (disp_i - sample(disp_j at id + disp_i)) / 2,
    both directions at once, trilinear with zero padding."""
    ident = identity_grid(disp1.shape[1:4], align_corners=False,
                          device=disp1.device)
    d1, d2 = disp1, disp2
    for _ in range(iterations):
        s2 = grid_sample(d2, ident + d1)
        s1 = grid_sample(d1, ident + d2)
        d1, d2 = 0.5 * (d1 - s2), 0.5 * (d2 - s1)
    return d1, d2


def normalize_disp(disp_vox: torch.Tensor) -> torch.Tensor:
    """Voxel (dH, dW, dD) field -> normalised (x, y, z) field for
    `grid_sample` with align_corners=False."""
    H, W, D = disp_vox.shape[1:4]
    denom = torch.tensor([H - 1, W - 1, D - 1], dtype=torch.float32,
                         device=disp_vox.device)
    return torch.flip(disp_vox / denom * 2.0, dims=(-1,))


def warp_volume(vol: torch.Tensor, disp_vox: torch.Tensor, *,
                mode: str = "bilinear") -> torch.Tensor:
    """Warp `vol` (1, H, W, D, C) by the voxel field `disp_vox` ('bilinear'
    for images, 'nearest' for labels)."""
    with annotate("reg/warp"):
        grid = identity_grid(vol.shape[1:4], align_corners=False,
                             device=vol.device) + normalize_disp(disp_vox)
        return grid_sample(vol, grid, mode=mode, align_corners=False)


def smooth_disp(disp: torch.Tensor, kernel_size: int,
                num_repeats: int = 3) -> torch.Tensor:
    """The optional post-smoothing of the final field."""
    return box_filter(disp, kernel_size, num_repeats)


def generate_grid(imgshape, *,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """Voxel-coordinate grid (H, W, D, 3) f32, channels (x = D, y = W,
    z = H), the reference's `generate_grid`."""
    H, W, D = imgshape
    z, y, x = torch.meshgrid(
        *(torch.arange(s, device=device) for s in (H, W, D)), indexing="ij")
    return torch.stack([x, y, z], dim=-1).float()


def jacobian_det(disp: torch.Tensor,
                 sample_grid: torch.Tensor) -> torch.Tensor:
    """Finite-difference Jacobian determinant of the deformation `disp`
    (1, H, W, D, 3) + `sample_grid` (H, W, D, 3) -> (1, H-1, W-1, D-1)."""
    J = disp + sample_grid[None]
    dy = J[:, 1:, :-1, :-1, :] - J[:, :-1, :-1, :-1, :]
    dx = J[:, :-1, 1:, :-1, :] - J[:, :-1, :-1, :-1, :]
    dz = J[:, :-1, :-1, 1:, :] - J[:, :-1, :-1, :-1, :]
    det0 = dx[..., 0] * (dy[..., 1] * dz[..., 2] - dy[..., 2] * dz[..., 1])
    det1 = dx[..., 1] * (dy[..., 0] * dz[..., 2] - dy[..., 2] * dz[..., 0])
    det2 = dx[..., 2] * (dy[..., 0] * dz[..., 1] - dy[..., 1] * dz[..., 0])
    return det0 - det1 + det2
