"""ConvexAdam's two stages: the coupled convex stage 1 and the Adam
instance optimisation (the port of `anatomix_tpu/registration/solver.py`).

The JAX package runs the 80 Adam iterations as one `lax.scan` of optax's
Adam; here they are a Python loop of autograd steps and
`torch.optim.Adam` (the same bias-corrected update). Gradients flow
through the box smoothing and the trilinear `F.grid_sample` to the field
only: the sampled features do not require grad, so no step pays the
sampler's atomic scatter into the volume.
"""

from __future__ import annotations

import torch

from anatomix_tpu_torch.ops.grid_sample import grid_sample, identity_grid
from anatomix_tpu_torch.ops.pool import avg_pool, box_filter
from anatomix_tpu_torch.ops.resize import resize3d
from anatomix_tpu_torch.registration.correlate import (
    correlate,
    coupled_convex,
    displacement_mesh,
)
from anatomix_tpu_torch.registration.warp import (
    diffusion_regularizer,
    inverse_consistency,
    smooth_disp,
)
from anatomix_tpu_torch.utils.profiling import annotate


def _flip(x: torch.Tensor) -> torch.Tensor:
    """(dH, dW, dD) <-> (x, y, z): reverse the channel axis."""
    return torch.flip(x, dims=(-1,))


def run_stage1_registration(features_fix_smooth: torch.Tensor,
                            features_mov_smooth: torch.Tensor,
                            disp_hw: int, grid_sp: int,
                            sizes: tuple[int, int, int],
                            ic: bool = True) -> torch.Tensor:
    """Correlation and coupled convex on the grid-spaced features (1, H',
    W', D', C). With `ic`, both directions, 15 inverse-consistency
    iterations and a trilinear resize: the (1, H, W, D, 3) voxel field
    (dH, dW, dD) at full resolution `sizes`; without, the grid-spaced field
    in grid units."""
    H, W, D = sizes
    dev = features_fix_smooth.device
    mesh = torch.as_tensor(displacement_mesh(disp_hw), device=dev)

    with annotate("reg/correlate"):
        ssd, ssd_argmin = correlate(features_fix_smooth, features_mov_smooth,
                                    disp_hw)
    with annotate("reg/coupled_convex"):
        disp_soft = coupled_convex(ssd, ssd_argmin, mesh)
    if not ic:
        return disp_soft

    scale = torch.tensor(
        [H // grid_sp - 1, W // grid_sp - 1, D // grid_sp - 1],
        dtype=torch.float32, device=dev) / 2.0
    with annotate("reg/correlate"):
        ssd_b, argmin_b = correlate(features_mov_smooth, features_fix_smooth,
                                    disp_hw)
    with annotate("reg/coupled_convex"):
        disp_soft_b = coupled_convex(ssd_b, argmin_b, mesh)
    del ssd, ssd_b

    with annotate("reg/ic"):
        d1 = _flip(disp_soft / scale)
        d2 = _flip(disp_soft_b / scale)
        disp_ice, _ = inverse_consistency(d1, d2, iterations=15)
    disp_vox = _flip(disp_ice) * scale * grid_sp
    return resize3d(disp_vox, (H, W, D), mode="trilinear",
                    align_corners=False)


def instance_loss(weights: torch.Tensor, patch_fix: torch.Tensor,
                  patch_mov: torch.Tensor, grid0: torch.Tensor,
                  scale: torch.Tensor, lambda_weight: float):
    """One iteration's objective of `run_instance_opt` at the grid field
    `weights` (1, Hg, Wg, Dg, 3): returns (loss, the smoothed field). The
    grid is `grid0 + flip(field / scale)`, the JAX package's order of
    operations: where the field is zero the samples fall exactly on voxel
    centres, where the sampler's gradient is one-sided."""
    disp_sample = box_filter(weights, 3, 3)
    reg_loss = diffusion_regularizer(disp_sample, lambda_weight)
    grid = grid0 + _flip(disp_sample / scale)
    sampled = grid_sample(patch_mov, grid)
    cost = ((sampled - patch_fix) ** 2).mean(dim=-1) * 12.0
    return cost.mean() + reg_loss, disp_sample


def run_instance_opt(disp_hr: torch.Tensor, features_fix: torch.Tensor,
                     features_mov: torch.Tensor, grid_sp_adam: int = 2,
                     lambda_weight: float = 0.75, selected_niter: int = 80,
                     selected_smooth: int = 0,
                     lr: float = 1.0) -> torch.Tensor:
    """Adam instance optimisation of the voxel field `disp_hr` (1, H, W,
    D, 3) on the full-resolution merged features (1, H, W, D, C).

    The variable is the field on the `grid_sp_adam` grid, in grid units.
    Each iteration box-smooths it (k 3, three times), adds the diffusion
    regulariser to 12 x the mean squared feature difference at the sampled
    positions, and takes an Adam step (lr `lr`, betas 0.9 / 0.999, eps
    1e-8, as `optax.adam`). As in the reference, the field returned is the
    last iteration's smoothed field before its update, resized to full
    resolution, then box-smoothed `selected_smooth` (3 or 5) wide if asked.
    """
    H, W, D = features_fix.shape[1:4]
    g = grid_sp_adam
    Hg, Wg, Dg = H // g, W // g, D // g
    dev = features_fix.device
    with torch.no_grad():
        patch_fix = avg_pool(features_fix.float(), g)
        patch_mov = avg_pool(features_mov.float(), g)
        disp_lr = resize3d(disp_hr.float(), (Hg, Wg, Dg), mode="trilinear",
                           align_corners=False)
    weights = (disp_lr / g).contiguous().requires_grad_(True)
    scale = torch.tensor([(Hg - 1) / 2.0, (Wg - 1) / 2.0, (Dg - 1) / 2.0],
                         dtype=torch.float32, device=dev)
    grid0 = identity_grid((Hg, Wg, Dg), align_corners=False, device=dev)
    opt = torch.optim.Adam([weights], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    fitted = weights.detach().clone()
    with annotate("reg/adam"), torch.enable_grad():
        for _ in range(selected_niter):
            opt.zero_grad(set_to_none=True)
            loss, disp_sample = instance_loss(weights, patch_fix, patch_mov,
                                              grid0, scale, lambda_weight)
            loss.backward()
            fitted = disp_sample.detach()
            opt.step()

    disp_out = resize3d(fitted * g, (H, W, D), mode="trilinear",
                        align_corners=False)
    if selected_smooth in (3, 5):
        disp_out = smooth_disp(disp_out, selected_smooth, num_repeats=3)
    return disp_out
