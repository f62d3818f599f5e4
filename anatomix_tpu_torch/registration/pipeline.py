"""The training-free registration workload (the port of
`anatomix_tpu/registration/pipeline.py`): load the model, extract anatomix
features of both volumes, scale them by `downscale_feat_scalar`, merge them
with MIND-SSC (optionally with the mask infill) (`pair_features`);
average-pool to the grid spacing, stage-1 coupled convex with inverse
consistency, stage-2 Adam instance optimisation (`solve`); warp the image
(and labels), save, report the macro-Dice.

Everything after the file reads runs on the card unless the caller passes
`device="cpu"`; nothing falls back to the host or to another route.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from anatomix_tpu_torch.device import resolve_device
from anatomix_tpu_torch.extract import extract_features
from anatomix_tpu_torch.models.load import load_model
from anatomix_tpu_torch.ops.pool import avg_pool
from anatomix_tpu_torch.registration.merge import merge_features
from anatomix_tpu_torch.registration.solver import (
    run_instance_opt,
    run_stage1_registration,
)
from anatomix_tpu_torch.registration.warp import warp_volume
from anatomix_tpu_torch.utils.nifti import load_volume, save_volume
from anatomix_tpu_torch.utils.profiling import annotate


def macro_dice(fixed_seg: np.ndarray, moved_seg: np.ndarray) -> float:
    """Dice averaged over the fixed segmentation's non-zero labels (the
    reference's sklearn `f1_score(average='macro', labels=...)`); NaN when
    it has none."""
    labels = [l for l in np.unique(fixed_seg).astype(int).tolist() if l != 0]
    if not labels:
        return float("nan")
    f = fixed_seg.reshape(-1)
    m = moved_seg.reshape(-1)
    scores = []
    for lab in labels:
        tp = np.sum((f == lab) & (m == lab))
        fp = np.sum((f != lab) & (m == lab))
        fn = np.sum((f == lab) & (m != lab))
        denom = 2 * tp + fp + fn
        scores.append(2 * tp / denom if denom > 0 else 0.0)
    return float(np.mean(scores))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pair_features(
    fixed_img: np.ndarray,
    moving_img: np.ndarray,
    plan,
    state_dict,
    *,
    use_mask: bool = False,
    fixed_mask: np.ndarray | None = None,
    moving_mask: np.ndarray | None = None,
    fixed_minclip=None,
    fixed_maxclip=None,
    moving_minclip=None,
    moving_maxclip=None,
    downscale_feat_scalar: float = 0.1,
    extract_strategy: str = "sliding",
    compute_dtype: torch.dtype | None = None,
    impl: str = "fused",
    device: str | torch.device = "cuda",
):
    """The solver's inputs for two (H, W, D) volumes: their anatomix
    features scaled by `downscale_feat_scalar` and merged with MIND-SSC
    (with the mask infill under `use_mask`), (1, H, W, D, 12 + C) f32
    each on `device`. `impl` and `compute_dtype` go to
    `make_feature_extractor` ('fused': the port's kernels, bf16 on the
    card; 'eager': the plain f32 module); `compute_dtype=None` takes bf16
    on the card and f32 on the CPU."""
    dev = resolve_device(device)
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    with annotate("reg/extract"):
        pred_fixed, pred_moving = extract_features(
            fixed_img, moving_img, plan, state_dict,
            fixminclip=fixed_minclip, fixmaxclip=fixed_maxclip,
            movminclip=moving_minclip, movmaxclip=moving_maxclip,
            strategy=extract_strategy, compute_dtype=compute_dtype,
            impl=impl, device=dev,
        )
    with annotate("reg/merge"):
        _, _, feat_fix, feat_mov = merge_features(
            use_mask, pred_fixed * downscale_feat_scalar,
            pred_moving * downscale_feat_scalar, fixed_mask, moving_mask,
            fixed_img, moving_img,
        )
    return feat_fix, feat_mov


def solve(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    *,
    lambda_weight: float = 0.75,
    grid_sp: int = 2,
    disp_hw: int = 1,
    selected_niter: int = 80,
    selected_smooth: int = 0,
    grid_sp_adam: int = 2,
    ic: bool = True,
) -> torch.Tensor:
    """The solver on `pair_features`' merged features: the pooling to the
    grid spacing, stage 1 (coupled convex, inverse consistency) and the
    Adam instance optimisation. Returns the field (1, H, W, D, 3) in
    voxels, channels (dH, dW, dD). `register_pair` times this call."""
    H, W, D = feat_fix.shape[1:4]
    disp = run_stage1_registration(
        avg_pool(feat_fix, grid_sp), avg_pool(feat_mov, grid_sp), disp_hw,
        grid_sp, (H, W, D), ic,
    )
    if selected_niter > 0:
        disp = run_instance_opt(
            disp, feat_fix, feat_mov, grid_sp_adam=grid_sp_adam,
            lambda_weight=lambda_weight, selected_niter=selected_niter,
            selected_smooth=selected_smooth, lr=1.0,
        )
    return disp


def register_pair(
    fixed_img: np.ndarray,
    moving_img: np.ndarray,
    plan,
    state_dict,
    *,
    lambda_weight: float = 0.75,
    grid_sp: int = 2,
    disp_hw: int = 1,
    selected_niter: int = 80,
    selected_smooth: int = 0,
    grid_sp_adam: int = 2,
    ic: bool = True,
    use_mask: bool = False,
    fixed_mask: np.ndarray | None = None,
    moving_mask: np.ndarray | None = None,
    fixed_minclip=None,
    fixed_maxclip=None,
    moving_minclip=None,
    moving_maxclip=None,
    downscale_feat_scalar: float = 0.1,
    extract_strategy: str = "sliding",
    compute_dtype: torch.dtype | None = None,
    impl: str = "fused",
    device: str | torch.device = "cuda",
):
    """Register two in-memory (H, W, D) volumes: `pair_features`, then
    `solve`. Returns (disp_vox (1, H, W, D, 3) on `device`,
    solver_seconds); the field is in voxels, channels (dH, dW, dD).

    `solver_seconds` is the reference's 'case time': `solve`, bracketed by
    `torch.cuda.synchronize()` on the card (the host clock alone on the
    CPU). The solver runs once; the JAX package runs it twice only to keep
    its jit compile out of the timed region."""
    dev = resolve_device(device)
    feat_fix, feat_mov = pair_features(
        fixed_img, moving_img, plan, state_dict, use_mask=use_mask,
        fixed_mask=fixed_mask, moving_mask=moving_mask,
        fixed_minclip=fixed_minclip, fixed_maxclip=fixed_maxclip,
        moving_minclip=moving_minclip, moving_maxclip=moving_maxclip,
        downscale_feat_scalar=downscale_feat_scalar,
        extract_strategy=extract_strategy, compute_dtype=compute_dtype,
        impl=impl, device=dev,
    )
    _sync(dev)
    t0 = time.perf_counter()
    disp = solve(
        feat_fix, feat_mov, lambda_weight=lambda_weight, grid_sp=grid_sp,
        disp_hw=disp_hw, selected_niter=selected_niter,
        selected_smooth=selected_smooth, grid_sp_adam=grid_sp_adam, ic=ic,
    )
    _sync(dev)
    return disp, time.perf_counter() - t0


def convex_adam(
    expname: str,
    lambda_weight: float,
    grid_sp: int,
    disp_hw: int,
    selected_niter: int,
    selected_smooth: int,
    ckpt_path: str | None = None,
    hf_variant: str | None = None,
    grid_sp_adam: int = 2,
    ic: bool = True,
    result_path: str = "./",
    fixed_image: str | None = None,
    moving_image: str | None = None,
    use_mask: bool = False,
    fixed_mask: str | None = None,
    moving_mask: str | None = None,
    fixed_minclip=None,
    fixed_maxclip=None,
    moving_minclip=None,
    moving_maxclip=None,
    warp_seg: bool = False,
    fixed_seg: str | None = None,
    moving_seg: str | None = None,
    downscale_feat_scalar: float = 0.1,
    num_downs: int = 4,
    ngf: int = 16,
    output_nc: int = 16,
    norm: str = "batch",
    interp: str = "nearest",
    pooling: str = "Max",
    extract_strategy: str = "sliding",
    cache_path: str | None = None,
    device: str | torch.device = "cuda",
):
    """File-to-file registration (the reference's flags): writes
    `disp_<tag>.nii.gz`, `moved_<tag>.nii.gz` and, with `warp_seg`,
    `labels_moved_<tag>.nii.gz` under `result_path`, and prints the case
    time and the Dice. `cache_path` is the local file of `hf_variant`."""
    dev = resolve_device(device)
    print("Loading model")
    plan, state_dict = load_model(
        ckpt_path=ckpt_path, hf_variant=hf_variant, cache_path=cache_path,
        num_downs=num_downs, ngf=ngf, output_nc=output_nc, norm=norm,
        interp=interp, pooling=pooling, device=dev,
    )

    fixedim, affine_mtx = load_volume(fixed_image)
    movingim, _ = load_volume(moving_image)

    fname = os.path.basename(moving_image)
    movsavename = (fname[:-7] if fname.endswith(".nii.gz")
                   else os.path.splitext(fname)[0])

    mask_f = mask_m = None
    if use_mask:
        mask_f, _ = load_volume(fixed_mask)
        mask_m, _ = load_volume(moving_mask)

    print("Running network on input images")
    disp_hr, case_time = register_pair(
        fixedim, movingim, plan, state_dict,
        lambda_weight=lambda_weight, grid_sp=grid_sp, disp_hw=disp_hw,
        selected_niter=selected_niter, selected_smooth=selected_smooth,
        grid_sp_adam=grid_sp_adam, ic=ic, use_mask=use_mask,
        fixed_mask=mask_f, moving_mask=mask_m,
        fixed_minclip=fixed_minclip, fixed_maxclip=fixed_maxclip,
        moving_minclip=moving_minclip, moving_maxclip=moving_maxclip,
        downscale_feat_scalar=downscale_feat_scalar,
        extract_strategy=extract_strategy, device=dev,
    )
    print("case time: ", case_time)

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=dev)[None, ..., None]

    moved = warp_volume(on_dev(movingim), disp_hr, mode="bilinear")

    tag = "{}_g{}_hw{}_l{}_ga{}_ic{}_{}".format(
        movsavename, grid_sp, disp_hw, lambda_weight, grid_sp_adam, ic,
        expname,
    )
    os.makedirs(result_path, exist_ok=True)

    if warp_seg:
        fixseg, _ = load_volume(fixed_seg)
        movseg, _ = load_volume(moving_seg)
        moved_seg = warp_volume(on_dev(movseg), disp_hr, mode="nearest")
        moved_seg_np = moved_seg[0, ..., 0].cpu().numpy()
        save_volume(
            os.path.join(result_path, f"labels_moved_{tag}.nii.gz"),
            moved_seg_np, affine_mtx,
        )
        print("Dice: {}".format(macro_dice(fixseg, moved_seg_np)))

    save_volume(os.path.join(result_path, f"disp_{tag}.nii.gz"),
                disp_hr[0].cpu().numpy(), affine_mtx)
    save_volume(os.path.join(result_path, f"moved_{tag}.nii.gz"),
                moved[0, ..., 0].cpu().numpy(), affine_mtx)
