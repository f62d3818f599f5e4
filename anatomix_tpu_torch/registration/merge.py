"""Feature merging: MIND-SSC || network features, with the optional mask
infill (the port of `anatomix_tpu/registration/merge.py`).

With masks, each image outside its mask takes its nearest in-mask
intensity before MIND: an exact EDT with indices on the ::2 subsample
(`ops/edt.py`, on the device), a gather, a trilinear resize back to full
size, and the in-mask voxels overwritten by the image. The network features
are zeroed outside the mask. At exact ties the EDT picks the voxel the JAX
package picks, which may not be scipy's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from anatomix_tpu_torch.ops.edt import edt_feature_transform
from anatomix_tpu_torch.ops.resize import resize3d
from anatomix_tpu_torch.registration.mind import mindssc


def _edt_infill(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Out-of-mask voxels of `img` (H, W, D) take their nearest in-mask
    intensity, found on the ::2 subsample and resized back trilinearly."""
    sub_mask = mask[::2, ::2, ::2]
    idx, _ = edt_feature_transform(sub_mask)
    idx = idx.long()
    filled_sub = img[::2, ::2, ::2][idx[0], idx[1], idx[2]]
    filled = resize3d(filled_sub.float()[None, ..., None], tuple(img.shape),
                      mode="trilinear", align_corners=False)[0, ..., 0]
    return torch.where(mask > 0, img, filled).float()


def _smooth_mask(m: torch.Tensor) -> torch.Tensor:
    """Edge-pad by 1, 3^3 mean, threshold at > 0.9."""
    sm = F.avg_pool3d(F.pad(m.float()[None, None], (1,) * 6,
                            mode="replicate"), 3, stride=1)
    return (sm[0, 0] > 0.9).float()


def merge_features(use_mask: bool, pred_fixed: torch.Tensor,
                   pred_moving: torch.Tensor,
                   mask_fixed: np.ndarray | None,
                   mask_moving: np.ndarray | None,
                   fixed_img: np.ndarray, moving_img: np.ndarray):
    """Returns (mind_fixed, mind_moving, merged_fixed, merged_moving) on
    the features' device; merged = MIND (12 channels) || network features
    (1, H, W, D, 12 + C). Masks and images are (H, W, D) arrays."""
    dev = pred_fixed.device

    def vol(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    fixed, moving = vol(fixed_img), vol(moving_img)
    if use_mask:
        mf, mm = vol(mask_fixed), vol(mask_moving)
        fixed = _edt_infill(fixed, _smooth_mask(mf))
        moving = _edt_infill(moving, _smooth_mask(mm))
        pred_fixed = pred_fixed * mf[None, ..., None]
        pred_moving = pred_moving * mm[None, ..., None]
    mind_fixed = mindssc(fixed[None, ..., None], 1, 2)
    mind_moving = mindssc(moving[None, ..., None], 1, 2)
    merged_fixed = torch.cat([mind_fixed, pred_fixed.float()], dim=-1)
    merged_moving = torch.cat([mind_moving, pred_moving.float()], dim=-1)
    return mind_fixed, mind_moving, merged_fixed, merged_moving
