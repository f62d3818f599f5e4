"""MIND-SSC self-similarity descriptor, 12 channels (the port of
`anatomix_tpu/registration/mind.py`; Heinrich et al., MICCAI 2013).

The reference builds its 12 neighbour-pair shifts as one-hot 3^3 conv
kernels; a one-hot kernel is a shift, so each shifted volume here is a
slice of the replicate-padded volume. Volumes are channels-last
(1, H, W, D, C); the descriptor keeps the reference's channel permutation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# The fixed 6-neighbourhood and its 12 (shift1, shift2) pairs at squared
# distance 2, upper triangle, built as the reference builds them.
_SIX = np.array(
    [[0, 1, 1], [1, 1, 0], [1, 0, 1], [1, 1, 2], [2, 1, 1], [1, 2, 1]],
    dtype=np.int64,
)


def _shift_pairs() -> tuple[np.ndarray, np.ndarray]:
    diff = _SIX[:, None, :] - _SIX[None, :, :]
    dist = (diff ** 2).sum(-1)
    x, y = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    mask = ((x > y) & (dist == 2)).reshape(-1)
    idx1 = np.repeat(_SIX[:, None, :], 6, axis=1).reshape(-1, 3)[mask]
    idx2 = np.repeat(_SIX[None, :, :], 6, axis=0).reshape(-1, 3)[mask]
    return idx1, idx2


_IDX1, _IDX2 = _shift_pairs()
# the channel order of the original C++ implementation
_PERM = np.array([6, 8, 1, 11, 2, 10, 0, 7, 9, 4, 5, 3])


def mindssc(img: torch.Tensor, radius: int = 2,
            dilation: int = 2) -> torch.Tensor:
    """12-channel MIND-SSC of a (1, H, W, D, 1) volume -> (1, H, W, D, 12)
    f32. The registration pipeline calls it with radius 1, dilation 2."""
    if img.ndim != 5 or img.shape[-1] != 1:
        raise ValueError("img must be (1, H, W, D, 1)")
    H, W, D = img.shape[1:4]
    d = dilation
    # NCDHW for F.pad's replicate mode (torch's ReplicationPad3d)
    pad = F.pad(img.permute(0, 4, 1, 2, 3).float(), (d,) * 6,
                mode="replicate")

    def shifted(offset):
        oz, oy, ox = (int(o) * d for o in offset)
        return pad[:, :, oz:oz + H, oy:oy + W, ox:ox + D]

    diff2 = torch.cat([shifted(a) - shifted(b) for a, b in zip(_IDX1, _IDX2)],
                      dim=1) ** 2  # (1, 12, H, W, D)
    # patch SSD: replicate pad by the radius, then an unpadded box mean
    k = 2 * radius + 1
    ssd = F.avg_pool3d(F.pad(diff2, (radius,) * 6, mode="replicate"), k,
                       stride=1)

    mind = ssd - ssd.amin(dim=1, keepdim=True)
    mind_var = mind.mean(dim=1, keepdim=True)
    scalar_mean = mind_var.mean()
    mind_var = torch.clamp(mind_var, scalar_mean * 0.001,
                           scalar_mean * 1000.0)
    mind = torch.exp(-mind / mind_var)
    perm = torch.as_tensor(_PERM, device=mind.device)
    return mind[:, perm].permute(0, 2, 3, 4, 1)


def pdist_squared(x: np.ndarray) -> np.ndarray:
    """Pairwise squared distances between the column points of `x`
    (3, N), clipped at 0 (the reference's `pdist_squared`, in numpy)."""
    xx = (x ** 2).sum(0)
    dist = xx[:, None] + xx[None, :] - 2.0 * (x.T @ x)
    dist = np.nan_to_num(dist, nan=0.0)
    return np.clip(dist, 0.0, None)
