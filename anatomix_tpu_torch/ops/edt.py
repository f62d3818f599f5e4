"""Exact Euclidean distance and feature transform on the device (the port
of `anatomix_tpu/ops/edt.py`).

It stands in for the reference's host call to scipy's
`distance_transform_edt(mask == 0, return_indices=True)` in the masked
feature merge: the nearest foreground voxel of every voxel, and the squared
distance to it.

The squared EDT is separable, so it factors into three 1-D min-plus passes,

    pass over axis a:   out[i] = min_j ( (i - j)^2 + cost[j] ),

each computed exactly in int32 by a brute-force min over j, vectorised over
all other voxels and chunked over the output index i (16 at a time: one
chunk at the 96^3 subsample of a 192^3 volume is (16, 96, 96^2) int32, 56
MB). The nearest-voxel indices ride through the passes: pass a yields the
argmin j along axis a, and the indices found by the earlier passes are
gathered at that j. Ties go to the smallest j (`min`'s first minimum, as
`jnp.argmin`'s), so indices and distances equal the JAX package's bit for
bit; scipy may pick another voxel at the same distance.
"""

from __future__ import annotations

import torch

# Int32 "infinity": three passes each add at most (n - 1)^2 <= 2^22 for
# n <= 2049, so 2^30 + 3 * 2^22 < 2^31 never overflows.
_INF = 1 << 30
_CHUNK = 16


def _minplus_pass(cost: torch.Tensor,
                  axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One exact squared-distance pass along `axis` of the int32 `cost`:
    returns (new_cost, argmin_j), argmin_j int64, the first minimum on
    ties."""
    c = cost.movedim(axis, 0)
    n = c.shape[0]
    j = torch.arange(n, dtype=torch.int32, device=c.device)
    best = torch.empty_like(c)
    arg = torch.empty(c.shape, dtype=torch.int64, device=c.device)
    tail = (1,) * (c.ndim - 1)
    for i0 in range(0, n, _CHUNK):
        i = torch.arange(i0, min(i0 + _CHUNK, n), dtype=torch.int32,
                         device=c.device)
        d2 = ((i[:, None] - j[None, :]) ** 2).reshape(len(i), n, *tail)
        best[i0:i0 + len(i)], arg[i0:i0 + len(i)] = (d2 + c[None]).min(dim=1)
    return best.movedim(0, axis), arg.movedim(0, axis)


def edt_feature_transform(
        mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-foreground-voxel transform of a 3-D mask, exact.

    mask: (X, Y, Z), nonzero = foreground. Returns (idx, dist2): idx
    (3, X, Y, Z) int32, the coordinates of the nearest foreground voxel of
    every voxel, and dist2 the int32 squared Euclidean distance to it. With
    an empty mask every distance is >= 2^30 and the indices mean nothing.
    """
    cost = torch.where(mask != 0, 0, _INF).to(torch.int32)
    cost, fx = _minplus_pass(cost, 0)
    cost, fy = _minplus_pass(cost, 1)
    # after the y pass the nearest point is (fx[x, y', z], y', z), y' = fy
    fx = torch.take_along_dim(fx, fy, dim=1)
    cost, fz = _minplus_pass(cost, 2)
    fx = torch.take_along_dim(fx, fz, dim=2)
    fy = torch.take_along_dim(fy, fz, dim=2)
    return torch.stack([fx, fy, fz]).to(torch.int32), cost


def edt_infill(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each out-of-mask voxel of `img` (X, Y, Z) takes the value of its
    nearest in-mask voxel; in-mask voxels keep theirs."""
    idx, _ = edt_feature_transform(mask)
    filled = img[idx[0].long(), idx[1].long(), idx[2].long()]
    return torch.where(mask != 0, img, filled)
