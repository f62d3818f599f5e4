"""Correlation volume and coupled convex solver, ConvexAdam's stage 1 (the
port of `anatomix_tpu/registration/correlate.py`).

As in the reference and the JAX package:

* the displacements are flattened as f = sd * K^2 + sw * K + sh, and the
  mesh's channels are (dH, dW, dD);
* each SSD slice is smoothed twice by a 3^3 zero-padded box mean
  (`count_include_pad`);
* the coupled penalty accumulates: iteration j optimises the SSD plus the
  sum of every penalty up to j (the reference adds each into the SSD
  volume in place).

The SSD volume lies displacement-first, (K^3, H', W', D'), which is the
public layout and a plain NCDHW volume for the box mean.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

COUPLED_COEFFS = (0.003, 0.01, 0.03, 0.1, 0.3, 1.0)


def displacement_mesh(disp_hw: int) -> np.ndarray:
    """(K^3, 3) f32 table of displacements in grid units, channels (dH,
    dW, dD), in `correlate`'s flat order."""
    K = 2 * disp_hw + 1
    rng = np.arange(K) - disp_hw
    sd, sw, sh = np.meshgrid(rng, rng, rng, indexing="ij")
    return np.stack(
        [sh.reshape(-1), sw.reshape(-1), sd.reshape(-1)], axis=-1
    ).astype(np.float32)


def correlate(feat_fix: torch.Tensor, feat_mov: torch.Tensor,
              disp_hw: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force SSD over the (2 hw + 1)^3 displacement search of the
    grid-spaced features (1, H', W', D', C); the moving features are zero
    padded. Returns (ssd (K^3, H', W', D') f32, argmin (H', W', D')
    int64, the first minimum on ties)."""
    K = 2 * disp_hw + 1
    _, H, W, D, _ = feat_fix.shape
    fix = feat_fix[0].float()
    p = disp_hw
    mov_pad = F.pad(feat_mov[0].float(), (0, 0, p, p, p, p, p, p))
    ssd = torch.empty((K ** 3, H, W, D), device=fix.device)
    f = 0
    for sd in range(K):
        for sw in range(K):
            for sh in range(K):
                mov_s = mov_pad[sh:sh + H, sw:sw + W, sd:sd + D]
                ssd[f] = ((fix - mov_s) ** 2).sum(dim=-1)
                f += 1
    # double 3^3 zero-padded box smoothing of every slice
    for _ in range(2):
        ssd = F.avg_pool3d(ssd[None], 3, stride=1, padding=1,
                           count_include_pad=True)[0]
    return ssd, ssd.argmin(dim=0)


def _soft_from_argmin(argmin: torch.Tensor,
                      disp_mesh: torch.Tensor) -> torch.Tensor:
    """The mesh's displacement at each argmin, box-smoothed (3^3, zero
    padded): (3, H', W', D')."""
    disp = disp_mesh[argmin].permute(3, 0, 1, 2)
    return F.avg_pool3d(disp[None], 3, stride=1, padding=1,
                        count_include_pad=True)[0]


def coupled_convex(ssd: torch.Tensor, ssd_argmin: torch.Tensor,
                   disp_mesh: torch.Tensor,
                   coeffs=COUPLED_COEFFS) -> torch.Tensor:
    """Iterative discrete-continuous regularisation of `correlate`'s
    volume. `disp_mesh` is `displacement_mesh`'s table as a tensor on the
    SSD's device. Returns the field (1, H', W', D', 3) in grid units,
    channels (dH, dW, dD)."""
    mesh = disp_mesh.float()[:, :, None, None, None]  # (K^3, 3, 1, 1, 1)
    soft = _soft_from_argmin(ssd_argmin, disp_mesh)
    acc = ssd
    for coeff in coeffs:
        # ||mesh_f - soft(x)||^2, summed over the three channels in order
        pen = ((mesh[:, 0] - soft[0]) ** 2 + (mesh[:, 1] - soft[1]) ** 2
               + (mesh[:, 2] - soft[2]) ** 2)
        acc = acc + coeff * pen
        soft = _soft_from_argmin(acc.argmin(dim=0), disp_mesh)
    return soft.permute(1, 2, 3, 0)[None]
