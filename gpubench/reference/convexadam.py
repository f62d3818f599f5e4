"""Plain ConvexAdam registration on merged features, the benchmark's reference.

A frozen copy, in plain float32 torch, of the registration the program
runs without masks (the anatomix port's `registration/{mind,merge,
correlate,solver,warp}.py`, `ops/grid_sample.py`, `ops/pool.py` and
`ops/resize.py` as they stood when this benchmark was written; Siebert,
Hansen and Heinrich, "Fast 3D registration with accurate optimisation and
little learning", 2021): MIND-SSC (12 channels, radius 1, dilation 2) of
each raw image joined to its scaled network features; both pooled to the
grid spacing; stage 1: a brute-force SSD over the (2 hw + 1)^3 search,
coupled convex regularisation, inverse consistency over 15 iterations and
a trilinear resize; stage 2: Adam on the field at the `grid_sp_adam` grid
(box-smoothed three times, a diffusion regulariser plus 12 x the mean
squared feature difference at the sampled positions), resized back.
Volumes are channels-last (1, H, W, D, C); fields (1, H, W, D, 3) in
voxels, channels (dH, dW, dD). It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SIX = np.array(
    [[0, 1, 1], [1, 1, 0], [1, 0, 1], [1, 1, 2], [2, 1, 1], [1, 2, 1]],
    dtype=np.int64)
_PERM = np.array([6, 8, 1, 11, 2, 10, 0, 7, 9, 4, 5, 3])
COUPLED_COEFFS = (0.003, 0.01, 0.03, 0.1, 0.3, 1.0)


def _shift_pairs():
    diff = _SIX[:, None, :] - _SIX[None, :, :]
    dist = (diff ** 2).sum(-1)
    x, y = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    mask = ((x > y) & (dist == 2)).reshape(-1)
    idx1 = np.repeat(_SIX[:, None, :], 6, axis=1).reshape(-1, 3)[mask]
    idx2 = np.repeat(_SIX[None, :, :], 6, axis=0).reshape(-1, 3)[mask]
    return idx1, idx2


def mindssc(img: torch.Tensor, radius: int = 1,
            dilation: int = 2) -> torch.Tensor:
    """(1, H, W, D, 1) -> (1, H, W, D, 12) f32."""
    H, W, D = img.shape[1:4]
    d = dilation
    pad = F.pad(img.permute(0, 4, 1, 2, 3).float(), (d,) * 6,
                mode="replicate")

    def shifted(offset):
        oz, oy, ox = (int(o) * d for o in offset)
        return pad[:, :, oz:oz + H, oy:oy + W, ox:ox + D]

    idx1, idx2 = _shift_pairs()
    diff2 = torch.cat([shifted(a) - shifted(b) for a, b in zip(idx1, idx2)],
                      dim=1) ** 2
    k = 2 * radius + 1
    ssd = F.avg_pool3d(F.pad(diff2, (radius,) * 6, mode="replicate"), k,
                       stride=1)
    mind = ssd - ssd.amin(dim=1, keepdim=True)
    var = mind.mean(dim=1, keepdim=True)
    m = var.mean()
    var = torch.clamp(var, m * 0.001, m * 1000.0)
    mind = torch.exp(-mind / var)
    perm = torch.as_tensor(_PERM, device=mind.device)
    return mind[:, perm].permute(0, 2, 3, 4, 1)


def _avg_pool(x, w):
    y = F.avg_pool3d(x.permute(0, 4, 1, 2, 3).float(), w, w)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _box(x, k, repeats):
    for _ in range(repeats):
        p = k // 2
        y = F.pad(x.permute(0, 4, 1, 2, 3).float(), (p,) * 6)
        x = F.avg_pool3d(y, k, 1).permute(0, 2, 3, 4, 1)
    return x


def _resize(x, size):
    if tuple(size) == tuple(x.shape[1:4]):
        return x
    y = F.interpolate(x.permute(0, 4, 1, 2, 3).float(), size=tuple(size),
                      mode="trilinear", align_corners=False)
    return y.permute(0, 2, 3, 4, 1)


def _sample(vol, grid):
    out = F.grid_sample(vol.permute(0, 4, 1, 2, 3), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 4, 1)


def _identity(spatial, device):
    axes = [(torch.arange(s, dtype=torch.float32, device=device) + 0.5)
            * (2.0 / s) - 1.0 for s in spatial]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)[None]


def _flip(x):
    return torch.flip(x, dims=(-1,))


def _mesh(disp_hw, device):
    K = 2 * disp_hw + 1
    r = np.arange(K) - disp_hw
    sd, sw, sh = np.meshgrid(r, r, r, indexing="ij")
    m = np.stack([sh.reshape(-1), sw.reshape(-1), sd.reshape(-1)], axis=-1)
    return torch.as_tensor(m.astype(np.float32), device=device)


def _keep(x, dtype):
    """`x` held in `dtype` (a control in a lower precision), as f32."""
    return x if dtype is None else x.to(dtype).float()


def _correlate(fix, mov, disp_hw, dtype=None):
    K = 2 * disp_hw + 1
    _, H, W, D, _ = fix.shape
    p = disp_hw
    f = fix[0].float()
    mp = F.pad(mov[0].float(), (0, 0, p, p, p, p, p, p))
    ssd = torch.empty((K ** 3, H, W, D), device=f.device)
    i = 0
    for sd in range(K):
        for sw in range(K):
            for sh in range(K):
                ssd[i] = ((f - mp[sh:sh + H, sw:sw + W, sd:sd + D]) ** 2
                          ).sum(dim=-1)
                i += 1
    for _ in range(2):
        ssd = _keep(F.avg_pool3d(ssd[None], 3, stride=1, padding=1,
                                 count_include_pad=True)[0], dtype)
    return ssd, ssd.argmin(dim=0)


def _soft(argmin, mesh):
    disp = mesh[argmin].permute(3, 0, 1, 2)
    return F.avg_pool3d(disp[None], 3, stride=1, padding=1,
                        count_include_pad=True)[0]


def _coupled_convex(ssd, argmin, mesh):
    m = mesh[:, :, None, None, None]
    soft = _soft(argmin, mesh)
    acc = ssd
    for c in COUPLED_COEFFS:
        pen = ((m[:, 0] - soft[0]) ** 2 + (m[:, 1] - soft[1]) ** 2
               + (m[:, 2] - soft[2]) ** 2)
        acc = acc + c * pen
        soft = _soft(acc.argmin(dim=0), mesh)
    return soft.permute(1, 2, 3, 0)[None]


def _inverse_consistency(d1, d2, iterations):
    ident = _identity(d1.shape[1:4], d1.device)
    for _ in range(iterations):
        s2 = _sample(d2, ident + d1)
        s1 = _sample(d1, ident + d2)
        d1, d2 = 0.5 * (d1 - s2), 0.5 * (d2 - s1)
    return d1


def stage1(fix, mov, disp_hw, grid_sp, sizes, dtype=None):
    H, W, D = sizes
    mesh = _mesh(disp_hw, fix.device)
    ssd, am = _correlate(fix, mov, disp_hw, dtype)
    fwd = _coupled_convex(ssd, am, mesh)
    ssd_b, am_b = _correlate(mov, fix, disp_hw, dtype)
    bwd = _coupled_convex(ssd_b, am_b, mesh)
    scale = torch.tensor([H // grid_sp - 1, W // grid_sp - 1,
                          D // grid_sp - 1], dtype=torch.float32,
                         device=fix.device) / 2.0
    d = _inverse_consistency(_flip(fwd / scale), _flip(bwd / scale), 15)
    return _resize(_flip(d) * scale * grid_sp, (H, W, D))


def instance_opt(disp_hr, feat_fix, feat_mov, grid_sp_adam, lambda_weight,
                 niter, dtype=None):
    H, W, D = feat_fix.shape[1:4]
    g = grid_sp_adam
    Hg, Wg, Dg = H // g, W // g, D // g
    dev = feat_fix.device
    with torch.no_grad():
        pf = _keep(_avg_pool(feat_fix, g), dtype)
        pm = _keep(_avg_pool(feat_mov, g), dtype)
        low = _resize(disp_hr, (Hg, Wg, Dg))
    w = (low / g).contiguous().requires_grad_(True)
    scale = torch.tensor([(Hg - 1) / 2.0, (Wg - 1) / 2.0, (Dg - 1) / 2.0],
                         dtype=torch.float32, device=dev)
    grid0 = _identity((Hg, Wg, Dg), dev)
    opt = torch.optim.Adam([w], lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    fitted = w.detach().clone()
    with torch.enable_grad():
        for _ in range(niter):
            opt.zero_grad(set_to_none=True)
            ds = _box(w, 3, 3)
            d = ds[0]
            reg = lambda_weight * (((d[:, 1:] - d[:, :-1]) ** 2).mean()
                                   + ((d[1:] - d[:-1]) ** 2).mean()
                                   + ((d[:, :, 1:] - d[:, :, :-1]) ** 2
                                      ).mean())
            sampled = _keep(_sample(pm, grid0 + _flip(ds / scale)), dtype)
            cost = ((sampled - pf) ** 2).mean(dim=-1) * 12.0
            (cost.mean() + reg).backward()
            fitted = ds.detach()
            opt.step()
    return _resize(fitted * g, (H, W, D))


def merged_features(img: torch.Tensor, feat: torch.Tensor,
                    downscale_feat_scalar: float) -> torch.Tensor:
    """MIND-SSC of a raw image (H, W, D) joined to its network features
    (1, H, W, D, C) scaled: (1, H, W, D, 12 + C) f32."""
    return torch.cat([mindssc(img.float()[None, ..., None]),
                      feat.float() * downscale_feat_scalar], dim=-1)


def solve(ff: torch.Tensor, fm: torch.Tensor, *, grid_sp: int,
          disp_hw: int, grid_sp_adam: int, lambda_weight: float,
          niter: int, solver_dtype: torch.dtype | None = None
          ) -> torch.Tensor:
    """The field of one pair from its merged features. `solver_dtype`
    holds the pooled features, the SSD volume and the sampled features in
    that type (a control in a lower precision)."""
    H, W, D = ff.shape[1:4]
    dt = solver_dtype
    disp = stage1(_keep(_avg_pool(ff, grid_sp), dt),
                  _keep(_avg_pool(fm, grid_sp), dt), disp_hw, grid_sp,
                  (H, W, D), dt)
    return instance_opt(disp, ff, fm, grid_sp_adam, lambda_weight, niter,
                        dt)
