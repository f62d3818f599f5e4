"""Seeded weights and volumes, made on the run's device.

Everything a run feeds the program comes from `--seed` through these
functions, so the same seed gives the same weights and inputs. Weights come
from one large normal draw on the device, cut into the leaves and scaled;
the volumes from a few draws each, smoothed on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one use (`stream`) of one seed; seeds
    of any size fold into the 64 bits the generator takes."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def unet_weights(shapes: dict[str, tuple[int, ...]], norm: str, seed: int,
                 device) -> dict[str, torch.Tensor]:
    """A reference-keyed float32 state dict: convs He-normal (std
    sqrt(2 / fan_in)), conv biases N(0, 0.05); batch norms with scale
    1 + N(0, 0.1), bias N(0, 0.1), running mean N(0, 0.1) and running
    variance exp(N(0, 0.3)), so folding them changes every conv."""
    total = sum(math.prod(s) for s in shapes.values())
    draw = torch.randn(total, generator=generator(seed, 1, device),
                       device=device)
    sd: dict[str, torch.Tensor] = {}
    at = 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        z = draw[at:at + n].view(shape)
        at += n
        name = key.rsplit(".", 1)[1]
        if len(shape) == 5:
            v = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif norm != "batch":  # a conv bias
            v = 0.05 * z
        elif name == "weight":
            v = 1.0 + 0.1 * z
        elif name == "running_var":
            v = torch.exp(0.3 * z)
        else:
            v = 0.1 * z
        sd[key] = v.contiguous()
    return sd


def structured_volume(size, seed: int, index: int, device) -> np.ndarray:
    """One seeded anatomy-like volume `(1, D, H, W, 1)` float32 in [0, 1]
    on the host: a smooth random field cut into four tissue classes of
    distinct intensity, a smooth bias field, and noise; then min-max
    normalised as the extraction CLI does."""
    g = generator(seed, 100 + index, device)
    size = tuple(size)
    coarse = tuple(max(2, s // 16) for s in size)
    field = torch.randn((1, 1) + coarse, generator=g, device=device)
    field = F.interpolate(field, size=size, mode="trilinear",
                          align_corners=False)[0, 0]
    q = torch.quantile(field.flatten()[::97], torch.tensor(
        [0.25, 0.5, 0.75], device=device))
    labels = torch.bucketize(field, q)
    levels = torch.rand(4, generator=g, device=device)
    vol = levels[labels]
    bias = torch.randn((1, 1, 2, 2, 2), generator=g, device=device)
    bias = F.interpolate(bias, size=size, mode="trilinear",
                         align_corners=False)[0, 0]
    vol = vol * (1.0 + 0.1 * bias)
    vol = vol + 0.03 * torch.randn(size, generator=g, device=device)
    vol = (vol - vol.min()) / (vol.max() - vol.min())
    return vol[None, ..., None].float().cpu().numpy()


def structured_pair(size, seed: int, index: int, device):
    """One seeded multimodal pair of raw (H, W, D) float32 host volumes: a
    four-class label phantom from a smooth random field; the fixed image
    maps the classes to one set of intensities, the moving image warps the
    labels by a smooth random field of a few voxels and maps them to
    another set; both get a bias field and noise."""
    g = generator(seed, 200 + index, device)
    size = tuple(size)
    coarse = tuple(max(2, s // 16) for s in size)

    def smooth(shape_c, n):
        f = torch.randn((1, n) + shape_c, generator=g, device=device)
        return F.interpolate(f, size=size, mode="trilinear",
                             align_corners=False)

    field = smooth(coarse, 1)[0, 0]
    q = torch.quantile(field.flatten()[::97], torch.tensor(
        [0.25, 0.5, 0.75], device=device))
    labels = torch.bucketize(field, q).float()
    disp = 3.0 * smooth(tuple(max(2, s // 32) for s in size), 3)
    axes = [(torch.arange(s, dtype=torch.float32, device=device) + 0.5)
            * (2.0 / s) - 1.0 for s in size]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    grid = torch.stack([xx, yy, zz], dim=-1)[None]
    scale = torch.tensor([2.0 / s for s in reversed(size)], device=device)
    grid = grid + disp[0].permute(1, 2, 3, 0).flip(-1) * scale
    moved = F.grid_sample(labels[None, None], grid, mode="nearest",
                          padding_mode="border", align_corners=False)[0, 0]
    out = []
    for lab in (labels, moved):
        levels = torch.rand(4, generator=g, device=device)
        img = levels[lab.long()]
        img = img * (1.0 + 0.1 * smooth((2, 2, 2), 1)[0, 0])
        img = img + 0.02 * torch.randn(size, generator=g, device=device)
        out.append(img.float().cpu().numpy())
    return out[0], out[1]
