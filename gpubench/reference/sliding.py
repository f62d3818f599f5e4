"""Plain sliding-window inference with Gaussian blending, MONAI's semantics.

What `monai.inferers.sliding_window_inference` computes for one volume,
written out for the benchmark's reference: the volume is zero-padded
symmetrically up to the window size, windows start every
`int(roi * (1 - overlap))` voxels per axis (the last flush with the edge),
each window's output is weighted by the Gaussian importance map (sigma
`sigma_scale * roi`, the erf form of a unit impulse blurred, scaled to a
maximum of 1 and clamped below at `max(smallest nonzero value, 1e-3)`),
the weighted outputs are summed, divided by the summed weights, and the
padding is cropped. Everything is float32.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def window_starts(size: int, roi: int, overlap: float) -> list[int]:
    if size <= roi:
        return [0]
    step = int(roi * (1.0 - overlap)) or roi
    n = math.ceil((size - roi) / step) + 1
    return sorted({min(i * step, size - roi) for i in range(n)})


def gaussian_map(roi, sigma_scale: float, device) -> torch.Tensor:
    axes = []
    for r in roi:
        s = sigma_scale * r * math.sqrt(2.0)
        i = torch.arange(r, dtype=torch.float64) - r // 2
        g = 0.5 * (torch.erf((i + 0.5) / s) - torch.erf((i - 0.5) / s))
        axes.append(g / g.max())
    m = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None]
    floor = max(float(m[m > 0].min()), 1e-3)
    return m.clamp(min=floor).to(device=device, dtype=torch.float32)


def sliding_window(x: torch.Tensor, model: Callable, out_channels: int,
                   roi, overlap: float, sigma_scale: float) -> torch.Tensor:
    """`x` (1, C, D, H, W) -> (1, out_channels, D, H, W); `model` maps one
    window (1, C, r0, r1, r2) to (1, out_channels, r0, r1, r2)."""
    pads, crops = [], []
    for s, r in zip(x.shape[2:], roi):
        d = max(r - s, 0)
        pads.append((d // 2, d - d // 2))
        crops.append(slice(d // 2, d // 2 + s))
    xp = F.pad(x, tuple(v for p in reversed(pads) for v in p))
    size = xp.shape[2:]
    imp = gaussian_map(roi, sigma_scale, x.device)
    acc = torch.zeros((1, out_channels) + tuple(size), device=x.device)
    weight = torch.zeros(tuple(size), device=x.device)
    r0, r1, r2 = roi
    for a in window_starts(size[0], r0, overlap):
        for b in window_starts(size[1], r1, overlap):
            for c in window_starts(size[2], r2, overlap):
                win = xp[:, :, a:a + r0, b:b + r1, c:c + r2]
                acc[:, :, a:a + r0, b:b + r1, c:c + r2] += (
                    model(win).float() * imp)
                weight[a:a + r0, b:b + r1, c:c + r2] += imp
    out = acc / weight
    return out[(slice(None), slice(None), *crops)]
