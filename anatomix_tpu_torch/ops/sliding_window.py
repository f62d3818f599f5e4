"""Sliding-window inference with Gaussian-blend stitching, MONAI semantics.

The port of `anatomix_tpu/ops/sliding_window.py`: the reference's
whole-volume feature extraction runs 128^3 windows at overlap 0.8 with
Gaussian blending (sigma_scale 0.25) and sw_batch 2. Window starts, the
importance map with MONAI's `max(min_nonzero, 1e-3)` clamp, the blend
weight map, the symmetric zero pad to roi and the final `acc / weight` crop
follow the JAX functions of the same names. Windows go through the model in
chunks of `sw_batch_size`; every chunk is stitched into the `(D, H, W, C)`
f32 canvas by the `blend_scatter` kernel (its plain version on the CPU).
A window function may return its windows as the folded rows `(B, r0, r1,
r2 C / 128, 128)` (the ViT's fold exit, f32 or bf16): they are the same
bytes as `(B, r0, r1, r2, C)`, taken as a view. `record_function` ranges
(opened only while a profiler runs, `utils/profiling.annotate`):
`sliding/setup` (the pad to roi, window starts, the blend weight map, the
copies to the device and the canvas; the Gaussian maps are made once per
roi, sigma, mode and device, `importance_tables`, as the JAX package makes
them once per trace), then per chunk
`sliding/gather` (the stack of its windows) and `sliding/stitch` (the cast
and `blend_scatter`), and `sliding/finish` (the all-reduce on a mesh,
`acc / weight` and the crop); the window function runs outside them.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from anatomix_tpu_torch.kernels.scatter import blend_scatter
from anatomix_tpu_torch.utils.profiling import annotate


def gaussian_importance_axes(roi_size, sigma_scale: float = 0.25):
    """Per-axis factors (float64, max 1) of the MONAI Gaussian importance
    map and its clamp floor max(min_nonzero, 1e-3). The map is
    clip(outer(g0, g1, g2), minv, None)."""
    axes = []
    for size in roi_size:
        sigma = sigma_scale * size
        center = size // 2
        denom = sigma * math.sqrt(2.0)
        w = np.array([
            0.5 * (math.erf((i - center + 0.5) / denom)
                   - math.erf((i - center - 0.5) / denom))
            for i in range(size)
        ], dtype=np.float64)
        axes.append(w / w.max())
    m = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    minv = max(float(m[m > 0].min()), 1e-3)
    return axes, minv


def gaussian_importance_map(roi_size, sigma_scale: float = 0.25) -> np.ndarray:
    """MONAI-style Gaussian importance map, max 1, clamped (float32)."""
    axes, minv = gaussian_importance_axes(roi_size, sigma_scale)
    m = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    return np.clip(m, minv, None).astype(np.float32)


@functools.lru_cache(maxsize=4)
def importance_tables(roi_size: tuple, sigma_scale: float, mode: str,
                      device: torch.device):
    """The blend's tables for one roi, shared by every call that asks for
    them (read only): the importance map (f32 on `device`), its per-axis
    factors (f32 on `device`) and the clamp floor. Building the 128^3 map
    on the host takes tens of ms, the larger part of a window loop's
    host-only set-up."""
    if mode == "gaussian":
        axes, minv = gaussian_importance_axes(roi_size, sigma_scale)
        imp = gaussian_importance_map(roi_size, sigma_scale)
    elif mode == "constant":
        axes, minv = [np.ones(r) for r in roi_size], 0.0
        imp = np.ones(roi_size, np.float32)
    else:
        raise ValueError(f"Unsupported blend mode: {mode}")
    # normal tensors even when the first caller runs in inference mode, so
    # that a later caller under autograd may use them too
    with torch.inference_mode(False):
        factors = tuple(torch.as_tensor(a, dtype=torch.float32,
                                        device=device) for a in axes)
        return (torch.as_tensor(imp, dtype=torch.float32, device=device),
                factors, minv)


def compute_window_starts(image_size, roi_size, overlap: float) -> np.ndarray:
    """Dense window starts, MONAI `dense_patch_slices` semantics: per axis
    interval int(roi * (1 - overlap)) (roi if <= 0), ceil((img - roi) /
    interval) + 1 windows, the last flush with the volume edge."""
    per_axis = []
    for img, roi in zip(image_size, roi_size):
        if img <= roi:
            per_axis.append(np.array([0]))
            continue
        interval = int(roi * (1.0 - overlap))
        if interval <= 0:
            interval = roi
        count = int(math.ceil((img - roi) / interval)) + 1
        starts = np.minimum(np.arange(count) * interval, img - roi)
        per_axis.append(np.unique(starts))
    grid = np.meshgrid(*per_axis, indexing="ij")
    return np.stack([g.reshape(-1) for g in grid], axis=-1).astype(np.int32)


def blend_weight_map(image_size, starts: np.ndarray,
                     imp: np.ndarray | torch.Tensor,
                     device="cpu") -> torch.Tensor:
    """Sum of importance maps over all window placements (f32, in window
    order, on `device`)."""
    acc = torch.zeros(tuple(image_size), dtype=torch.float32, device=device)
    imp_t = torch.as_tensor(imp, dtype=torch.float32, device=device)
    r = imp.shape
    for s in starts.tolist():
        acc[s[0]:s[0] + r[0], s[1]:s[1] + r[1], s[2]:s[2] + r[2]] += imp_t
    return acc


def pad_to_roi(volume: torch.Tensor, roi_size):
    """Symmetric zero pad of (1, D, H, W, C) up to at least roi (MONAI
    `pad_nd`); returns the padded volume and the crop of each axis."""
    pads, crops = [], []
    for img, roi in zip(volume.shape[1:4], roi_size):
        diff = max(roi - img, 0)
        half = diff // 2
        pads.append((half, diff - half))
        crops.append((half, half + img))
    if any(p != (0, 0) for p in pads):
        flat = (0, 0) + tuple(v for p in reversed(pads) for v in p)
        volume = F.pad(volume, flat)
    return volume, crops


def scatter_kernel_eligible(W: int, r2: int, out_channels: int) -> bool:
    """The JAX package's `scatter_kernel_eligible`: whether a model exit may
    emit the folded `(…, r2 C / 128, 128)` window rows for the stitch. The
    port's `blend_scatter` stitches into an f32 canvas on every device (its
    plain version on the CPU), so only the shapes decide."""
    return (W * out_channels) % 128 == 0 and (r2 * out_channels) % 128 == 0


def sliding_window_inference(
    volume: torch.Tensor,
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    out_channels: int,
    *,
    roi_size=(128, 128, 128),
    sw_batch_size: int = 2,
    overlap: float = 0.8,
    mode: str = "gaussian",
    sigma_scale: float = 0.25,
    mesh=None,
    mesh_axis: str = "data",
) -> torch.Tensor:
    """`volume` (1, D, H, W, C); `apply_fn` maps windows (B, r0, r1, r2, C)
    to (B, r0, r1, r2, out_channels), or to its folded rows, f32 or bf16.
    Returns (1, D, H, W, out_channels) f32 on the volume's device.

    With a `parallel.Mesh` (every rank passing the same volume), the window
    list, padded to a multiple of `sw_batch_size` x n, is sharded over the
    mesh's `mesh_axis` group of n ranks in contiguous blocks (JAX's
    `P(mesh_axis)`); each rank stitches its windows into its own canvas
    and one all-reduce (SUM) merges the canvases before `acc / weight`
    (`anatomix_tpu/ops/sliding_window.py:342-439`). A mesh of one axis is
    sharded over that axis whatever its name."""
    if volume.dim() != 5 or volume.shape[0] != 1:
        raise ValueError("volume must be (1, D, H, W, C)")
    roi_size = tuple(roi_size)
    dev = volume.device
    with annotate("sliding/setup"):
        padded, crops = pad_to_roi(volume, roi_size)
        spatial = tuple(padded.shape[1:4])

        starts_np = compute_window_starts(spatial, roi_size, overlap)
        imp, (gd, gh, gw), minv = importance_tables(
            roi_size, float(sigma_scale), mode, dev)
        hi = np.asarray(spatial) - np.asarray(roi_size)
        if (starts_np < 0).any() or (starts_np > hi).any():
            raise ValueError("window starts out of bounds")
        weight = blend_weight_map(spatial, starts_np, imp, device=dev)

        n_real = len(starts_np)
        group, n_shards, shard = None, 1, 0
        if mesh is not None:
            if mesh_axis not in mesh.axis_names:
                if len(mesh.axis_names) != 1:
                    raise ValueError(
                        f"mesh has no '{mesh_axis}' axis (axes: "
                        f"{mesh.axis_names}); pass mesh_axis= explicitly")
                mesh_axis = mesh.axis_names[0]
            group = mesh.group(mesh_axis)
            n_shards = mesh.axis_size(mesh_axis)
            shard = mesh.axis_index(mesh_axis)
        n_group = sw_batch_size * n_shards
        n_padded = int(math.ceil(n_real / n_group)) * n_group
        starts_all = np.zeros((n_padded, 3), np.int32)
        starts_all[:n_real] = starts_np
        mask_all = np.zeros((n_padded,), np.int32)
        mask_all[:n_real] = 1
        starts_dev = torch.from_numpy(starts_all).to(dev)
        mask_dev = torch.from_numpy(mask_all).to(dev)

        r0, r1, r2 = roi_size
        vol3d = padded[0]
        canvas = torch.zeros(spatial + (out_channels,), dtype=torch.float32,
                             device=dev)
    per_shard = n_padded // n_shards
    for c0 in range(shard * per_shard, (shard + 1) * per_shard,
                    sw_batch_size):
        chunk = slice(c0, c0 + sw_batch_size)
        with annotate("sliding/gather"):
            windows = torch.stack([
                vol3d[s0:s0 + r0, s1:s1 + r1, s2:s2 + r2]
                for s0, s1, s2 in starts_all[chunk].tolist()
            ])
        out = apply_fn(windows)
        with annotate("sliding/stitch"):
            if out.dtype not in (torch.float32, torch.bfloat16):
                out = out.float()
            out = out.contiguous().view(len(windows), r0, r1, r2,
                                        out_channels)
            blend_scatter(canvas, out, starts_dev[chunk], mask_dev[chunk],
                          gd, gh, gw, minv)

    with annotate("sliding/finish"):
        if group is not None:
            dist.all_reduce(canvas, op=dist.ReduceOp.SUM, group=group)
        out = canvas / weight[..., None]
        (c0, c1), (c2, c3), (c4, c5) = crops
        return out[None, c0:c1, c2:c3, c4:c5, :]
