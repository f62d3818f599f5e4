"""Synthetic-data core utilities (numpy/scipy, offline CPU pipeline).

The port's copy of `anatomix_tpu/synthgen/core.py`, the reference's
`synthetic-data-generation/datagen_utils.py`: SynthMorph-style multi-scale
Perlin noise, voxel spheres + deformed-sphere foreground masks, random
affine template transforms, foreground crop+pad, GMM intensity sampling.
All of it runs on the host CPU (like the reference's ProcessPoolExecutor
pipeline).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def minmax(arr):
    return (arr - arr.min()) / (arr.max() - arr.min())


def transform_uniform(arr, minval, maxval):
    """Map uniform [0,1] samples to [minval, maxval]
    (`datagen_utils.py:649-654`)."""
    arr = np.asarray(arr)
    assert arr.min() >= 0 and arr.max() <= 1
    return arr * (maxval - minval) + minval


def rescale_coords(arrsize: int) -> np.ndarray:
    """[-1, 1] coordinates (`datagen_utils.py:330-337`)."""
    return 2 * (np.arange(arrsize) - ((arrsize - 1) / 2)) / (arrsize - 1)


def generate_grid_unit(imgshape):
    """Unit coordinate grid (D, H, W, 3) with (x, y, z) channel order
    (`datagen_utils.py:340-369`)."""
    x = rescale_coords(imgshape[0])
    y = rescale_coords(imgshape[1])
    z = rescale_coords(imgshape[2])
    grid = np.rollaxis(np.array(np.meshgrid(z, y, x)), 0, 4)
    grid = np.swapaxes(grid, 0, 2)
    grid = np.swapaxes(grid, 1, 2)
    return grid.astype(np.float32)


def generate_voxel_sphere(radius, array_shape, center_shift=None):
    """Binary sphere, optionally center-shifted (`datagen_utils.py:142-248`)."""
    center = [s // 2 for s in array_shape]
    if center_shift is not None:
        center = [c + int(s) for c, s in zip(center, center_shift)]
    coords = np.meshgrid(
        *[np.arange(s) for s in array_shape], indexing="ij"
    )
    dist = np.sqrt(sum((c - ctr) ** 2 for c, ctr in zip(coords, center)))
    return (dist <= radius).astype(np.float32)


def _zoom_to(arr, out_shape):
    """Trilinear zoom to `out_shape` (torch F.interpolate(scale) analog)."""
    factors = [o / s for o, s in zip(out_shape, arr.shape)]
    return ndimage.zoom(arr, factors, order=1, mode="nearest",
                        grid_mode=False)


def draw_perlin(
    out_shape,
    scales,
    min_std: float = 0.0,
    max_std: float = 1.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Multi-scale Perlin-like noise (SynthMorph, arXiv:2004.10282;
    `datagen_utils.py:251-318,535-597`): per scale, draw a coarse Gaussian
    grid with std ~ U(min_std, max_std) and trilinearly upsample; sum."""
    rng = rng or np.random.default_rng()
    out_shape = tuple(int(s) for s in out_shape)
    if np.isscalar(scales):
        scales = [scales]
    out = np.zeros(out_shape, np.float32)
    for scale in scales:
        sample_shape = tuple(
            int(np.ceil(s / scale)) for s in out_shape
        )
        std = rng.uniform(min_std, max_std)
        gauss = (std * rng.standard_normal(sample_shape)).astype(np.float32)
        out += gauss if scale == 1 else _zoom_to(gauss, out_shape).astype(
            np.float32
        )
    return out


def draw_perlin_deformation(out_shape, scales, min_std=0.0, max_std=1.0,
                            rng=None):
    """(3, D, H, W) deformation field — one Perlin field per component."""
    rng = rng or np.random.default_rng()
    comps = [
        draw_perlin(out_shape[1:], scales, min_std, max_std, rng)
        for _ in range(out_shape[0])
    ]
    return np.stack(comps, axis=0)


def sample_corruption(
    arrsize=(128, 128, 128),
    min_std: float = 1.0,
    max_std: float = 5.0,
    scales=(8, 16, 32),
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Perlin-deformed random sphere foreground mask
    (`datagen_utils.py:371-447`). Returns float (D, H, W), values {0, 1}
    marking OUTSIDE-sphere (matching the reference's inverted sphere)."""
    rng = rng or np.random.default_rng()
    size_ratio = arrsize[0] / 128
    radius = rng.integers(round(48 * size_ratio), round(72 * size_ratio))
    center_shift = rng.integers(
        -round(32 * size_ratio), round(32 * size_ratio), size=3
    )
    initial = np.abs(
        1 - generate_voxel_sphere(radius, arrsize, center_shift)
    )

    randdef = draw_perlin_deformation(
        (3,) + tuple(arrsize),
        [s * size_ratio for s in scales],
        min_std * size_ratio,
        max_std * size_ratio,
        rng,
    )
    # reference converts displacements to normalized units then grid_samples
    # (nearest, reflection padding); equivalently sample at voxel coords
    # displaced by the raw field with scipy's reflect mode. The reference's
    # grid channels are (x, y, z) over torch dims (D, H, W) => component i
    # of randdef displaces axis (2 - i) — but since components are iid
    # Perlin fields, displacing axis i by component i is
    # distribution-identical; we keep the direct mapping.
    coords = np.meshgrid(
        *[np.arange(s) for s in arrsize], indexing="ij"
    )
    sample_at = [
        coords[i].astype(np.float32) + randdef[i] for i in range(3)
    ]
    out = ndimage.map_coordinates(
        initial, sample_at, order=0, mode="reflect"
    )
    return out.astype(np.float32)


def apply_random_affine_transform(
    volume: np.ndarray,
    rscale: float = 0.5,
    rrotation: float = 180.0,
    rtranslation: float = 0.0,
    rshear: float = 0.5,
    mode: str = "nearest",
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Random affine (scale·rotation·shear + reflections) via scipy
    `affine_transform`, order 0 (`datagen_utils.py:60-82`)."""
    rng = rng or np.random.default_rng()
    scale = rng.uniform(1.0 - rscale, 1.0 + rscale, 3)
    rotation = np.deg2rad(rng.uniform(-rrotation, rrotation, 3))
    shear = rng.uniform(-rshear, rshear, 3)
    reflection = rng.choice([True, False], 3)

    cx, cy, cz = np.cos(rotation)
    sx, sy, sz = np.sin(rotation)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    rotation_matrix = Rz @ Ry @ Rx

    scale_matrix = np.diag(scale)
    for i in range(3):
        if reflection[i]:
            scale_matrix[i, i] *= -1
    shear_matrix = np.eye(3)
    shear_matrix[np.triu_indices(3, k=1)] = shear

    matrix = scale_matrix @ rotation_matrix @ shear_matrix
    center = (np.asarray(volume.shape) - 1) / 2.0
    offset = center - matrix @ center
    return ndimage.affine_transform(
        volume, matrix, offset=offset, mode=mode, cval=0.0, order=0
    )


def crop_and_pad_3d_volume(volume: np.ndarray, target_size) -> np.ndarray:
    """Crop to the foreground bounding box, then center-pad to target
    (`datagen_utils.py:85-139`)."""
    fg = np.argwhere(volume > 0)
    if len(fg) == 0:
        return np.zeros(target_size, volume.dtype)
    lo = fg.min(axis=0)
    hi = fg.max(axis=0) + 1
    cropped = volume[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    # crop any dimension larger than target
    cropped = cropped[
        : target_size[0], : target_size[1], : target_size[2]
    ]
    pads = []
    for s, t in zip(cropped.shape, target_size):
        diff = t - s
        pads.append((diff // 2, diff - diff // 2))
    return np.pad(cropped, pads, mode="constant")


def sample_gmm(
    means, stds, label_map, zero_bckgnd: float = 0.25, rng=None
) -> np.ndarray:
    """GMM intensity image from a label map (`datagen_utils.py:603-646`):
    per label, N(mean_i, std_i); background zeroed `zero_bckgnd` of the
    time; clipped at 0 and min-max normalized."""
    rng = rng or np.random.default_rng()
    labels = np.unique(label_map)
    synth = np.zeros(label_map.shape, np.float32)
    for i, label in enumerate(labels):
        if i == 0 and rng.random() < zero_bckgnd:
            continue
        mask = label_map == label
        synth[mask] = (
            stds[i] * rng.standard_normal(int(mask.sum())) + means[i]
        ).astype(np.float32)
    synth = np.clip(synth, 0, None)
    return minmax(synth)


def median_filter_labels(arr: np.ndarray) -> np.ndarray:
    """skimage-style median with the default cross-shaped 3D footprint."""
    footprint = ndimage.generate_binary_structure(3, 1)
    return ndimage.median_filter(arr, footprint=footprint)


def ball(radius: int) -> np.ndarray:
    """skimage.morphology.ball equivalent."""
    r = int(radius)
    coords = np.meshgrid(*[np.arange(-r, r + 1)] * 3, indexing="ij")
    return (sum(c ** 2 for c in coords) <= r ** 2)


def dilation(mask: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    return ndimage.grey_dilation(
        mask, footprint=footprint, mode="nearest"
    ) if mask.dtype != bool else ndimage.binary_dilation(
        mask, structure=footprint
    )


def erosion(mask: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    return ndimage.grey_erosion(
        mask, footprint=footprint, mode="nearest"
    ) if mask.dtype != bool else ndimage.binary_erosion(
        mask, structure=footprint
    )
