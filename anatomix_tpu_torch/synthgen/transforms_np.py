"""Numpy intensity-corruption chain for step-2 paired-view synthesis.

The port's copy of `anatomix_tpu/synthgen/transforms_np.py`:
MONAI-equivalent transforms (the reference's `synthetic-data-generation/
datagen_utils.py:455-532`) implemented in numpy/scipy so the offline
ProcessPool pipeline needs no device: scale-intensity → bias field p=.98
(coeff ≤ .075) → k-space spike p=.2 → gamma p=.5 (.5–2) → gaussian smooth
p=.5 (σ ≤ .333) → Gibbs p=.5 (α ≤ .333) → sharpen p=.25 → nnUNet-style
low-res sim p=.333 (nearest-exact down, trilinear up) → clip ≥ 0 → rescale.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from anatomix_tpu_torch.synthgen.core import minmax


def _bias_field(shape, coeffs, degree=3):
    zs, ys, xs = [np.linspace(-1, 1, s) for s in shape]
    field = np.zeros(shape, np.float64)
    idx = 0
    for i in range(degree + 1):
        for j in range(degree + 1 - i):
            for k in range(degree + 1 - i - j):
                field += (
                    coeffs[idx]
                    * zs[:, None, None] ** i
                    * ys[None, :, None] ** j
                    * xs[None, None, :] ** k
                )
                idx += 1
    return np.exp(field)


def rand_bias_field(x, rng, coeff_range=(0.0, 0.075), degree=3):
    n = sum(
        1
        for i in range(degree + 1)
        for j in range(degree + 1 - i)
        for _ in range(degree + 1 - i - j)
    )
    coeffs = rng.uniform(coeff_range[0], coeff_range[1], n)
    return x * _bias_field(x.shape, coeffs, degree)


def rand_kspace_spike(x, rng, intensity_range=None):
    f = np.fft.fftshift(np.fft.fftn(x))
    if intensity_range is None:
        # MONAI default: relative to the log-magnitude of the k-space center
        center_mag = np.log(np.abs(f[tuple(s // 2 for s in x.shape)]) + 1e-10)
        intensity_range = (center_mag * 0.95, center_mag * 1.10)
    loc = tuple(
        rng.integers(s // 4, 3 * s // 4) for s in x.shape
    )
    intensity = rng.uniform(*intensity_range)
    phase = np.angle(f[loc])
    f[loc] = np.exp(intensity) * np.exp(1j * phase)
    return np.real(np.fft.ifftn(np.fft.ifftshift(f)))


def rand_gamma(x, rng, gamma=(0.5, 2.0)):
    g = rng.uniform(*gamma)
    lo, hi = x.min(), x.max()
    rngv = max(hi - lo, 1e-8)
    return ((x - lo) / rngv) ** g * rngv + lo


def rand_smooth(x, rng, sigma_range=(0.0, 0.333)):
    sigmas = [rng.uniform(*sigma_range) for _ in range(3)]
    return ndimage.gaussian_filter(x, sigmas, mode="nearest")


def gibbs(x, alpha):
    f = np.fft.fftshift(np.fft.fftn(x))
    mask = np.ones(x.shape, bool)
    for axis, size in enumerate(x.shape):
        coords = np.abs(np.arange(size) - (size - 1) / 2.0) / (size / 2.0)
        keep = coords <= (1.0 - alpha)
        shape = [1, 1, 1]
        shape[axis] = size
        mask &= keep.reshape(shape)
    return np.real(np.fft.ifftn(np.fft.ifftshift(f * mask)))


def rand_gibbs(x, rng, alpha_range=(0.0, 0.333)):
    return gibbs(x, rng.uniform(*alpha_range))


def rand_sharpen(
    x, rng, sigma1=(0.5, 1.0), sigma2=(0.5, 1.0), alpha=(10.0, 30.0)
):
    s1 = rng.uniform(*sigma1)
    s2 = rng.uniform(*sigma2)
    a = rng.uniform(*alpha)
    b1 = ndimage.gaussian_filter(x, s1, mode="nearest")
    b2 = ndimage.gaussian_filter(b1, s2, mode="nearest")
    return b1 + a * (b1 - b2)


def rand_low_res(x, rng, zoom_range=(0.5, 1.0)):
    zoom = rng.uniform(*zoom_range)
    small_shape = [max(int(round(s * zoom)), 1) for s in x.shape]
    # nearest-exact downsample
    idx = [
        np.clip(
            np.round((np.arange(t) + 0.5) * s / t - 0.5).astype(int), 0,
            s - 1,
        )
        for t, s in zip(small_shape, x.shape)
    ]
    small = x[np.ix_(*idx)]
    return ndimage.zoom(
        small, [s / t for s, t in zip(x.shape, small_shape)], order=1,
        mode="nearest", grid_mode=False,
    )


def view_corruption_chain(x: np.ndarray, rng: np.random.Generator):
    """The full step-2 per-view chain; input any range, output in [0, 1]."""
    x = minmax(np.asarray(x, np.float64))
    if rng.random() < 0.98:
        x = rand_bias_field(x, rng)
    if rng.random() < 0.2:
        x = rand_kspace_spike(x, rng)
    if rng.random() < 0.5:
        x = rand_gamma(x, rng)
    if rng.random() < 0.5:
        x = rand_smooth(x, rng)
    if rng.random() < 0.5:
        x = rand_gibbs(x, rng)
    if rng.random() < 0.25:
        x = rand_sharpen(x, rng)
    if rng.random() < 0.333:
        x = rand_low_res(x, rng)
    x = np.clip(x, 0.0, None)
    return minmax(x).astype(np.float32)
