"""3D augmentation on volumes in the JAX package's layout, (D, H, W) or
(D, H, W, C) (the port of `anatomix_tpu/ops/augment.py`): intensity
scaling, noise, Gaussian smoothing and sharpening, polynomial bias fields,
gamma, Gibbs ringing, k-space spikes, motion ghosting, low-resolution
simulation, flips, affines and crops.

Each random transform is split in two:

* the apply, a deterministic function of the drawn parameters
  (`gamma(x, g)`, `smooth_axis(x, sigma, axis, max_sigma)`,
  `motion_ghosting(x, axis, n_ghosts, intensity)`, `crop(vols, offsets,
  size)`, ...), computed in f32 as the JAX package computes it;
* the draw, `rand_*(gen, x, ...)`, which draws the parameters from `gen`
  and calls the apply.

JAX's threefry draws and torch's generators never agree, so the applies
are what is held against the JAX package, fed the parameters JAX drew.
Scalar parameters and decisions come from `gen`, a CPU `torch.Generator`
(a branch on a value drawn on the card would wait for the card); only the
noise fields are drawn on the volume's device, from `field_gen` (default
`gen`, which then must live on that device).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from anatomix_tpu_torch.ops.grid_sample import grid_sample, identity_grid


def _uniform(gen: torch.Generator, lo: float, hi: float, n: int | None = None):
    """U(lo, hi) on the host: a float, or a list of `n` floats."""
    u = torch.rand((1 if n is None else n,), generator=gen,
                   dtype=torch.float64)
    vals = [lo + (hi - lo) * float(v) for v in u]
    return vals[0] if n is None else vals


def _randint(gen: torch.Generator, lo: int, hi: int) -> int:
    """An integer of [lo, hi)."""
    return int(torch.randint(lo, hi, (1,), generator=gen))


def _f32(v, device) -> torch.Tensor:
    """An array, list or tensor of parameters as an f32 tensor on
    `device`."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(v, np.float32)).to(device)


def _field(field_gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=field_gen,
                       device=field_gen.device).to(device)


# -----------------------------------------------------------------------------
# intensity

def scale_intensity(x: torch.Tensor, *, eps: float = 1e-8) -> torch.Tensor:
    """Min-max to [0, 1] (MONAI ScaleIntensity default)."""
    lo, hi = x.min(), x.max()
    return (x - lo) / torch.clamp(hi - lo, min=eps)


def add_noise(x: torch.Tensor, field: torch.Tensor, std: float):
    """x + field * std: additive Gaussian noise from a drawn N(0, 1)
    field."""
    return x + field.to(x.dtype) * std


def rand_gaussian_noise(gen, x, *, std: float = 0.1, field_gen=None):
    """Additive N(0, u(0, std)^2) noise (MONAI RandGaussianNoise)."""
    s = _uniform(gen, 0.0, std)
    return add_noise(x, _field(field_gen or gen, x.shape, x.device), s)


def gamma(x: torch.Tensor, g: float) -> torch.Tensor:
    """((x - lo) / range)^g * range + lo: a gamma on the [0, 1]-scaled
    volume that keeps its intensity range."""
    lo, hi = x.min(), x.max()
    rng = torch.clamp(hi - lo, min=1e-8)
    return ((x - lo) / rng) ** g * rng + lo


def rand_adjust_contrast(gen, x, *, gamma_range: tuple = (0.5, 4.5)):
    """MONAI RandAdjustContrast: gamma g ~ U(range)."""
    return gamma(x, _uniform(gen, *gamma_range))


def rand_gamma(gen, x, *, log_gamma: tuple = (-0.3, 0.3)):
    """torchio RandomGamma: gamma e^u, u ~ U(log_gamma)."""
    return gamma(x, _gamma_of(_uniform(gen, *log_gamma)))


def _gamma_of(u: float) -> float:
    # the JAX package exponentiates in f32
    return float(np.exp(np.float32(u)))


def n_bias_coeffs(degree: int = 3) -> int:
    return sum(1 for i in range(degree + 1) for j in range(degree + 1 - i)
               for _ in range(degree + 1 - i - j))


def bias_field(coeffs, shape: Sequence[int], degree: int = 3, *,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """exp(polynomial) multiplicative bias field over [-1, 1]^3 coordinates
    (MONAI RandBiasField), (D, H, W) f32, the terms in the JAX package's
    order."""
    D, H, W = shape[:3]
    coeffs = _f32(coeffs, device)
    zs, ys, xs = (torch.linspace(-1.0, 1.0, n, dtype=torch.float32,
                                 device=device) for n in (D, H, W))
    field = torch.zeros((D, H, W), dtype=torch.float32, device=device)
    idx = 0
    for i in range(degree + 1):
        for j in range(degree + 1 - i):
            for k in range(degree + 1 - i - j):
                term = ((zs ** i)[:, None, None] * (ys ** j)[None, :, None]
                        * (xs ** k)[None, None, :])
                field = field + coeffs[idx] * term
                idx += 1
    return torch.exp(field)


def apply_bias_field(x: torch.Tensor, coeffs, degree: int = 3):
    field = bias_field(coeffs, x.shape[:3], degree, device=x.device)
    return x * (field[..., None] if x.ndim == 4 else field)


def rand_bias_field(gen, x, *, coeff_range: tuple = (0.0, 0.1),
                    degree: int = 3):
    return apply_bias_field(
        x, _uniform(gen, *coeff_range, n_bias_coeffs(degree)), degree)


# -----------------------------------------------------------------------------
# Gaussian filtering (separable, erf-discretized, torch/MONAI-style)

def _gaussian_kernel1d(sigma: float, truncated: float = 4.0) -> np.ndarray:
    tail = max(int(truncated * sigma + 0.5), 1)
    i = np.arange(-tail, tail + 1, dtype=np.float64)
    denom = sigma * math.sqrt(2.0) if sigma > 0 else 1.0
    w = 0.5 * (np.vectorize(math.erf)((i + 0.5) / denom)
               - np.vectorize(math.erf)((i - 0.5) / denom))
    w = w / w.sum()
    return w.astype(np.float32)


def _filter_axis(x: torch.Tensor, w: torch.Tensor, axis: int):
    """Correlate the spatial `axis` of x with the odd 1-D kernel `w` over
    edge padding, as a sum of shifted slices in f32 (no TF32 on the card,
    whatever the backend's settings)."""
    tail = (w.shape[0] - 1) // 2
    L = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, L - 1, 1)
    padded = torch.cat([first.expand(*[tail if d == axis else -1
                                       for d in range(x.ndim)]), x,
                        last.expand(*[tail if d == axis else -1
                                      for d in range(x.ndim)])], dim=axis)
    out = padded.narrow(axis, 0, L) * w[0]
    for k in range(1, w.shape[0]):
        out = out + padded.narrow(axis, k, L) * w[k]
    return out


def gaussian_smooth(x: torch.Tensor, sigma, *, truncated: float = 4.0):
    """Separable Gaussian blur over the three leading spatial axes; `sigma`
    a float or a per-axis triple (an axis with sigma <= 0 is left as it
    is)."""
    if not isinstance(sigma, (tuple, list)):
        sigma = (sigma,) * 3
    y = x
    for axis, s in enumerate(sigma):
        if s is None or s <= 0:
            continue
        w = torch.from_numpy(_gaussian_kernel1d(float(s), truncated)).to(
            x.device)
        y = _filter_axis(y, w, axis)
    return y


def erf_kernel(sigma: float, max_sigma: float,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """The erf-discretized Gaussian with `max(int(4 max_sigma + 0.5), 1)`
    taps a side whatever `sigma` is (a fixed width for a drawn sigma),
    evaluated in f32 at `sigma` and normalized; sigma <= 1e-4 gives the
    identity."""
    tail = max(int(4.0 * max_sigma + 0.5), 1)
    i = torch.arange(-tail, tail + 1, dtype=torch.float32, device=device)
    if not np.float32(sigma) > np.float32(1e-4):
        return (i == 0).float()
    denom = torch.tensor(max(float(np.float32(sigma)), 1e-6),
                         dtype=torch.float32, device=device) * math.sqrt(2.0)
    w = 0.5 * (torch.erf((i + 0.5) / denom) - torch.erf((i - 0.5) / denom))
    return w / w.sum()


def smooth_axis(x: torch.Tensor, sigma: float, axis: int, max_sigma: float):
    """Gaussian blur of one spatial axis at a drawn sigma, with the fixed
    kernel width `max_sigma` sets (`erf_kernel`) over edge padding."""
    return _filter_axis(x, erf_kernel(sigma, max_sigma, x.device), axis)


def smooth(x: torch.Tensor, sigma: float, max_sigma: float):
    """`smooth_axis` over the three spatial axes at one sigma."""
    for axis in range(3):
        x = smooth_axis(x, sigma, axis, max_sigma)
    return x


def rand_gaussian_smooth(gen, x, *, sigma_range: tuple = (0.0, 0.1)):
    """MONAI RandGaussianSmooth: per-axis sigma ~ U(range)."""
    for axis, s in enumerate(_uniform(gen, *sigma_range, 3)):
        x = smooth_axis(x, s, axis, max_sigma=sigma_range[1])
    return x


def gaussian_sharpen(x, sigma1: float, sigma2: float, alpha: float, *,
                     max_sigma1: float = 1.0, max_sigma2: float = 1.0):
    """b1 = blur(x, sigma1); b2 = blur(b1, sigma2); b1 + alpha (b1 - b2)."""
    b1 = smooth(x, sigma1, max_sigma1)
    b2 = smooth(b1, sigma2, max_sigma2)
    return b1 + alpha * (b1 - b2)


def rand_gaussian_sharpen(gen, x, *, sigma1_range: tuple = (0.5, 1.0),
                          sigma2_range: tuple = (0.5, 1.0),
                          alpha_range: tuple = (10.0, 30.0)):
    """MONAI RandGaussianSharpen."""
    s1 = _uniform(gen, *sigma1_range)
    s2 = _uniform(gen, *sigma2_range)
    alpha = _uniform(gen, *alpha_range)
    return gaussian_sharpen(x, s1, s2, alpha, max_sigma1=sigma1_range[1],
                            max_sigma2=sigma2_range[1])


# -----------------------------------------------------------------------------
# k-space transforms (complex64 FFTs, the real part cast back)

def _vol3(x):
    return x if x.ndim == 3 else x[..., 0]


def _back(out, x):
    out = out.to(x.dtype)
    return out if x.ndim == 3 else out[..., None]


def gibbs_noise(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Gibbs ringing: low-pass the centered 3D FFT, keeping a centered box
    of relative half-extent (1 - alpha) per axis (alpha 0: identity)."""
    vol = _vol3(x)
    f = torch.fft.fftshift(torch.fft.fftn(vol))
    masks = []
    for size in vol.shape:
        coords = (torch.arange(size, dtype=torch.float32, device=x.device)
                  - (size - 1) / 2.0).abs() / (size / 2.0)
        masks.append(coords <= float(np.float32(1.0) - np.float32(alpha)))
    mask = (masks[0][:, None, None] & masks[1][None, :, None]
            & masks[2][None, None, :])
    out = torch.fft.ifftn(torch.fft.ifftshift(f * mask)).real
    return _back(out, x)


def rand_gibbs_noise(gen, x, *, alpha_range: tuple = (0.0, 1.0)):
    return gibbs_noise(x, _uniform(gen, *alpha_range))


def kspace_spike(x: torch.Tensor, loc: Sequence[int], intensity: float):
    """Set one frequency of the centered spectrum, at `loc` (z, y, x), to
    magnitude e^intensity, keeping its phase."""
    vol = _vol3(x)
    D, H, W = vol.shape
    f = torch.fft.fftshift(torch.fft.fftn(vol)).reshape(-1)
    idx = (int(loc[0]) * H + int(loc[1])) * W + int(loc[2])
    phase = torch.angle(f[idx])
    mag = torch.exp(torch.tensor(intensity, dtype=torch.float32,
                                 device=x.device))
    f = f.clone()
    f[idx] = mag * torch.exp(1j * phase)
    out = torch.fft.ifftn(torch.fft.ifftshift(f.reshape(D, H, W))).real
    return _back(out, x)


def rand_kspace_spike(gen, x, *, intensity_range: tuple = (11.0, 12.5)):
    """MONAI RandKSpaceSpikeNoise: one frequency in the central half of
    each axis."""
    loc = [_randint(gen, n // 4, 3 * n // 4) for n in _vol3(x).shape]
    return kspace_spike(x, loc, _uniform(gen, *intensity_range))


def motion_ghosting(x: torch.Tensor, axis: int, n_ghosts: int,
                    intensity: float) -> torch.Tensor:
    """Scale every `n_ghosts`-th k-space plane along `axis` by
    1 - intensity (torchio RandomMotion-style ghosting)."""
    vol = _vol3(x)
    size = vol.shape[axis]
    idx = torch.arange(size, device=x.device)
    m = torch.where(idx % max(int(n_ghosts), 1) == 0,
                    float(np.float32(1.0) - np.float32(intensity)), 1.0)
    view = [1, 1, 1]
    view[axis] = size
    out = torch.fft.ifftn(torch.fft.fftn(vol) * m.reshape(view)).real
    return _back(out, x)


def rand_motion_ghosting(gen, x, *, num_ghosts_range: tuple = (2, 10),
                         intensity_range: tuple = (0.1, 0.5)):
    axis = _randint(gen, 0, 3)
    n = _randint(gen, num_ghosts_range[0], num_ghosts_range[1] + 1)
    return motion_ghosting(x, axis, n, _uniform(gen, *intensity_range))


# -----------------------------------------------------------------------------
# resolution / spatial

def low_res(x: torch.Tensor, zoom: float, *,
            zoom_range: tuple = (0.5, 1.0)) -> torch.Tensor:
    """nnUNet-style low resolution: for zoom < 0.999, nearest-sample the
    volume on the grid of the smallest zoom, then trilinear back (the JAX
    package's static-shape version, whatever the zoom below 0.999)."""
    if not np.float32(zoom) < np.float32(0.999):
        return x
    vol = x if x.ndim == 4 else x[..., None]
    D, H, W = vol.shape[:3]
    small_shape = tuple(max(int(n * zoom_range[0]), 1) for n in (D, H, W))
    small = grid_sample(vol[None], identity_grid(small_shape,
                                                 device=x.device),
                        mode="nearest")
    big = grid_sample(small, identity_grid((D, H, W), device=x.device),
                      mode="bilinear")[0]
    return big if x.ndim == 4 else big[..., 0]


def simulate_low_res(gen, x, *, zoom_range: tuple = (0.5, 1.0)):
    return low_res(x, _uniform(gen, *zoom_range), zoom_range=zoom_range)


def flip(x: torch.Tensor, flips: Sequence[bool], axes=(0, 1, 2)):
    """Flip `x` along each axis of `axes` whose entry of `flips` is set."""
    dims = [a for a, f in zip(axes, flips) if f]
    return torch.flip(x, dims) if dims else x


def rand_flip(gen, x, *, axes=(0, 1, 2)):
    """Independent flips along the spatial axes, p = 0.5 each (torchio
    RandomFlip)."""
    flips = (torch.rand((len(axes),), generator=gen) < 0.5).tolist()
    return flip(x, flips, axes)


def affine_matrix_3d(rotate=(0.0, 0.0, 0.0), scale=(1.0, 1.0, 1.0),
                     shear=(0.0, 0.0, 0.0),
                     translate=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """A 3x4 affine (rotation . shear . scale + translation) on normalized
    (z, y, x) coordinates, MONAI-style ordering, in f32 as the JAX package
    composes it."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)  # noqa: E731
    rz, ry, rx = (f32(r) for r in rotate)
    cz, sz = torch.cos(rz), torch.sin(rz)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cx, sx = torch.cos(rx), torch.sin(rx)
    one, zero = f32(1.0), f32(0.0)
    Rz = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, cz, -sz]),
                      torch.stack([zero, sz, cz])])  # about axis 0
    Ry = torch.stack([torch.stack([cy, zero, sy]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    Rx = torch.stack([torch.stack([cx, -sx, zero]),
                      torch.stack([sx, cx, zero]),
                      torch.stack([zero, zero, one])])
    Sh = f32([[1.0, shear[0], shear[1]], [0.0, 1.0, shear[2]],
              [0.0, 0.0, 1.0]])
    M = Rz @ Ry @ Rx @ Sh @ torch.diag(f32(scale))
    return torch.cat([M, f32(translate)[:, None]], dim=1)


def apply_affine(vol: torch.Tensor, matrix, *, mode: str = "bilinear",
                 out_shape=None) -> torch.Tensor:
    """Resample `vol` through a 3x4 affine acting on normalized (z, y, x)
    coordinates (zero padding, align_corners=False)."""
    x = vol if vol.ndim == 4 else vol[..., None]
    out_shape = tuple(out_shape or x.shape[:3])
    m = _f32(matrix, vol.device)
    zyx = identity_grid(out_shape, device=vol.device).flip(-1)
    src = torch.einsum("ij,...j->...i", m[:, :3], zyx) + m[:, 3]
    out = grid_sample(x[None].float(), src.flip(-1), mode=mode)[0]
    out = out.to(vol.dtype)
    return out if vol.ndim == 4 else out[..., 0]


def rand_affine_params(gen, *, rotate_range: float = math.pi / 4,
                       scale_range: float = 0.2, shear_range: float = 0.2):
    """MONAI RandAffine-style matrix: rotations, scale 1 + u and shears,
    each uniform in +-range."""
    rot = _uniform(gen, -rotate_range, rotate_range, 3)
    scale = [1.0 + u for u in _uniform(gen, -scale_range, scale_range, 3)]
    shear = _uniform(gen, -shear_range, shear_range, 3)
    return affine_matrix_3d(rotate=rot, scale=scale, shear=shear)


def crop(vols: Sequence[torch.Tensor], offsets: Sequence[int], size: int):
    """The (size^3) box at `offsets` (z, y, x) of each aligned volume."""
    oz, oy, ox = (int(o) for o in offsets)
    return [v[oz:oz + size, oy:oy + size, ox:ox + size] for v in vols]


def crop_offsets(gen, shape: Sequence[int], size: int) -> list[int]:
    """A uniform crop origin per axis, in [0, max(n - size, 0)]."""
    return [_randint(gen, 0, max(n - size, 0) + 1) for n in shape[:3]]


def rand_spatial_crop(gen, vols: Sequence[torch.Tensor], size: int):
    """Shared random crop of aligned volumes to size^3 (MONAI
    RandSpatialCrop(random_size=False); the pretraining `random_crop`)."""
    return crop(vols, crop_offsets(gen, vols[0].shape, size), size)


def maybe(gen, prob: float, fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """`fn(gen, x)` with probability `prob`, else x (decided on the
    host)."""
    return fn(gen, x) if float(torch.rand((), generator=gen)) < prob else x
