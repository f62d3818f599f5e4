"""The port's `ops/grid_sample.py` and `ops/augment.py` against the JAX
package on the CPU, on the same seeded numpy volumes.

JAX's threefry draws and torch's generators never agree, so each of the
port's applies is fed the parameters the JAX transform drew, recovered by
replaying its key splits here, and held against the JAX transform's output
with the tolerance stated in each test (relative to the output's largest
magnitude unless said otherwise).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.ops import augment as ja
from anatomix_tpu.ops.grid_sample import grid_sample as jgrid_sample
from anatomix_tpu.ops.grid_sample import identity_grid as jidentity_grid
from anatomix_tpu_torch.ops import augment as pa
from anatomix_tpu_torch.ops.grid_sample import grid_sample, identity_grid


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _vol(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# -----------------------------------------------------------------------------
# grid_sample

def _tie_coords(size, align_corners, n):
    """Normalized coords whose pixel position is exactly k + 0.5."""
    k = np.arange(n) % max(size - 1, 1)
    if align_corners:
        return (2.0 * (k + 0.5) / (size - 1) - 1.0).astype(np.float32)
    return ((2.0 * k + 2.0) / size - 1.0).astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(mode, align_corners):
    """In-range, out-of-range and exact-tie coordinates: bilinear within
    1e-6, nearest bit for bit (both round half to even). Extents where the
    ties are exact in f32: powers of two, or one more than one with
    align_corners."""
    shape = (5, 9, 17) if align_corners else (4, 8, 16)
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((2,) + shape + (3,)).astype(np.float32)
    n = 6 * 5 * 4
    grid = rng.uniform(-1.3, 1.3, (2, n, 3)).astype(np.float32)
    # a third of the points on exact ties, along every axis at once
    for ax, size in enumerate(shape[::-1]):  # grid x is W, z is D
        grid[:, : n // 3, ax] = _tie_coords(size, align_corners, n // 3)
    grid = grid.reshape(2, 6, 5, 4, 3)
    ref = np.asarray(jgrid_sample(jnp.asarray(vol), jnp.asarray(grid),
                                  mode=mode, align_corners=align_corners))
    got = grid_sample(_t(vol), _t(grid), mode=mode,
                      align_corners=align_corners).numpy()
    assert got.shape == ref.shape == (2, 6, 5, 4, 3)
    assert (np.abs(ref) == 0).any()  # some taps fall outside the volume
    if mode == "nearest":
        np.testing.assert_array_equal(got, ref)
    else:
        assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("align_corners", [False, True])
def test_identity_grid_matches_jax(align_corners):
    ref = np.asarray(jidentity_grid((3, 5, 8), align_corners=align_corners))
    got = identity_grid((3, 5, 8), align_corners=align_corners).numpy()
    # linspace may round the two frameworks' points one ulp apart
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -23)
    vol = _t(_vol((1, 3, 5, 8, 2)))
    if not align_corners:  # the identity resamples a volume onto itself
        torch.testing.assert_close(grid_sample(vol, _t(got)), vol,
                                   rtol=0, atol=1e-6)


# -----------------------------------------------------------------------------
# Gaussian filtering

@pytest.mark.parametrize("sigma", [0.0, 5e-5, 1e-4, 2e-4, 0.3, 1.0, 1.7, 2.0])
def test_smooth_axis_matches_jax(sigma):
    """The erf kernel of fixed width from max_sigma over edge padding, at
    each axis of a 3-D and a 4-D volume; sigma <= 1e-4 is the identity.
    Within 1e-6 (the erf weights alone within 1e-6 of JAX's)."""
    i = jnp.arange(-8, 9, dtype=jnp.float32)
    denom = jnp.maximum(jnp.float32(sigma), 1e-6) * math.sqrt(2.0)
    w = 0.5 * (jax.lax.erf((i + 0.5) / denom) - jax.lax.erf((i - 0.5) / denom))
    w = jnp.where(jnp.float32(sigma) > 1e-4, w, (i == 0).astype(jnp.float32))
    w = np.asarray(w / jnp.sum(w))
    assert _rel(pa.erf_kernel(sigma, 2.0).numpy(), w) <= 1e-6
    for shape in ((7, 9, 11), (7, 9, 11, 2)):
        x = _vol(shape, seed=2)
        for axis in range(3):
            ref = ja._smooth_axis_dynamic(jnp.asarray(x), jnp.float32(sigma),
                                          axis, max_sigma=2.0)
            got = pa.smooth_axis(_t(x), sigma, axis, max_sigma=2.0)
            assert _rel(got, ref) <= 1e-6, (shape, axis)
            if sigma <= 1e-4:
                np.testing.assert_array_equal(got.numpy(), x)


def test_gaussian_smooth_static_and_rand_smooth_match_jax():
    """The static-sigma blur (numpy erf kernel) per axis, and the drawn
    per-axis sigmas of `rand_gaussian_smooth`, within 1e-6."""
    x = _vol((9, 10, 11, 2), seed=3)
    sig = (0.7, 0.0, 1.3)
    ref = ja.gaussian_smooth(jnp.asarray(x), sig)
    assert _rel(pa.gaussian_smooth(_t(x), sig), ref) <= 1e-6
    key = jax.random.PRNGKey(4)
    ref = ja.rand_gaussian_smooth(key, jnp.asarray(x), sigma_range=(0.0, 1.5))
    s = np.asarray(jax.random.uniform(key, (3,), minval=0.0, maxval=1.5))
    got = _t(x)
    for axis in range(3):
        got = pa.smooth_axis(got, float(s[axis]), axis, max_sigma=1.5)
    assert _rel(got, ref) <= 1e-6


def test_gaussian_sharpen_matches_jax():
    """b1 + alpha (b1 - b2) with JAX's drawn sigmas and alpha, within 1e-5
    (alpha up to 30 scales the blurs' rounding)."""
    x = _vol((8, 9, 10), seed=5)
    key = jax.random.PRNGKey(6)
    ref = ja.rand_gaussian_sharpen(key, jnp.asarray(x))
    k1, k2, k3 = jax.random.split(key, 3)
    s1, s2, alpha = (float(jax.random.uniform(k, (), minval=lo, maxval=hi))
                     for k, (lo, hi) in ((k1, (0.5, 1.0)), (k2, (0.5, 1.0)),
                                         (k3, (10.0, 30.0))))
    got = pa.gaussian_sharpen(_t(x), s1, s2, alpha)
    assert _rel(got, ref) <= 1e-5


# -----------------------------------------------------------------------------
# intensity

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gamma_and_contrast_match_jax(seed):
    """torchio RandomGamma (e^u) and MONAI RandAdjustContrast (u) share the
    apply `gamma`; within 1e-6."""
    x = _vol((6, 7, 8), seed=seed) * 3 - 1
    key = jax.random.PRNGKey(seed)
    ref = ja.rand_gamma(key, jnp.asarray(x), log_gamma=(-0.4, 0.4))
    g = float(jnp.exp(jax.random.uniform(key, (), minval=-0.4, maxval=0.4)))
    assert _rel(pa.gamma(_t(x), g), ref) <= 1e-6
    ref = ja.rand_adjust_contrast(key, jnp.asarray(x))
    g = float(jax.random.uniform(key, (), minval=0.5, maxval=4.5))
    assert _rel(pa.gamma(_t(x), g), ref) <= 1e-6


def test_bias_field_matches_jax():
    """exp(polynomial) over [-1, 1]^3, its 20 terms in JAX's order, and the
    drawn field applied to a 3-D and a 4-D volume: within 1e-6."""
    coeffs = np.random.default_rng(7).uniform(-0.5, 0.5, 20).astype(
        np.float32)
    ref = ja.bias_field(jnp.asarray(coeffs), (5, 6, 7))
    assert _rel(pa.bias_field(coeffs, (5, 6, 7)), ref) <= 1e-6
    assert pa.n_bias_coeffs(3) == ja.n_bias_coeffs(3) == 20
    key = jax.random.PRNGKey(8)
    drawn = np.asarray(jax.random.uniform(key, (20,), minval=-0.5,
                                          maxval=0.5))
    for shape in ((5, 6, 7), (5, 6, 7, 2)):
        x = _vol(shape, seed=9)
        ref = ja.rand_bias_field(key, jnp.asarray(x),
                                 coeff_range=(-0.5, 0.5))
        assert _rel(pa.apply_bias_field(_t(x), drawn), ref) <= 1e-6


def test_noise_and_scale_intensity_match_jax():
    """x + field * std with JAX's std and field, and the min-max scaling:
    within 1e-7."""
    x = _vol((6, 7, 8, 1), seed=10)
    key = jax.random.PRNGKey(11)
    ref = ja.rand_gaussian_noise(key, jnp.asarray(x), std=0.25)
    k1, k2 = jax.random.split(key)
    std = float(jax.random.uniform(k1, (), minval=0.0, maxval=0.25))
    field = np.asarray(jax.random.normal(k2, x.shape, jnp.float32))
    assert _rel(pa.add_noise(_t(x), _t(field), std), ref) <= 1e-7
    ref = ja.scale_intensity(jnp.asarray(x) * 5 - 2)
    assert _rel(pa.scale_intensity(_t(x) * 5 - 2), ref) <= 1e-7


# -----------------------------------------------------------------------------
# k-space

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_motion_ghosting_matches_jax(seed):
    """Every n-th k-space plane along the drawn axis scaled by
    1 - intensity (complex64 FFT, the real part cast back), on 3-D and 4-D
    volumes, within 1e-5; the seeds cover the three axes."""
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    axis = int(jax.random.randint(k1, (), 0, 3))
    n = int(jax.random.randint(k2, (), 2, 11))
    inten = float(jax.random.uniform(k3, (), minval=0.1, maxval=0.5))
    for shape in ((6, 8, 10), (6, 8, 10, 1)):
        x = _vol(shape, seed=seed)
        ref = ja.rand_motion_ghosting(key, jnp.asarray(x))
        got = pa.motion_ghosting(_t(x), axis, n, inten)
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert _rel(got, ref) <= 1e-5, (axis, n)


def test_motion_ghosting_draws_cover_every_axis():
    axes = {int(jax.random.randint(jax.random.split(jax.random.PRNGKey(s),
                                                    3)[0], (), 0, 3))
            for s in (0, 1, 7)}
    assert axes == {0, 1, 2}


@pytest.mark.parametrize("seed", [0, 1])
def test_gibbs_and_kspace_spike_match_jax(seed):
    """Gibbs low-pass with JAX's alpha, and the k-space spike at JAX's
    location and intensity: within 1e-5."""
    x = _vol((6, 8, 10), seed=seed)
    key = jax.random.PRNGKey(seed)
    ref = ja.rand_gibbs_noise(key, jnp.asarray(x))
    alpha = float(jax.random.uniform(key, (), minval=0.0, maxval=1.0))
    assert _rel(pa.gibbs_noise(_t(x), alpha), ref) <= 1e-5
    ref = ja.rand_kspace_spike(key, jnp.asarray(x)[..., None])
    k1, k2 = jax.random.split(key)
    loc = np.asarray(jax.random.randint(
        k1, (3,), jnp.asarray([1, 2, 2]), jnp.asarray([4, 6, 7])))
    inten = float(jax.random.uniform(k2, (), minval=11.0, maxval=12.5))
    got = pa.kspace_spike(_t(x)[..., None], loc.tolist(), inten)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


# -----------------------------------------------------------------------------
# resolution and spatial

@pytest.mark.parametrize("zoom_range", [(0.5, 1.0), (0.9995, 1.0)])
def test_simulate_low_res_matches_jax(zoom_range):
    """Nearest down to the smallest zoom's grid, trilinear back (two
    grid_samples), or the identity for a zoom >= 0.999: within 1e-6."""
    x = _vol((8, 9, 10, 2), seed=13)
    key = jax.random.PRNGKey(14)
    ref = ja.simulate_low_res(key, jnp.asarray(x), zoom_range=zoom_range)
    zoom = float(jax.random.uniform(key, (), minval=zoom_range[0],
                                    maxval=zoom_range[1]))
    got = pa.low_res(_t(x), zoom, zoom_range=zoom_range)
    assert _rel(got, ref) <= 1e-6
    if zoom_range[0] > 0.999:
        np.testing.assert_array_equal(got.numpy(), x)
    x3 = x[..., 0]
    ref = ja.simulate_low_res(key, jnp.asarray(x3), zoom_range=zoom_range)
    assert _rel(pa.low_res(_t(x3), zoom, zoom_range=zoom_range), ref) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flip_and_crop_match_jax(seed):
    """Flips with JAX's coins and the shared crop at JAX's offsets: exact."""
    x = _vol((6, 7, 8, 2), seed=seed)
    key = jax.random.PRNGKey(seed)
    ref = ja.rand_flip(key, jnp.asarray(x))
    flips = np.asarray(jax.random.bernoulli(key, 0.5, (3,))).tolist()
    np.testing.assert_array_equal(pa.flip(_t(x), flips).numpy(),
                                  np.asarray(ref))
    y = x[..., 0]
    refs = ja.rand_spatial_crop(key, [jnp.asarray(x), jnp.asarray(y)], 4)
    offs = [int(jax.random.randint(k, (), 0, n - 4 + 1))
            for k, n in zip(jax.random.split(key, 3), x.shape)]
    gots = pa.crop([_t(x), _t(y)], offs, 4)
    for got, ref in zip(gots, refs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_affine_matrix_matches_jax():
    """(z, y, x) rotation . shear . scale + translation, composed in f32:
    within 1e-6."""
    rng = np.random.default_rng(15)
    for _ in range(3):
        rot, scale, shear, tr = (rng.uniform(lo, hi, 3).astype(np.float32)
                                 for lo, hi in ((-1, 1), (0.6, 1.4),
                                                (-0.2, 0.2), (-0.1, 0.1)))
        ref = ja.affine_matrix_3d(rotate=jnp.asarray(rot),
                                  scale=jnp.asarray(scale),
                                  shear=jnp.asarray(shear),
                                  translate=jnp.asarray(tr))
        got = pa.affine_matrix_3d(rotate=rot.tolist(), scale=scale.tolist(),
                                  shear=shear.tolist(), translate=tr.tolist())
        assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_affine_matches_jax(seed):
    """JAX's drawn matrix applied to an (x, y, z) grid: bilinear within
    1e-5, nearest exact (a seg resampled); also a 4-D volume and another
    output shape."""
    key = jax.random.PRNGKey(seed)
    mat = ja.rand_affine_params(key)
    x = _vol((7, 8, 9), seed=seed)
    seg = np.random.default_rng(seed).integers(0, 5, (7, 8, 9)).astype(
        np.float32)
    m = np.asarray(mat)
    ref = ja.apply_affine(jnp.asarray(x), mat, mode="bilinear")
    assert _rel(pa.apply_affine(_t(x), m, mode="bilinear"), ref) <= 1e-5
    ref = ja.apply_affine(jnp.asarray(seg), mat, mode="nearest")
    np.testing.assert_array_equal(
        pa.apply_affine(_t(seg), m, mode="nearest").numpy(), np.asarray(ref))
    x4 = np.stack([x, 1 - x], -1)
    ref = ja.apply_affine(jnp.asarray(x4), mat, out_shape=(5, 6, 7))
    got = pa.apply_affine(_t(x4), m, out_shape=(5, 6, 7))
    assert got.shape == (5, 6, 7, 2) and _rel(got, ref) <= 1e-5


def test_draws_are_seeded_and_maybe_branches_on_the_host():
    """The port's draws: one CPU generator seed gives one result; `maybe`
    with p 0 never applies, with p 1 always."""
    x = _t(_vol((6, 7, 8), seed=16))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        y = pa.rand_motion_ghosting(g, x)
        y = pa.rand_gaussian_noise(g, y, std=0.1)
        y = pa.rand_gaussian_smooth(g, y, sigma_range=(0.0, 1.0))
        y = pa.rand_bias_field(g, y)
        y = pa.rand_gamma(g, y)
        y = pa.rand_flip(g, y)
        y = pa.simulate_low_res(g, y)
        y = pa.rand_kspace_spike(g, y)
        y = pa.rand_gibbs_noise(g, y)
        y = pa.apply_affine(y, pa.rand_affine_params(g))
        return pa.rand_spatial_crop(g, [y], 4)[0]

    a, b = run(0), run(0)
    assert a.shape == (4, 4, 4) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = torch.Generator().manual_seed(0)
    assert pa.maybe(g, 0.0, lambda g_, v: v + 1, x) is x
    torch.testing.assert_close(pa.maybe(g, 1.0, lambda g_, v: v + 1, x),
                               x + 1)
