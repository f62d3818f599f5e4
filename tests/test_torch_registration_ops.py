"""The port's registration ops on the CPU against the JAX package on the
same numpy inputs: `ops/pool.avg_pool3d`, `box_filter` and `avg_pool` at
the grid spacing, `ops/resize.resize3d`, and the exact EDT of `ops/edt.py`
(indices and squared distances equal to JAX's, bit for bit, and the
distances equal to scipy's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt

from anatomix_tpu.ops import edt as jax_edt
from anatomix_tpu.ops import pool as jax_pool
from anatomix_tpu.ops import resize as jax_resize
from anatomix_tpu_torch.ops import edt, pool, resize

ATOL, RTOL = 1e-6, 1e-5  # f32 window sums in another order


def _vol(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("k,s,p", [
    (3, 1, 1),                          # the box filter's step
    (3, 1, 0),                          # MIND's patch SSD (pre-padded)
    (2, 2, 0),
    (3, 2, 1),
    (5, 1, 2),
    (4, 3, 3),                          # padding beyond torch's k // 2
    ((3, 1, 5), (1, 2, 1), (1, 0, 2)),  # per-axis kernel, stride, padding
])
def test_avg_pool3d_matches_jax(k, s, p):
    x = _vol((1, 11, 12, 13, 3))
    got = pool.avg_pool3d(torch.from_numpy(x), k, stride=s, padding=p)
    ref = jax_pool.avg_pool3d(jnp.asarray(x), k, stride=s, padding=p)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("k,n", [(3, 2), (3, 3), (5, 3)])
def test_box_filter_matches_jax(k, n):
    x = _vol((1, 10, 9, 12, 3), seed=1)
    got = pool.box_filter(torch.from_numpy(x), k, n)
    ref = jax_pool.box_filter(jnp.asarray(x), k, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("g", [2, 3])
def test_avg_pool_at_grid_spacing_matches_jax(g):
    """`register_pair`'s `avg_pool(x, grid_sp)`: VALID windows = stride,
    at extents the spacing does not divide."""
    x = _vol((1, 11, 13, 10, 4), seed=2)
    got = pool.avg_pool(torch.from_numpy(x), g)
    ref = jax_pool.avg_pool(jnp.asarray(x), g)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("src,dst,mode,ac", [
    ((6, 7, 5), (12, 14, 10), "nearest", False),     # exact 2x
    ((6, 7, 5), (13, 9, 5), "nearest", False),       # odd, one axis kept
    ((12, 14, 10), (5, 9, 7), "nearest", False),     # down
    ((6, 7, 5), (12, 14, 10), "trilinear", False),   # exact 2x
    ((6, 7, 5), (12, 14, 10), "trilinear", True),
    ((6, 7, 5), (13, 11, 9), "trilinear", False),    # odd up
    ((6, 7, 5), (13, 11, 9), "trilinear", True),
    ((16, 14, 12), (7, 9, 5), "trilinear", False),   # down
    ((16, 14, 12), (7, 9, 5), "trilinear", True),
])
def test_resize3d_matches_jax(src, dst, mode, ac):
    x = _vol((1, *src, 3), seed=3)
    got = resize.resize3d(torch.from_numpy(x), dst, mode=mode,
                          align_corners=ac)
    ref = jax_resize.resize3d(jnp.asarray(x), dst, mode=mode,
                              align_corners=ac)
    assert got.shape == ref.shape
    atol = ATOL
    if mode == "trilinear" and any(
            (i / o) not in (0.5, 1.0, 2.0) for i, o in zip(src, dst)):
        # torch places the sources in f32 (its scale in/out rounded), the
        # JAX package in f64: the weights differ by up to an f32 ulp of the
        # source position, times the step between neighbouring values
        steps = max(np.abs(np.diff(x, axis=a)).max() for a in (1, 2, 3))
        atol += float(np.spacing(np.float32(max(src)))) * steps
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=RTOL)


def _tie_mask(shape, seed):
    """A random mask plus pairs of foreground voxels placed symmetrically
    about a background voxel on each axis, so that exact ties occur."""
    rng = np.random.default_rng(seed)
    m = (rng.random(shape) < 0.02).astype(np.int32)
    c = [s // 2 for s in shape]
    for a in range(3):
        for off in (-3, 3):
            q = list(c)
            q[a] += off
            m[tuple(q)] = 1
    m[tuple(c)] = 0
    return m


@pytest.mark.parametrize("shape,seed", [((13, 17, 9), 0), ((21, 16, 19), 1),
                                         ((16, 16, 16), 2)])
def test_edt_matches_jax_and_scipy_exactly(shape, seed):
    m = _tie_mask(shape, seed)
    idx, dist2 = edt.edt_feature_transform(torch.from_numpy(m))
    jidx, jdist2 = jax_edt.edt_feature_transform(jnp.asarray(m))
    assert idx.dtype == torch.int32 and dist2.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(dist2.numpy(), np.asarray(jdist2))
    # the ties are real: the centre voxel has several nearest voxels
    ix, iy, iz = idx.numpy()
    g = np.indices(shape)
    d2 = (g[0] - ix) ** 2 + (g[1] - iy) ** 2 + (g[2] - iz) ** 2
    np.testing.assert_array_equal(d2, dist2.numpy())
    assert m[ix, iy, iz].all()
    np.testing.assert_array_equal(
        dist2.numpy(),
        np.round(distance_transform_edt(m == 0) ** 2).astype(np.int64))


def test_edt_infill_matches_jax():
    m = _tie_mask((15, 12, 14), 3)
    img = _vol((15, 12, 14), seed=4)
    got = edt.edt_infill(torch.from_numpy(img), torch.from_numpy(m))
    ref = jax_edt.edt_infill(jnp.asarray(img), jnp.asarray(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
