"""The port's plain ops (`anatomix_tpu_torch/ops/`) against the JAX ops on
the same numpy inputs, in f32 on the CPU, to the JAX suite's op bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.ops.activations import get_activation
from anatomix_tpu.ops.conv import conv3d as jax_conv3d
from anatomix_tpu.ops.pool import avg_pool as jax_avg_pool
from anatomix_tpu.ops.pool import max_pool as jax_max_pool
from anatomix_tpu.ops.resize import upsample2x as jax_upsample2x
from anatomix_tpu_torch.ops.activations import apply_activation
from anatomix_tpu_torch.ops.conv import (
    conv3d_same,
    dhwio_to_torch,
    pack_conv_weight,
    torch_to_dhwio,
    unpack_conv_weight,
)
from anatomix_tpu_torch.ops.pool import avg_pool, max_pool
from anatomix_tpu_torch.ops.resize import upsample2x

OP_TOL = 1e-5  # relative to max |ref|, the JAX suite's op-level bound


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("pad_type", ["reflect", "zeros"])
@pytest.mark.parametrize("ci,co", [(1, 8), (6, 5), (16, 16)])
def test_conv3d_same_matches_jax(pad_type, ci, co):
    rng = np.random.default_rng(ci * 100 + co)
    x = rng.standard_normal((2, 9, 8, 10, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * 0.2).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    ref = jax_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     padding="SAME", pad_type=pad_type)
    got = conv3d_same(torch.from_numpy(x), dhwio_to_torch(torch.from_numpy(w)),
                      torch.from_numpy(b), pad_type=pad_type)
    assert got.shape == ref.shape
    assert _rel(got, ref) < OP_TOL


def test_weight_layouts_round_trip():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((5, 3, 3, 3, 3)).astype(np.float32))
    assert torch.equal(dhwio_to_torch(torch_to_dhwio(w)), w)
    packed = pack_conv_weight(w)
    assert packed.shape == (27 * 3, 5)
    # row ((kd*3 + kh)*3 + kw)*Ci + ci, column co
    assert packed[((2 * 3 + 1) * 3 + 0) * 3 + 1, 4] == w[4, 1, 2, 1, 0]
    assert torch.equal(unpack_conv_weight(packed, 3), w)


@pytest.mark.parametrize("name", ["relu", "lrelu", "elu", "tanh", "none"])
def test_activations_match_jax(name):
    x = np.linspace(-3, 3, 101, dtype=np.float32)
    fn = get_activation(name)
    ref = x if fn is None else np.asarray(fn(jnp.asarray(x)))
    # the UNet's LeakyReLU slope is 0.3 in both packages
    got = apply_activation(torch.from_numpy(x), name, slope=0.3)
    assert _rel(got, ref) < OP_TOL


def test_lrelu_slope_is_explicit():
    x = torch.tensor([-1.0, 2.0])
    assert apply_activation(x, "lrelu", slope=0.2).tolist() == pytest.approx(
        [-0.2, 2.0])
    with pytest.raises(ValueError):
        apply_activation(x, "swish")


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_pool_matches_jax(pool):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 6, 10, 3)).astype(np.float32)
    jfn, tfn = (jax_max_pool, max_pool) if pool == "max" else (
        jax_avg_pool, avg_pool)
    ref = jfn(jnp.asarray(x), 2)
    got = tfn(torch.from_numpy(x), 2)
    assert got.shape == ref.shape
    assert _rel(got, ref) < OP_TOL


def test_pool_drops_odd_voxel_like_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 7, 5, 9, 2)).astype(np.float32)
    ref = jax_max_pool(jnp.asarray(x), 2)
    got = max_pool(torch.from_numpy(x), 2)
    assert got.shape == ref.shape == (1, 3, 2, 4, 2)
    assert _rel(got, ref) < OP_TOL


def test_upsample_nearest_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 4, 5, 3)).astype(np.float32)
    ref = jax_upsample2x(jnp.asarray(x), "nearest")
    got = upsample2x(torch.from_numpy(x), "nearest")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="upsample mode"):
        upsample2x(torch.from_numpy(x), "bicubic")
