"""The plain versions of the ViT slice's kernels against the JAX package on
the CPU, on the same numpy inputs: V2 `conv_down2_ndhwc` against the Pallas
`conv_down2_block` (interpret mode, on a block tensor built by JAX's
`space_to_depth`) and the XLA stride-2 conv; V3 `flash_attention` against
the Pallas TPU flash kernel (`_flash_attention` in interpret mode) and the
einsum path at the ViT's head dim; V1 `depth_to_space8_ndhwc` against the
Pallas `depth_to_space8`; D1's residual operand against the tokenizer's XLA
`leaky_relu(instance_norm(y) + r)`. The CUDA kernels are held against these
plain versions on the card (`tests/test_torch_gpu.py`, `chip_smoke.py`).
"""

import math

import jax
import jax.numpy as jnp
import jax.experimental.pallas.tpu as pltpu
import numpy as np
import pytest
import torch

from anatomix_tpu.models.vit3d.primus import _flash_attention
from anatomix_tpu.ops import norms as jax_norms
from anatomix_tpu.ops.conv import conv3d as jax_conv3d
from anatomix_tpu.ops.pallas.conv_down import (
    conv_down2_block,
    pack_down2_weights,
)
from anatomix_tpu.ops.pallas.reshuffle import depth_to_space8, space_to_depth
from anatomix_tpu_torch.kernels.attention import flash_attention
from anatomix_tpu_torch.kernels.conv_down import conv_down2_ndhwc
from anatomix_tpu_torch.kernels.norm import norm_apply_ndhwc
from anatomix_tpu_torch.kernels.reshuffle import depth_to_space8_ndhwc
from anatomix_tpu_torch.ops import norms
from anatomix_tpu_torch.ops.conv import dhwio_to_torch, pack_conv_weight

CONV_TOL = 1e-5   # relative to max |ref|: f32 sums in another order
ATTN_TOL = 1e-5   # f32 logits, softmax and sums in another order
NORM_TOL = 1e-5   # one-pass f32 moments in the same order


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _randn(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("S,ci,co", [(16, 16, 32), (16, 32, 64)])
def test_conv_down2_matches_jax_pallas_and_xla(S, ci, co):
    """Stride 2, zero padding 1: the f32 plain version against the Pallas
    kernel on the block tensor and against the XLA conv."""
    x = _randn(0, (2, S, S, S, ci))
    w = _randn(1, (3, 3, 3, ci, co), (2.0 / (27 * ci)) ** 0.5)
    b = _randn(2, (co,), 0.1)
    w0, w1 = pack_down2_weights(w)
    ref_pallas = conv_down2_block(
        space_to_depth(jnp.asarray(x), interpret=True), jnp.asarray(w0),
        jnp.asarray(w1), jnp.asarray(b)[None], out_dtype=jnp.float32,
        interpret=True)
    ref_xla = jax_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         stride=2, padding=[(1, 1)] * 3)
    got = conv_down2_ndhwc(
        torch.from_numpy(x), pack_conv_weight(dhwio_to_torch(
            torch.from_numpy(w))), torch.from_numpy(b),
        out_dtype=torch.float32)
    assert got.shape == (2, S // 2, S // 2, S // 2, co)
    assert _rel(got, ref_pallas) < CONV_TOL
    assert _rel(got, ref_xla) < CONV_TOL


def test_conv_down2_odd_extents_match_xla():
    """Odd extents read the zero row past the end: (n - 1) // 2 + 1 out."""
    x = _randn(3, (1, 9, 10, 7, 8))
    w = _randn(4, (3, 3, 3, 8, 16), 0.2)
    b = _randn(5, (16,), 0.1)
    ref = jax_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     stride=2, padding=[(1, 1)] * 3)
    got = conv_down2_ndhwc(
        torch.from_numpy(x), pack_conv_weight(dhwio_to_torch(
            torch.from_numpy(w))), torch.from_numpy(b),
        act="lrelu", slope=0.01, out_dtype=torch.float32)
    ref = jax.nn.leaky_relu(ref, negative_slope=0.01)
    assert got.shape == ref.shape == (1, 5, 5, 4, 16)
    assert _rel(got, ref) < CONV_TOL


def test_flash_attention_matches_jax_pallas():
    """Against the stock Pallas TPU flash kernel in interpret mode, as
    tests/test_vit3d.py runs it (N 500 pads to 768, hd 32 to 128 there)."""
    B, H, N, hd = 1, 2, 500, 32
    q, k, v = (_randn(s, (B, H, N, hd)) for s in (10, 11, 12))
    scale = 1.0 / math.sqrt(hd)
    with pltpu.force_tpu_interpret_mode():
        ref = _flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), scale)
    got = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    assert got.shape == (B, H, N, hd)
    assert _rel(got, ref) < ATTN_TOL


@pytest.mark.parametrize("N", [200, 129])
def test_flash_attention_matches_einsum_hd66(N):
    """The ViT's head dim 66 and an N that is not a multiple of 64, against
    the einsum/softmax of `primus.py:448-456` in f32."""
    B, H, hd = 2, 3, 66
    q, k, v = (_randn(s, (B, H, N, hd), 1.5) for s in (20, 21, 22))
    scale = 1.0 / math.sqrt(hd)
    logits = jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale
    ref = jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(logits, axis=-1), v)
    got = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    assert _rel(got, ref) < ATTN_TOL


@pytest.mark.parametrize("with_sub", [False, True])
def test_depth_to_space8_matches_jax_pallas(with_sub):
    """Exact in f32: the same values moved, the same f32 subtract."""
    C = 32
    y = _randn(30, (2, 2, 1, 3, 512 * C))
    sub = _randn(31, (2, 512 * C)) if with_sub else None
    ref = depth_to_space8(
        jnp.asarray(y), sub=None if sub is None else jnp.asarray(sub),
        out_dtype=jnp.float32, emit="spatial", interpret=True)
    got = depth_to_space8_ndhwc(
        torch.from_numpy(y), None if sub is None else torch.from_numpy(sub))
    assert got.shape == (2, 16, 8, 24, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_norm_apply_residual_matches_jax():
    """D1's residual operand is the tokenizer's
    leaky_relu(instance_norm(y, eps) + r, 0.01)."""
    y = _randn(40, (2, 8, 6, 10, 16), 2.0) + 0.5
    r = _randn(41, (2, 8, 6, 10, 16))
    ref = jax.nn.leaky_relu(
        jax_norms.instance_norm(jnp.asarray(y), eps=1e-2) + jnp.asarray(r),
        negative_slope=0.01)
    yt = torch.from_numpy(y)
    mean, var = norms.instance_norm_stats(yt)
    a, s = norms.fold_affine(mean, var, 1e-2)
    maps = norms.tile_maps(y.shape[1:4], (1, 1, 1), "cpu")
    got = norm_apply_ndhwc(yt, a, s, maps, act="lrelu", slope=0.01,
                           out_dtype=torch.float32,
                           residual=torch.from_numpy(r))
    assert _rel(got, ref) < NORM_TOL
