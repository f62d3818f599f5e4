"""The backward of the port's conv (`kernels/conv_train.py`) on the CPU:
the plain dgrad and wgrad versions against the VJP of the JAX package's
custom-VJP train conv (Pallas interpret mode) and against torch autograd of
`F.conv3d`, and the differentiable `conv3x3x3_train`; the block-layout
permutations of the train walk (`kernels/reshuffle.py`) against the JAX
package's Pallas `space_to_depth` / `depth_to_space` (interpret mode). The
kernels themselves are held against these plain versions on the card
(`test_torch_gpu.py`, `chip_smoke.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.ops.pallas.conv_block_train import (
    conv3x3_same_train,
    depth_to_space_vjp,
    space_to_depth_vjp,
)
from anatomix_tpu_torch.kernels.conv_train import (
    conv3x3x3_dgrad_ndhwc,
    conv3x3x3_dgrad_ndhwc_plain,
    conv3x3x3_train,
    conv3x3x3_wgrad_ndhwc,
    conv3x3x3_wgrad_ndhwc_plain,
    flip_transpose_packed,
)
from anatomix_tpu_torch.kernels.reshuffle import (
    depth_to_space2,
    depth_to_space2_ndhwc,
    space_to_depth2,
    space_to_depth2_ndhwc,
)
from anatomix_tpu_torch.ops.conv import conv3d_same, pack_conv_weight


def _maxrel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _autograd(x, w, dy, pad):
    """dx and packed dW of the plain conv by torch autograd (f64)."""
    x = x.double().requires_grad_()
    w = w.double().requires_grad_()
    y = conv3d_same(x, w, pad_type=pad)
    gx, gw = torch.autograd.grad(y, (x, w), dy.double())
    return gx, pack_conv_weight(gw)


@pytest.mark.parametrize("pad", ["reflect", "zeros"])
def test_plain_backward_matches_jax_train_conv(pad):
    """(2, 8^3, 16 -> 16): dx, dW and db against `jax.vjp` of
    `conv3x3_same_train` (f32, interpret mode), max|err|/max|ref| <= 1e-3."""
    rng = np.random.default_rng(3)
    ci = co = 16
    x = rng.standard_normal((2, 8, 8, 8, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    dy = rng.standard_normal((2, 8, 8, 8, co)).astype(np.float32)

    def f(x, w, b):
        return conv3x3_same_train(x, w, b, act="none", pad_type=pad,
                                  compute_dtype=jnp.float32, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    rdx, rdw, rdb = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    dy_t = torch.from_numpy(dy)
    w_packed = torch.from_numpy(w.reshape(27 * ci, co))
    dx = conv3x3x3_dgrad_ndhwc_plain(dy_t, w_packed, pad_type=pad)
    dw = conv3x3x3_wgrad_ndhwc_plain(torch.from_numpy(x), dy_t, pad_type=pad)
    assert _maxrel(dx, rdx) <= 1e-3
    assert _maxrel(dw, rdw.reshape(27 * ci, co)) <= 1e-3
    assert _maxrel(dy_t.sum(dim=(0, 1, 2, 3)), rdb) <= 1e-3


@pytest.mark.parametrize("pad", ["reflect", "zeros"])
@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 4, 5), (8, 6, 7)])
def test_plain_backward_matches_autograd(pad, shape):
    """The reflect adjoint's faces, edges and corners (extents 2 and 3 put
    both mirrored faces on one voxel) against torch autograd of F.pad +
    F.conv3d, <= 1e-5."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn((2, *shape, 5), generator=g)
    w = torch.randn((7, 5, 3, 3, 3), generator=g)
    dy = torch.randn((2, *shape, 7), generator=g)
    rdx, rdw = _autograd(x, w, dy, pad)
    dx = conv3x3x3_dgrad_ndhwc_plain(dy, pack_conv_weight(w), pad_type=pad)
    dw = conv3x3x3_wgrad_ndhwc_plain(x, dy, pad_type=pad)
    assert _maxrel(dx, rdx) <= 1e-5
    assert _maxrel(dw, rdw) <= 1e-5


def test_wgrad_single_input_channel():
    """The entry conv (Ci = 1 -> 16, reflect)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 6, 6, 6, 1), generator=g)
    w = torch.randn((16, 1, 3, 3, 3), generator=g)
    dy = torch.randn((2, 6, 6, 6, 16), generator=g)
    _, rdw = _autograd(x, w, dy, "reflect")
    dw = conv3x3x3_wgrad_ndhwc(x, dy, pad_type="reflect")
    assert dw.shape == (27, 16) and dw.dtype == torch.float32
    assert _maxrel(dw, rdw) <= 1e-5


def test_flip_transpose_packed_is_the_transposed_conv():
    """Packed weights of the transposed conv: taps reversed, I/O swapped."""
    g = torch.Generator().manual_seed(6)
    w = torch.randn((4, 3, 3, 3, 3), generator=g)
    wt = flip_transpose_packed(pack_conv_weight(w), 3)
    ref = pack_conv_weight(w.flip((2, 3, 4)).transpose(0, 1))
    assert torch.equal(wt, ref)


@pytest.mark.parametrize("bias", [False, True])
def test_conv_train_backward_on_cpu(bias):
    """`conv3x3x3_train`: value and gradients of x, w and b against torch
    autograd of the plain conv; the CPU wrappers count no launch."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 6, 6, 6, 8), generator=g, requires_grad=True)
    w = torch.randn((12, 8, 3, 3, 3), generator=g, requires_grad=True)
    b = torch.randn((12,), generator=g, requires_grad=True) if bias else None
    dy = torch.randn((2, 6, 6, 6, 12), generator=g)
    before = (conv3x3x3_wgrad_ndhwc.launches,
              conv3x3x3_dgrad_ndhwc.launches)
    y = conv3x3x3_train(x, w, b, "reflect")
    grads = torch.autograd.grad(y, [t for t in (x, w, b) if t is not None],
                                dy)
    y_ref = conv3d_same(x, w, b, pad_type="reflect")
    ref = torch.autograd.grad(y_ref, [t for t in (x, w, b) if t is not None],
                              dy)
    assert _maxrel(y.detach(), y_ref.detach()) <= 1e-5
    for got, want in zip(grads, ref):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _maxrel(got, want) <= 1e-5
    assert (conv3x3x3_wgrad_ndhwc.launches,
            conv3x3x3_dgrad_ndhwc.launches) == before
    # the entry conv's input takes no gradient: no dx is computed
    xe = torch.randn((1, 4, 4, 4, 1), generator=g)
    we = torch.randn((4, 1, 3, 3, 3), generator=g, requires_grad=True)
    (gw,) = torch.autograd.grad(conv3x3x3_train(xe, we).sum(), [we])
    assert gw.shape == we.shape


def test_bf16_plain_rounds_like_the_kernels():
    """bf16 inputs on the CPU: f32 arithmetic, dx rounded to bf16, dW f32."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn((1, 5, 5, 5, 4), generator=g).bfloat16()
    dy = torch.randn((1, 5, 5, 5, 6), generator=g).bfloat16()
    w_packed = torch.randn((27 * 4, 6), generator=g).bfloat16()
    dx = conv3x3x3_dgrad_ndhwc(dy, w_packed)
    dw = conv3x3x3_wgrad_ndhwc(x, dy)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    ref = conv3x3x3_dgrad_ndhwc_plain(dy.float(), w_packed.float())
    assert torch.equal(dx, ref.bfloat16())
    assert torch.equal(dw, conv3x3x3_wgrad_ndhwc_plain(x.float(), dy.float()))


@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 3), (1, 2, 2, 4, 16)])
def test_reshuffle2_matches_jax_and_is_its_own_adjoint(shape):
    """space_to_depth2 / depth_to_space2 on the CPU (the plain versions)
    against the JAX package's Pallas kernels and their custom VJPs
    (interpret mode): the same values, and each one's gradient is the
    other applied to the cotangent."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    B, D, H, W, C = shape
    g = rng.standard_normal((B, D // 2, H // 2, W // 2, 8 * C)).astype(
        np.float32)
    ref, vjp = jax.vjp(lambda v: space_to_depth_vjp(v, True), jnp.asarray(x))
    (rdx,) = vjp(jnp.asarray(g))
    xs = torch.from_numpy(x).requires_grad_()
    got = space_to_depth2(xs)
    (dx,) = torch.autograd.grad(got, xs, torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(rdx))
    ref, vjp = jax.vjp(lambda v: depth_to_space_vjp(v, True), jnp.asarray(g))
    (rdg,) = vjp(jnp.asarray(x))
    gs = torch.from_numpy(g).requires_grad_()
    got = depth_to_space2(gs)
    (dg,) = torch.autograd.grad(got, gs, torch.from_numpy(x))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(dg.numpy(), np.asarray(rdg))
    # the wrappers take the plain versions on CPU tensors, any 2-byte dtype
    xb = torch.from_numpy(x).bfloat16()
    assert torch.equal(depth_to_space2_ndhwc(space_to_depth2_ndhwc(xb)), xb)
