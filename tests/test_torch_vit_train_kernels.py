"""The ViT pretraining step's kernel modules against the JAX package on the
CPU, in f32: attention's forward with its log-sum-exp and its backward
(`kernels/attention.py`, the plain versions the dkv and dq kernels are held
to on the card) against `jax.vjp` of the JAX package's einsum attention;
the stride-2 conv's backward (from the strided formulas, and through the
zero-inserted gradient) and the zero-padded stride-1 conv's backward
(`kernels/conv_down.py`, `kernels/conv_train.py`) against `jax.vjp` of the
JAX package's `conv3d`;
the V1 exit's autograd Function; and the differentiable ViT forward
(`models/vit3d/primus_train.py`) against `primus_apply`.

On CPU tensors every wrapper runs its plain version, so the autograd
Functions here run the same code as on the card with the kernels swapped
for their plain versions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.models.vit3d import PrimusConfig as JPrimusConfig
from anatomix_tpu.models.vit3d import init_primus_params as jinit
from anatomix_tpu.models.vit3d import primus_apply as jprimus_apply
from anatomix_tpu.ops.conv import conv3d as jconv3d
from anatomix_tpu_torch.kernels import attention as ka
from anatomix_tpu_torch.kernels import conv_down as kd
from anatomix_tpu_torch.kernels.conv_train import conv3x3x3_train
from anatomix_tpu_torch.kernels.reshuffle import depth_to_space8_ndhwc_plain
from anatomix_tpu_torch.models.vit3d import (
    PrimusConfig,
    from_jax_primus_params,
)
from anatomix_tpu_torch.models.vit3d.primus_train import (
    _Exit8Demean,
    primus_train_apply,
)
from anatomix_tpu_torch.ops.conv import pack_conv_weight, unpack_conv_weight


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _jax_attention(q, k, v, scale):
    """`anatomix_tpu/models/vit3d/primus.py:447-456`, f32."""
    logits = jnp.einsum("bhnd,bhmd->bhnm", q, k,
                        preferred_element_type=jnp.float32) * scale
    attn = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return jnp.einsum("bhnm,bhmd->bhnd", attn, v,
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("B,H,N,hd", [
    (1, 2, 130, 66),   # ragged N, the ViT's head dim
    (2, 1, 64, 16),
    (1, 3, 77, 32),
])
def test_attention_backward_plain_matches_jax_vjp(B, H, N, hd):
    """The plain forward, its lse and the plain backward (the two passes
    and di) on f32 inputs against `jax.vjp` of the einsum attention,
    within 1e-5 (max |err| / max |ref|)."""
    rng = np.random.default_rng(N)
    q, k, v, do = (rng.standard_normal((B, H, N, hd)).astype(np.float32)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    ref_o, vjp = jax.vjp(lambda a, b, c: _jax_attention(a, b, c, scale),
                         *(jnp.asarray(t) for t in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    o, lse = ka.flash_attention(_t(q), _t(k), _t(v), scale, return_lse=True)
    assert _rel(o, ref_o) <= 1e-5
    ref_lse = jax.nn.logsumexp(
        jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale, axis=-1)
    assert _rel(lse, ref_lse) <= 1e-5
    grads = ka.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse,
                                         _t(do), scale)
    for got, ref in zip(grads, ref_grads):
        assert got.dtype == torch.float32
        assert _rel(got, ref) <= 1e-5
    # the CPU wrappers are the plain passes
    di = ka.attention_di(o, _t(do))
    dk, dv = ka.flash_attention_bwd_dkv(_t(q), _t(k), _t(v), lse, _t(do),
                                        di, scale)
    dq = ka.flash_attention_bwd_dq(_t(q), _t(k), _t(v), lse, _t(do), di,
                                   scale)
    for got, ref in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_flash_attention_train_autograd_matches_jax():
    """The autograd Function (f32 compute on the CPU) gives JAX's
    gradients, and `backward_route` swaps the functions its backward
    calls."""
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal((2, 2, 40, 66)).astype(np.float32)
                   for _ in range(4))
    scale = 66 ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: _jax_attention(a, b, c, scale),
                     *(jnp.asarray(t) for t in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = ka.flash_attention_train(*leaves, scale, torch.float32)
    grads = torch.autograd.grad(out, leaves, _t(do))
    for got, r in zip(grads, ref):
        assert _rel(got, r) <= 1e-5
    seen = []

    def rec(fn, name):
        def call(*args):
            seen.append(name)
            return fn(*args)
        return call

    with ka.backward_route(rec(ka.flash_attention_bwd_dkv_plain, "dkv"),
                           rec(ka.flash_attention_bwd_dq_plain, "dq")):
        out = ka.flash_attention_train(*leaves, scale, torch.float32)
        again = torch.autograd.grad(out, leaves, _t(do))
    assert seen == ["dkv", "dq"]
    for a, b in zip(again, grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_attention_bf16_plain_rounds_where_the_kernels_round():
    """With bf16 inputs the plain backward rounds P (for dV) and dS (for
    dK and dQ) to bf16 and stays within bf16 rounding of the f32 one."""
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 2, 70, 66)).astype(np.float32)).bfloat16() for _ in range(4))
    scale = 66 ** -0.5
    o, lse = ka.flash_attention(q, k, v, scale, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = ka.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    f32 = ka.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(), scale)
    for a, b in zip(got, f32):
        assert a.dtype == torch.float32
        assert 0 < _rel(a, b) < 2e-2


@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 15, 16, 17)])
def test_conv_down_backward_plain_matches_jax_vjp(shape):
    """The stride-2 conv's dx and dW through the zero-inserted gradient on
    the plain stride-1 gradient functions (zero padding) against `jax.vjp`
    of `conv3d(stride=2, padding=[(1, 1)] * 3)`, 8 -> 16 channels."""
    rng = np.random.default_rng(5)
    ci, co = 8, 16
    x = rng.standard_normal((*shape, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    ref_y, vjp = jax.vjp(
        lambda x_, w_, b_: jconv3d(x_, w_, b_, stride=2,
                                   padding=[(1, 1)] * 3),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dy = rng.standard_normal(ref_y.shape).astype(np.float32)
    rdx, rdw, rdb = vjp(jnp.asarray(dy))
    w_t = _t(np.transpose(w, (4, 3, 0, 1, 2)))
    dx, dw_packed = kd.conv_down2_backward_plain(
        _t(x), _t(dy), pack_conv_weight(w_t))
    assert _rel(dx, rdx) <= 1e-5
    dw = unpack_conv_weight(dw_packed, ci).permute(2, 3, 4, 1, 0)
    assert _rel(dw, rdw) <= 1e-5
    # the autograd Function: forward on V2's plain version, the same
    # backward
    leaves = [_t(a).requires_grad_() for a in (x,)] + [
        w_t.clone().requires_grad_(), _t(b).requires_grad_()]
    y = kd.conv_down2_train(*leaves)
    assert _rel(y.detach(), ref_y) <= 1e-5
    gx, gw, gb = torch.autograd.grad(y, leaves, _t(dy))
    assert _rel(gx, rdx) <= 1e-5
    assert _rel(gw.permute(2, 3, 4, 1, 0), rdw) <= 1e-5
    assert _rel(gb, rdb) <= 1e-5


@pytest.mark.parametrize("shape,ci,co", [
    ((2, 16, 16, 16), 8, 16),
    ((1, 15, 16, 17), 8, 16),   # odd extents
    ((1, 9, 6, 11), 5, 12),     # widths that are not a multiple of 8
    ((2, 5, 7, 4), 3, 10),
])
def test_conv_down_backward_strided_plain_matches_jax_vjp(shape, ci, co):
    """The stride-2 conv's dx and dW from the strided formulas (the plain
    versions of the stride-2 gradient kernels, which read dy on its own
    grid) against `jax.vjp` of `conv3d(stride=2, padding=[(1, 1)] * 3)`, and
    against the zero-inserted route of `conv_down2_backward_plain`."""
    from anatomix_tpu_torch.kernels import conv_train as kt

    rng = np.random.default_rng(9)
    x = rng.standard_normal((*shape, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    ref_y, vjp = jax.vjp(
        lambda x_, w_, b_: jconv3d(x_, w_, b_, stride=2,
                                   padding=[(1, 1)] * 3),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert ref_y.shape[1:4] == kt.s2_grid(shape[1:4])
    dy = rng.standard_normal(ref_y.shape).astype(np.float32)
    rdx, rdw, _ = vjp(jnp.asarray(dy))
    w_packed = pack_conv_weight(_t(np.transpose(w, (4, 3, 0, 1, 2))))
    dx = kt.conv3x3x3_dgrad_s2_ndhwc_plain(_t(dy), w_packed, shape[1:4])
    dw_packed = kt.conv3x3x3_wgrad_s2_ndhwc_plain(_t(x), _t(dy))
    assert _rel(dx, rdx) <= 1e-5
    assert _rel(unpack_conv_weight(dw_packed, ci).permute(2, 3, 4, 1, 0),
                rdw) <= 1e-5
    zdx, zdw = kd.conv_down2_backward_plain(_t(x), _t(dy), w_packed)
    assert _rel(dx, zdx) <= 1e-5
    assert _rel(dw_packed, zdw) <= 1e-5
    # the wrappers' stride-2 mode on CPU tensors is the same plain path
    assert torch.equal(kt.conv3x3x3_dgrad_ndhwc(
        _t(dy), w_packed, pad_type="zeros", stride=2, spatial=shape[1:4]),
        dx)
    assert torch.equal(kt.conv3x3x3_wgrad_ndhwc(
        _t(x), _t(dy), pad_type="zeros", stride=2), dw_packed)


def test_conv_down_train_backward_reads_dy_on_its_grid(monkeypatch):
    """`conv_down2_train`'s backward calls the stride-2 gradient functions
    once each and never builds a zero-inserted gradient, and still matches
    `jax.vjp`."""
    from anatomix_tpu_torch.kernels import conv_train as kt

    def no_zero_insert(*args, **kwargs):
        raise AssertionError("the backward built a zero-inserted gradient")

    calls = []

    def count(fn, name):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(kd, "zero_insert", no_zero_insert)
    monkeypatch.setattr(kt, "conv3x3x3_dgrad_s2_ndhwc_plain",
                        count(kt.conv3x3x3_dgrad_s2_ndhwc_plain, "dgrad"))
    monkeypatch.setattr(kt, "conv3x3x3_wgrad_s2_ndhwc_plain",
                        count(kt.conv3x3x3_wgrad_s2_ndhwc_plain, "wgrad"))
    rng = np.random.default_rng(10)
    ci, co = 6, 8
    x = rng.standard_normal((1, 9, 8, 7, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    ref_y, vjp = jax.vjp(
        lambda x_, w_, b_: jconv3d(x_, w_, b_, stride=2,
                                   padding=[(1, 1)] * 3),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dy = rng.standard_normal(ref_y.shape).astype(np.float32)
    ref = vjp(jnp.asarray(dy))
    leaves = [_t(x).requires_grad_(),
              _t(np.transpose(w, (4, 3, 0, 1, 2))).requires_grad_(),
              _t(b).requires_grad_()]
    y = kd.conv_down2_train(*leaves)
    gx, gw, gb = torch.autograd.grad(y, leaves, _t(dy))
    assert sorted(calls) == ["dgrad", "wgrad"]
    assert _rel(gx, ref[0]) <= 1e-5
    assert _rel(gw.permute(2, 3, 4, 1, 0), ref[1]) <= 1e-5
    assert _rel(gb, ref[2]) <= 1e-5


def test_conv_train_zero_padding_matches_jax_vjp():
    """The tokenizer's stride-1 conv (zero padding, f32 store) through
    `conv3x3x3_train` against `jax.vjp` of `conv3d(padding='SAME')`."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 5, 7, 4)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 4, 12)) * 0.2).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    ref_y, vjp = jax.vjp(
        lambda x_, w_, b_: jconv3d(x_, w_, b_, padding="SAME"),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dy = rng.standard_normal(ref_y.shape).astype(np.float32)
    ref = vjp(jnp.asarray(dy))
    leaves = [_t(x).requires_grad_(),
              _t(np.transpose(w, (4, 3, 0, 1, 2))).requires_grad_(),
              _t(b).requires_grad_()]
    y = conv3x3x3_train(*leaves, "zeros", out_dtype=torch.float32)
    assert _rel(y.detach(), ref_y) <= 1e-5
    gx, gw, gb = torch.autograd.grad(y, leaves, _t(dy))
    for got, r in ((gx, ref[0]), (gw.permute(2, 3, 4, 1, 0), ref[1]),
                   (gb, ref[2])):
        assert _rel(got, r) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 1, 2, 1, 3), (1, 2, 1, 1, 5)])
def test_exit8_function_gradient(shape):
    """The V1 exit's autograd Function (the factor-8 reshuffle minus the
    channel mean) against autograd through the plain reshuffle and torch's
    demean."""
    B, d, h, w, C = shape
    rng = np.random.default_rng(7)
    y = _t(rng.standard_normal((B, d, h, w, 512 * C)))
    g = _t(rng.standard_normal((B, 8 * d, 8 * h, 8 * w, C)))
    a = y.clone().requires_grad_()
    out = _Exit8Demean.apply(a)
    (got,) = torch.autograd.grad(out, a, g)
    b = y.clone().requires_grad_()
    ref_out = depth_to_space8_ndhwc_plain(b)
    ref_out = ref_out - ref_out.mean(dim=(1, 2, 3), keepdim=True)
    (ref,) = torch.autograd.grad(ref_out, b, g)
    torch.testing.assert_close(out.detach(), ref_out.detach(), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


SMALL = dict(input_channels=1, num_classes=4, embed_dim=32, eva_depth=1,
             eva_numheads=2, patch_embed_size=(8, 8, 8),
             input_shape=(16, 16, 16), num_register_tokens=2, qk_norm=True,
             out_norm="demean", scale_attn_inner=True, init_values=0.1,
             version="v2")


@pytest.fixture(scope="module")
def small_vit():
    """The small ViT's JAX parameters, an input, a random projection of the
    output, and JAX's output and gradient of `sum(out * proj)`."""
    jcfg = JPrimusConfig(**SMALL)
    jparams = jinit(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    proj = rng.standard_normal((2, 16, 16, 16, 4)).astype(np.float32)

    def jf(p):
        out = jprimus_apply(jcfg, p, jnp.asarray(x))
        return jnp.sum(out * proj), out

    (_, ref), rgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(jparams)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params=np_tree(jparams), x=x, proj=proj, ref=np.asarray(ref),
                rgrads=np_tree(rgrads))


@pytest.mark.parametrize("plain", [False, True])
def test_primus_train_forward_matches_jax(small_vit, plain):
    """The differentiable ViT forward (f32; on the CPU its Functions run
    the plain versions) against `primus_apply` of the JAX package on the
    CPU (XLA tokenizer, einsum attention, stage-wise decoder), and the
    gradient of a random projection of the output against JAX's, leaf by
    leaf within 1e-4 of the leaf's scale. Leaves whose gradient is zero up
    to f32 rounding (a conv bias under instance norm, the last decoder bias
    under demean: |ref| <= 1e-6 of the largest gradient) are held to that
    rounding instead."""
    cfg = PrimusConfig(**SMALL)
    params = from_jax_primus_params(cfg, small_vit["params"])
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    out = primus_train_apply(cfg, leaves, _t(small_vit["x"]),
                             compute_dtype=torch.float32, plain=plain)
    assert _rel(out.detach(), small_vit["ref"]) <= 1e-4
    names = list(leaves)
    # the last decoder bias cancels under demean: no gradient
    grads = torch.autograd.grad((out * _t(small_vit["proj"])).sum(),
                                [leaves[k] for k in names], allow_unused=True)
    ref_g = from_jax_primus_params(cfg, small_vit["rgrads"])
    net = max(float(r.abs().max()) for r in ref_g.values())
    for k, g in zip(names, grads):
        r = ref_g[k]
        g = torch.zeros_like(r) if g is None else g
        err = float((g - r).abs().max())
        assert err <= max(1e-4 * float(r.abs().max()), 1e-6 * net), k
