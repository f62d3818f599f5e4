"""The port's general train walk (`models/unet_train.unet_apply_train`) on
the CPU against the JAX package's `unet_apply(train=True,
conv_impl="xla")`, in f32 on both sides, on the same seeded numpy inputs
and the same weights (carried across with `models.convert`): the output,
the taps, the running-stat updates and the gradient of a fixed scalar loss
with respect to every parameter, for the plain walk (`F.conv3d`) and the
kernel walk (its wrappers' plain versions on the CPU). The configurations:
the `anatomix-dev` options (instance norm eps 1e-2, Avg pool, trilinear,
reflect), `instance_affine`, zeros padding, batch norm with Avg pool and
trilinear, and the 6M family, where the general walk must also equal the
block walk (`unet_apply_train_block`). A tiny UNet (ngf 4, num_downs 3, a
16^3 input, so the reflect-padded bottleneck is 2^3), batch 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.models.unet import UnetConfig as JUnetConfig
from anatomix_tpu.models.unet import build_plan as jbuild_plan
from anatomix_tpu.models.unet import unet_apply
from anatomix_tpu.ops.pool import avg_pool as javg_pool
from anatomix_tpu.ops.resize import upsample2x as jupsample2x
from anatomix_tpu_torch.models.convert import from_jax_params, to_jax_params
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan, init_params
from anatomix_tpu_torch.models.unet_train import (
    unet_apply_train,
    unet_train_forward,
    uses_split,
)
from anatomix_tpu_torch.models.unet_train_block import unet_apply_train_block
from anatomix_tpu_torch.ops.pool import avg_pool
from anatomix_tpu_torch.ops.resize import upsample2x

BASE = dict(input_nc=1, output_nc=4, num_downs=3, ngf=4)
# the stem's output at 16^3, the bottleneck's first conv at 2^3, the
# first decoder conv at 4^3, the concat after the last upsample at 16^3
TAPS = (3, 24, 31, 44)
CONFIGS = {
    "dev": dict(norm="instance", norm_eps=1e-2, pooling="Avg",
                interp="trilinear"),
    "instance_affine": dict(norm="instance_affine", pooling="Avg",
                            interp="nearest", activation="lrelu"),
    "zeros": dict(norm="instance", pooling="Avg", interp="trilinear",
                  pad_type="zeros"),
    "batch_avg_trilinear": dict(norm="batch", pooling="Avg",
                                interp="trilinear"),
    "6M": dict(norm="batch", pooling="Max", interp="nearest"),
}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, ref):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _model(name):
    """Both plans and the same weights: the port's seeded init with every
    leaf made non-trivial (conv biases, norm scales and biases, running
    stats), as a state dict and as JAX's pytree."""
    cfg = dict(BASE, **CONFIGS[name])
    plan = build_plan(UnetConfig(**cfg))
    jplan = jbuild_plan(JUnetConfig(dimension=3, **cfg))
    sd = init_params(plan, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    for k, v in sd.items():
        if not v.is_floating_point():
            continue
        if k.endswith("running_var"):
            sd[k] = _t(rng.uniform(0.5, 2.0, v.shape))
        elif k.endswith(("running_mean", ".bias")):
            sd[k] = _t(rng.normal(0.0, 0.3, v.shape))
        elif v.dim() == 1:  # a norm's scale
            sd[k] = _t(rng.uniform(0.5, 1.5, v.shape))
    params = {k: v for k, v in sd.items() if v.is_floating_point()}
    jparams = jax.tree_util.tree_map(jnp.asarray, to_jax_params(plan, sd))
    return plan, jplan, params, jparams


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    return x


def _cotangents(shapes, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_run(jplan, jparams, x, cots):
    """JAX's output, taps, stats and the gradients of sum(out * c0) +
    sum_t sum(tap_t * c_t) with respect to every parameter."""
    def fn(p):
        out, taps, stats = unet_apply(
            jplan, p, x, layers=TAPS, train=True,
            compute_dtype=jnp.float32, conv_impl="xla")
        loss = sum(jnp.sum(v * c) for v, c in zip([out] + list(taps),
                                                  cots))
        return loss, (out, taps, stats)

    (_, (out, taps, stats)), grads = jax.jit(
        jax.value_and_grad(fn, has_aux=True))(jparams)
    return out, taps, stats, grads


def _shapes(plan):
    """The output's and each tap's shape at the 16^3 input."""
    return [(2, 16, 16, 16, 4)] + [
        (2,) + (16 // 2 ** lv,) * 3 + (c,) for lv, c in zip(
            (0, 3, 2, 0), plan.tap_channels(TAPS))]


def _port_run(walk, plan, params, x, cots, compute_dtype=torch.float32,
              **kw):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()
              if not k.endswith(("running_mean", "running_var"))}
    full = dict(params, **leaves)
    out, taps, stats = walk(plan, full, _t(x), layers=TAPS,
                            compute_dtype=compute_dtype, **kw)
    loss = sum((v * _t(c)).sum() for v, c in zip([out] + list(taps), cots))
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return out.detach(), [t.detach() for t in taps], stats, dict(
        zip(names, grads))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_general_walk_matches_jax(name):
    """Output and taps within 1e-4 of JAX's (max|err| / max|ref|), the
    running stats within 1e-5, and each parameter's gradient within 1e-4
    of the largest gradient of the network (a conv bias ahead of a norm
    has a gradient of f32 rounding noise: the norm removes it), on the
    plain and the kernel walk; the 6M family's general walk equal to its
    block walk within 1e-5 (the same arithmetic but the pool's and the
    upsample's layout)."""
    plan, jplan, params, jparams = _model(name)
    x = _inputs()
    cots = _cotangents(_shapes(plan))
    rout, rtaps, rstats, rgrads = _jax_run(jplan, jparams, jnp.asarray(x),
                                           [jnp.asarray(c) for c in cots])
    ref_g = {k: v for k, v in from_jax_params(plan, jax.tree_util.tree_map(
        np.asarray, rgrads)).items() if v.is_floating_point()
        and not k.endswith(("running_mean", "running_var"))}
    net = max(float(v.abs().max()) for v in ref_g.values())
    runs = {plain: _port_run(unet_apply_train, plan, params, x, cots,
                             plain=plain) for plain in (True, False)}
    for plain, (out, taps, stats, grads) in runs.items():
        assert out.shape == rout.shape
        assert _rel(out, rout) <= 1e-4, plain
        assert len(taps) == len(rtaps) == len(TAPS)
        for got, ref in zip(taps, rtaps):
            assert tuple(got.shape) == ref.shape
            assert _rel(got, ref) <= 1e-4, plain
        assert sorted(stats) == sorted(rstats)
        for k, (m, v) in stats.items():
            assert _rel(m, rstats[k][0]) <= 1e-5
            assert _rel(v, rstats[k][1]) <= 1e-5
        assert sorted(grads) == sorted(ref_g)
        for k, g in grads.items():
            err = float((g - ref_g[k]).abs().max())
            assert err <= 1e-4 * net, (plain, k, err / net)
    if name == "6M":
        out, taps, stats, grads = _port_run(unet_apply_train_block, plan,
                                            params, x, cots)
        gen = runs[False]
        assert _rel(gen[0], out) <= 1e-5
        for a, b in zip(gen[1], taps):
            assert _rel(a, b) <= 1e-5
        for k in grads:
            assert float((gen[3][k] - grads[k]).abs().max()) <= 1e-5 * net


def test_dispatch_and_split():
    """`unet_train_forward` takes the block walk for the 6M family and the
    general walk otherwise; only a live norm in bf16 reads the split."""
    import anatomix_tpu_torch.models.unet_train as ut

    for name, walk in (("6M", "unet_apply_train_block"),
                       ("dev", "unet_apply_train")):
        plan, _, params, _ = _model(name)
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ut, walk, lambda *a, **k: calls.append(walk) or (
                None, [], {}))
            ut.unet_train_forward(plan, params, _t(_inputs()))
        assert calls == [walk]
    dev_plan = _model("dev")[0]
    bn_plan = _model("batch_avg_trilinear")[0]
    assert uses_split(dev_plan, torch.bfloat16)
    assert not uses_split(dev_plan, torch.float32)
    assert not uses_split(bn_plan, torch.bfloat16)


def test_dev_walk_in_bf16_reads_the_split():
    """The dev walk with bf16 compute on the CPU (the kernels' plain
    versions on the three-term split, the backward on the bf16 roundings
    of x and w): f32 activations; the output and the taps within 1e-4
    mean|err|/std of the f32 plain walk (the split reads the f32 product
    to about 2^-16; they read 5e-6 to 6e-5); every gradient finite, each
    conv's dW within 5e-2 mean|err|/std, the bound
    the step's kernel backward is held to on the card (they read 2e-3 to
    1.5e-2 here: the backward's bf16 roundings)."""
    plan, _, params, _ = _model("dev")
    x = _inputs()
    cots = _cotangents(_shapes(plan))
    ref = _port_run(unet_apply_train, plan, params, x, cots, plain=True)
    got = _port_run(unet_apply_train, plan, params, x, cots,
                    compute_dtype=torch.bfloat16)
    for a, b in zip([got[0]] + got[1], [ref[0]] + ref[1]):
        assert a.dtype == torch.float32
        e = float((a - b).abs().mean() / b.std())
        assert e <= 1e-4, e
    for k, g in got[3].items():
        assert torch.isfinite(g).all()
    # each conv's dW (the biases ahead of a norm get f32 rounding noise)
    for i in plan.conv_indices:
        g, r = got[3][f"model.{i}.weight"], ref[3][f"model.{i}.weight"]
        e = float((g - r).abs().mean() / r.std())
        assert e <= 5e-2, (i, e)


@pytest.mark.parametrize("op", ["avg_pool", "trilinear", "nearest"])
def test_pool_and_upsample_gradients_match_jax(op):
    """The walk's Avg pool and x2 upsamples (torch autograd over the plain
    ops) against `jax.vjp` of the JAX package's `avg_pool` and
    `upsample2x` (half-pixel trilinear, legacy nearest) on ragged extents:
    values and input gradients within 1e-6 relative."""
    rng = np.random.default_rng(9)
    small = op != "avg_pool"
    x = rng.standard_normal((2, 3, 4, 5, 3) if small
                            else (2, 6, 8, 10, 3)).astype(np.float32)
    if op == "avg_pool":
        jf, pf = (lambda v: javg_pool(v, 2)), (lambda v: avg_pool(v, 2))
    else:
        jf = lambda v: jupsample2x(v, op)  # noqa: E731
        pf = lambda v: upsample2x(v, op)  # noqa: E731
    ref, vjp = jax.vjp(jf, jnp.asarray(x))
    dy = rng.standard_normal(ref.shape).astype(np.float32)
    (rgrad,) = vjp(jnp.asarray(dy))
    xs = _t(x).requires_grad_()
    y = pf(xs)
    (grad,) = torch.autograd.grad(y, xs, _t(dy))
    assert _rel(y, ref) <= 1e-6
    assert _rel(grad, rgrad) <= 1e-6
