"""The port's pretraining step against the JAX package on the CPU, in f32 on
both sides: the SupPatchNCE loss, the projector, batch norm, the max pool's
tie rule, the schedules, the patch sampler, the train-mode UNet, the
optimizer, `nce_forward` and three train steps, and the checkpoint.

The two frameworks draw different random numbers, so the step is held
against JAX with sampling that covers every voxel of every tap
(`num_patches` >= 512 at 8^3): the same coordinates serve both views and
a permutation of the patches leaves the loss, the projector's batch norms
and every gradient unchanged, so neither depends on the draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anatomix_tpu.models.unet import UnetConfig as JUnetConfig
from anatomix_tpu.models.unet import build_plan as jbuild_plan
from anatomix_tpu.models.unet import unet_apply
from anatomix_tpu.ops.norms import batch_norm_train as jbatch_norm_train
from anatomix_tpu.ops.pool import max_pool as jmax_pool
from anatomix_tpu.pretraining import losses as jlosses
from anatomix_tpu.pretraining import patch_sample as jps
from anatomix_tpu.pretraining import schedulers as jsched
from anatomix_tpu.pretraining import train_step as jts
from anatomix_tpu_torch.kernels.reshuffle import space_to_depth2
from anatomix_tpu_torch.models.convert import (
    from_jax_params,
    from_jax_train_state,
    to_jax_params,
)
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan, init_params
from anatomix_tpu_torch.models.unet_train_block import unet_apply_train_block
from anatomix_tpu_torch.ops.norms import batch_norm_train
from anatomix_tpu_torch.ops.pool import max_pool, max_pool_block
from anatomix_tpu_torch.pretraining import losses, patch_sample, schedulers
from anatomix_tpu_torch.pretraining import train_step as ts
from anatomix_tpu_torch.utils.checkpoint import (
    load_pytree,
    load_train_state,
    save_pytree,
    save_train_state,
)

TINY = dict(input_nc=1, output_nc=4, num_downs=2, ngf=4)
TAPS = (17, 20, 24, 31, 37)  # 2^3 bottleneck, 4^3 and 8^3 decoder, exit
P_ALL = 512  # every voxel of every tap at 8^3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# -----------------------------------------------------------------------------
# loss, projector, batch norm, pool

@pytest.mark.parametrize("weigh_rarity", [False, True])
@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("mode", ["raw", "sqrt"])
def test_sup_patch_nce_loss_matches_jax(weigh_rarity, balance, mode):
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 48, 16)).astype(np.float32)
    labels = rng.integers(0, 4, 48)
    labels[:3] = 7  # a rare class
    kw = dict(temperature=0.33, weigh_rarity=weigh_rarity,
              balance_denominator=balance, weighting_mode=mode)
    ref, rgrad = jax.value_and_grad(
        lambda f: jlosses.sup_patch_nce_loss(f, jnp.asarray(labels), **kw))(
        jnp.asarray(feats))
    f = _t(feats).requires_grad_()
    got = losses.sup_patch_nce_loss(f, torch.from_numpy(labels), **kw)
    (grad,) = torch.autograd.grad(got, f)
    assert abs(got.item() - float(ref)) <= 1e-5 * abs(float(ref))
    assert _rel(grad, rgrad) <= 1e-5


@pytest.mark.parametrize("train", [True, False])
def test_apply_patch_mlp_matches_jax(train):
    jparams = jps.init_patch_mlps(jax.random.PRNGKey(2), (12,), nc=16,
                                  n_mlps=3)["mlp_0"]
    # non-trivial running stats, so eval mode reads them
    jparams["bns"][0]["mean"] = jnp.full((16,), 0.1)
    jparams["bns"][0]["var"] = jnp.full((16,), 1.5)
    x = np.random.default_rng(3).standard_normal((64, 12)).astype(np.float32)
    ry, rstats = jps.apply_patch_mlp(jparams, jnp.asarray(x), train=train)
    params = ts.tree_map(_t, jax.tree_util.tree_map(np.asarray, jparams))
    y, stats = patch_sample.apply_patch_mlp(params, _t(x), train=train)
    assert _rel(y, ry) <= 1e-5
    for got, ref in zip(stats, rstats):
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-5, atol=1e-6)


def test_batch_norm_train_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 4, 5, 6, 8)) * 3 + 1).astype(np.float32)
    rm, rv = (rng.standard_normal(8).astype(np.float32),
              rng.uniform(0.5, 2, 8).astype(np.float32))
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)

    def jf(x, s, b):
        return jbatch_norm_train(x, jnp.asarray(rm), jnp.asarray(rv), s, b,
                                 eps=1e-5)

    (ry, rmean, rvar), vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias))
    rgrads = vjp((jnp.asarray(dy), jnp.zeros(8), jnp.zeros(8)))
    xs, ss, bs = (_t(a).requires_grad_() for a in (x, scale, bias))
    y, m, v = batch_norm_train(xs, _t(rm), _t(rv), ss, bs, eps=1e-5)
    grads = torch.autograd.grad(y, (xs, ss, bs), _t(dy))
    assert _rel(y.detach(), ry) <= 1e-5
    assert _rel(m, rmean) <= 1e-6 and _rel(v, rvar) <= 1e-5
    assert not m.requires_grad and not v.requires_grad
    for got, ref in zip(grads, rgrads):
        assert _rel(got, ref) <= 1e-4


@pytest.mark.parametrize("route", ["spatial", "block"])
def test_max_pool_gradient_goes_to_the_first_tie(route):
    """Post-ReLU maps tie at 0.0 all the time: the gradient of each 2^3
    window goes to its first maximum in (d, h, w) scan order, as in JAX
    (XLA's select-and-scatter and the block walk's custom VJP), both for
    `max_pool` and for the train walk's block route (space-to-depth, then
    `max_pool_block`)."""
    rng = np.random.default_rng(5)
    x = np.maximum(rng.integers(-3, 2, (2, 6, 4, 8, 3)), 0).astype(
        np.float32)  # mostly zeros and ones: ties in almost every window
    dy = rng.standard_normal((2, 3, 2, 4, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jmax_pool(v, 2), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(dy))
    xs = _t(x).requires_grad_()
    pooled = (max_pool(xs, 2) if route == "spatial"
              else max_pool_block(space_to_depth2(xs)))
    (got,) = torch.autograd.grad(pooled, xs, _t(dy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the same rule by hand: one nonzero per window, at the first maximum
    win = x.reshape(2, 3, 2, 2, 2, 4, 2, 3).transpose(0, 1, 3, 5, 2, 4, 6, 7)
    first = win.reshape(2, 3, 2, 4, 8, 3).argmax(axis=4)
    g = got.numpy().reshape(2, 3, 2, 2, 2, 4, 2, 3).transpose(
        0, 1, 3, 5, 2, 4, 6, 7).reshape(2, 3, 2, 4, 8, 3)
    np.testing.assert_array_equal(
        np.take_along_axis(g, first[:, :, :, :, None], axis=4)[..., 0, :],
        dy)


# -----------------------------------------------------------------------------
# schedules and sampling

@pytest.mark.parametrize(
    "policy", ["const_linear", "linear", "exponential", "step", "cosine"])
def test_make_schedule_matches_jax(policy):
    kw = dict(n_epochs=3, n_epochs_decay=4, steps_per_epoch=5,
              step_decay_iters=2)
    ref = jsched.make_schedule(2e-4, policy, **kw)
    got = schedulers.make_schedule(2e-4, policy, **kw)
    for step in range(51):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-12)
    with pytest.raises(ValueError):
        schedulers.make_schedule(2e-4, "plateau", **kw)
    p = schedulers.PlateauState(lr=1.0, patience=1)
    assert [p.step(v) for v in (3.0, 3.0, 3.0, 2.0)] == [1.0, 1.0, 0.5, 0.5]


@pytest.mark.parametrize("tap", [(8, 8, 8), (3, 5, 7)])
def test_labels_and_nearest_downsample_match_jax(tap):
    rng = np.random.default_rng(6)
    seg = rng.integers(0, 9, (16, 16, 16))
    coords = np.stack(np.meshgrid(*[np.arange(s) for s in tap],
                                  indexing="ij"), -1).reshape(-1, 3)
    ref = jps.labels_at_coords(jnp.asarray(seg), jnp.asarray(coords), tap)
    got = patch_sample.labels_at_coords(torch.from_numpy(seg),
                                        torch.from_numpy(coords), tap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    down = patch_sample.nearest_downsample(torch.from_numpy(seg), tap)
    np.testing.assert_array_equal(
        down.numpy(), np.asarray(jps.nearest_downsample(jnp.asarray(seg),
                                                        tap)))
    # the labels are the downsampled volume at the coords
    np.testing.assert_array_equal(
        got.numpy(), down.numpy()[coords[:, 0], coords[:, 1], coords[:, 2]])


def test_sample_patch_coords():
    gen = torch.Generator().manual_seed(0)
    spatial = (4, 5, 6)
    c = patch_sample.sample_patch_coords(gen, spatial, 50)
    flat = (c[:, 0] * 5 + c[:, 1]) * 6 + c[:, 2]
    assert c.shape == (50, 3) and len(set(flat.tolist())) == 50
    assert all((c[:, i] < s).all() and (c[:, i] >= 0).all()
               for i, s in enumerate(spatial))
    # p = n: every voxel exactly once
    c = patch_sample.sample_patch_coords(gen, spatial, 1000)
    flat = (c[:, 0] * 5 + c[:, 1]) * 6 + c[:, 2]
    assert sorted(flat.tolist()) == list(range(120))
    # enough foreground: every sample inside the mask
    mask = torch.zeros(spatial)
    mask[1:3, :, 2:] = 1  # 40 voxels
    c = patch_sample.sample_patch_coords(gen, spatial, 30, mask=mask)
    assert mask[c[:, 0], c[:, 1], c[:, 2]].all()
    # short foreground: all of it, then background
    c = patch_sample.sample_patch_coords(gen, spatial, 60, mask=mask)
    assert int(mask[c[:, 0], c[:, 1], c[:, 2]].sum()) == 40
    # the feature gather
    feat = torch.randn(4, 5, 6, 3, generator=gen)
    np.testing.assert_array_equal(
        patch_sample.gather_at_coords(feat, c).numpy(),
        feat[c[:, 0], c[:, 1], c[:, 2]].numpy())


# -----------------------------------------------------------------------------
# the train-mode UNet, the optimizer, the step

@pytest.fixture(scope="module")
def tiny():
    """The tiny UNet on both sides: G from the port's seeded init carried to
    JAX (JAX's own eager init compiles for tens of seconds on the CPU), F
    from JAX's."""
    jplan = jbuild_plan(JUnetConfig(dimension=3, **TINY))
    plan = build_plan(UnetConfig(**TINY))
    jparams_g = jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        plan, init_params(plan, torch.Generator().manual_seed(0))))
    jstate = jts.init_train_state(
        jplan, jax.random.PRNGKey(0), tap_layers=TAPS, num_patches=P_ALL,
        netf_nc=16, lr=1e-3, params_g=jparams_g)
    state_np = jax.tree_util.tree_map(np.asarray, {
        "step": jstate.step, "params_g": jstate.params_g,
        "params_f": jstate.params_f, "lr_scale": jstate.lr_scale})
    # seed 7 puts a kink of this tiny net within f32 rounding: its
    # gradients then move by up to 1e-2 (relative, per leaf) under a 1e-7
    # perturbation of the views, JAX's against JAX's too; seed 5 does not
    rng = np.random.default_rng(5)
    views = rng.standard_normal((1, 2, 8, 8, 8, 1)).astype(np.float32)
    segs = rng.integers(0, 4, (1, 8, 8, 8, 1)).astype(np.int32)
    return dict(jplan=jplan, plan=plan, jstate=jstate, state_np=state_np,
                views=views, segs=segs)


def test_train_unet_matches_jax_unet_apply(tiny):
    plan = tiny["plan"]
    jparams = tiny["jstate"].params_g
    x = np.random.default_rng(8).standard_normal(
        (2, 8, 8, 8, 1)).astype(np.float32)
    _, rtaps, rstats = unet_apply(
        tiny["jplan"], jparams, jnp.asarray(x), layers=TAPS, train=True,
        compute_dtype=jnp.float32, conv_impl="xla")
    params = from_jax_params(plan, jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    _, taps, stats = unet_apply_train_block(
        plan, params, _t(x), layers=TAPS, compute_dtype=torch.float32)
    assert len(taps) == len(rtaps)
    for got, ref in zip(taps, rtaps):
        assert tuple(got.shape) == ref.shape
        assert _rel(got, ref) <= 1e-4
    assert sorted(stats) == sorted(rstats)
    for k, (m, v) in stats.items():
        assert _rel(m, rstats[k][0]) <= 1e-4
        assert _rel(v, rstats[k][1]) <= 1e-4


def _opt_case(clip, accum, frozen):
    return pytest.param(clip, accum, frozen,
                        id=f"clip{clip}-accum{accum}-frozen{len(frozen)}")


@pytest.mark.parametrize("clip,accum,frozen", [
    _opt_case(None, 1, ()), _opt_case(0.5, 1, ()), _opt_case(None, 2, ()),
    _opt_case(0.5, 2, (0, 1, 10)),
])
def test_optimizer_matches_optax(tiny, clip, accum, frozen):
    """AdamW on the UNet's parameter tree with synthetic gradients against
    the JAX package's optax chain (masked, clipped, MultiSteps), four
    steps on a decaying schedule, <= 1e-6."""
    plan = tiny["plan"]
    jparams = tiny["jstate"].params_g
    jsch = jsched.make_schedule(1e-2, "const_linear", n_epochs=1,
                                n_epochs_decay=3, steps_per_epoch=1)
    sch = schedulers.make_schedule(1e-2, "const_linear", n_epochs=1,
                                   n_epochs_decay=3, steps_per_epoch=1)
    jtx = jts.make_optimizer(1e-2, weight_decay=1e-2, grad_clip=clip,
                             schedule=jsch, grad_accum=accum,
                             mask=jts._trainable_mask(jparams, frozen))
    jopt = jtx.init(jparams)
    params = from_jax_params(plan, jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    params = {k: v for k, v in params.items() if v.is_floating_point()}
    tx = ts.make_optimizer(1e-2, weight_decay=1e-2, grad_clip=clip,
                           schedule=sch, grad_accum=accum,
                           mask=ts._trainable_mask(params, frozen))
    opt = ts.init_opt_state(params, accum)
    rng = np.random.default_rng(9)
    for _ in range(4):
        jgrads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
                np.float32) * 0.3), jparams)
        grads = from_jax_params(plan, jax.tree_util.tree_map(np.asarray,
                                                             jgrads))
        upd, jopt = jtx.update(jgrads, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        params, opt = tx.update(
            {k: grads[k] for k in params}, opt, params)
        ref = jax.tree_util.tree_map(np.asarray, jparams)
        got = to_jax_params(plan, params)
        for idx in ref:
            for k in ref[idx]:
                np.testing.assert_allclose(got[idx][k], ref[idx][k],
                                           rtol=0, atol=1e-6)
    for i in frozen:
        assert all(np.array_equal(got[str(i)][k],
                                  np.asarray(tiny["jstate"].params_g[str(i)]
                                             [k])) for k in got[str(i)])


def _nce():
    return dict(tap_layers=TAPS, num_patches=P_ALL)


def _jax_grads_to_port(plan, jgrads_g, jgrads_f):
    g = from_jax_params(plan, jax.tree_util.tree_map(np.asarray, jgrads_g))
    f = ts.tree_map(_t, jax.tree_util.tree_map(np.asarray, jgrads_f))
    return g, f


def test_nce_forward_loss_and_grads_match_jax(tiny):
    plan, jplan, jstate = tiny["plan"], tiny["jplan"], tiny["jstate"]
    nce_j = jts.NCEOptions(temperature=0.33)

    def jloss(pg, pf):
        return jts.nce_forward(
            jplan, pg, pf, jnp.asarray(tiny["views"]),
            jnp.asarray(tiny["segs"]), jax.random.PRNGKey(3), nce=nce_j,
            train=True, compute_dtype=jnp.float32, conv_impl="xla",
            **_nce())

    (ref, raux), (rg, rf) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jstate.params_g,
                                              jstate.params_f)
    state = from_jax_train_state(tiny["state_np"], plan)
    loss, aux, grads_g, grads_f = ts.nce_loss_and_grads(
        plan, state.params_g, state.params_f,
        torch.from_numpy(tiny["views"]), torch.from_numpy(tiny["segs"]),
        torch.Generator().manual_seed(3), nce=ts.NCEOptions(temperature=0.33),
        compute_dtype=torch.float32, **_nce())
    assert abs(float(loss) - float(ref)) <= 1e-4 * abs(float(ref))
    for k, v in aux["per_layer"].items():
        assert abs(float(v) - float(raux["per_layer"][k])) <= 1e-4 * abs(
            float(v))
    # leaf by leaf: max |err| / max |ref| of the leaf. A leaf whose reference
    # is zero up to f32 rounding (a conv bias under batch norm: the norm
    # removes its gradient) is held to rounding of its network's largest
    # gradient instead.
    ref_g, ref_f = _jax_grads_to_port(plan, rg, rf)
    for got, ref in ((grads_g, {k: ref_g[k] for k in grads_g}),
                     (grads_f, ref_f)):
        pairs = [(k, g, r) for (k, g), (_, r) in zip(ts.tree_items(got),
                                                     ts.tree_items(ref))]
        net = max(float(r.abs().max()) for _, _, r in pairs)
        for k, g, r in pairs:
            leaf = float(r.abs().max())
            err = float((g - r).abs().max())
            assert err <= 1e-4 * max(leaf, 1e-5 * net), k


def test_three_train_steps_match_jax(tiny):
    plan, jplan = tiny["plan"], tiny["jplan"]
    jstep = jts.build_train_step(
        jplan, num_patches=P_ALL, tap_layers=TAPS, nce_temperature=0.33,
        lr=1e-3, donate=False, conv_impl="xla", compute_dtype=jnp.float32)
    step = ts.build_train_step(plan, lr=1e-3, compute_dtype=torch.float32,
                               **_nce())
    jstate = tiny["jstate"]
    state = from_jax_train_state(tiny["state_np"], plan)
    for i in range(3):
        jstate, rm = jstep(jstate, jnp.asarray(tiny["views"]),
                           jnp.asarray(tiny["segs"]), jax.random.PRNGKey(5))
        state, m = step(state, tiny["views"], tiny["segs"],
                        torch.Generator().manual_seed(5))
        ref = float(rm["loss"])
        assert abs(float(m["loss"]) - ref) <= 1e-3 * abs(ref), i
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        for k in ("grad_norm_G", "grad_norm_F"):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-3)
    assert state.step == int(jstate.step) == 3
    # the running stats went through _merge_bn_stats on both sides
    got = to_jax_params(plan, state.params_g)
    np.testing.assert_allclose(got["1"]["var"],
                               np.asarray(jstate.params_g["1"]["var"]),
                               rtol=1e-4)


def test_checkpoint_round_trip_is_exact(tmp_path, tiny):
    plan = tiny["plan"]
    state = from_jax_train_state(tiny["state_np"], plan, grad_accum=2)
    step = ts.build_train_step(plan, lr=1e-3, compute_dtype=torch.float32,
                               grad_accum=2, tap_layers=TAPS, num_patches=8)
    for _ in range(3):  # one update, one pending accumulation
        state, _ = step(state, tiny["views"], tiny["segs"],
                        torch.Generator().manual_seed(1))
    path = str(tmp_path / "state.npz")
    save_train_state(path, state)
    back = load_train_state(path, device="cpu")
    assert (back.step, back.lr_scale) == (state.step, state.lr_scale)
    for name in ("params_g", "params_f", "opt_state_g", "opt_state_f"):
        a = list(ts.tree_items(getattr(state, name)))
        b = list(ts.tree_items(getattr(back, name)))
        assert [k for k, _ in a] == [k for k, _ in b]
        for (k, x), (_, y) in zip(a, b):
            if torch.is_tensor(x):
                assert x.dtype == y.dtype and torch.equal(x, y), k
            else:
                assert x == y, k
    assert state.opt_state_g["mini_step"] == 1
    # weights alone, as the JAX package's save_pytree writes them
    save_pytree(str(tmp_path / "g.npz"), state.params_f)
    tree = load_pytree(str(tmp_path / "g.npz"))
    for (k, x), (_, y) in zip(ts.tree_items(state.params_f),
                              ts.tree_items(tree)):
        np.testing.assert_array_equal(x.numpy(), y)
