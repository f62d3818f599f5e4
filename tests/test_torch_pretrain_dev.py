"""The port's pretraining step for a UNet outside the 6M family, the
`anatomix-dev` options (instance norm eps 1e-2, Avg pool, trilinear), on
the CPU against the JAX package, in f32 on both sides: `build_all`'s plan
and init, `nce_forward` (the loss, the per-tap NCE, every gradient), one
train step's updated parameters and a three-step loss series, and the
trainer's CLI with a warm start from a JAX run and from the port's own.

A tiny dev-style UNet (ngf 4, num_downs 3, crop 16: the reflect-padded
bottleneck is 2^3). The two frameworks draw different random numbers, so
`num_patches` (512) covers every voxel of every tap and the sampler's
draws do not matter (as `tests/test_torch_pretrain.py` does); the 2^3 tap
takes `min(num_patches, voxels)` = 8 patches on both sides. G comes from
the port's seeded init carried to JAX, F from JAX's init. The batch is
seed 6: `test_no_relu_input_within_rounding_of_zero` asserts the
conditioning the gradient comparisons rest on.
"""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.models import unet as jax_unet
from anatomix_tpu.pretraining import train_step as jts
from anatomix_tpu.utils import checkpoint as jckpt
from anatomix_tpu_torch.models.convert import (
    from_jax_params,
    from_jax_train_state,
    to_jax_params,
)
from anatomix_tpu_torch.models.unet_train import unet_apply_train
from anatomix_tpu_torch.pretraining import train as ptrain
from anatomix_tpu_torch.pretraining import train_step as ts
from anatomix_tpu_torch.pretraining.config import PretrainConfig
from anatomix_tpu_torch.pretraining.warmstart import (
    load_partial,
    params_g_from_checkpoint,
)
from anatomix_tpu_torch.utils.checkpoint import load_pytree

DEV = dict(ngf=4, num_downs=3, output_nc=4, normG="instance",
           norm_eps_G=1e-2, pool_type="Avg", interp_type="trilinear",
           crop_size=16, netF_nc=16)
# an 8^3 encoder conv, the 2^3 bottleneck, the first 4^3 decoder conv and
# the 8^3 concat after the second upsample
TAPS = (13, 24, 31, 37)
P_ALL = 512  # every voxel of the largest (8^3) tap
LR = 1e-3


def _cfg(**kw):
    return PretrainConfig(**dict(DEV, nce_layers=TAPS, num_patches=P_ALL,
                                 **kw))


def _jax_config():
    return jax_unet.UnetConfig(
        dimension=3, input_nc=1, output_nc=DEV["output_nc"],
        num_downs=DEV["num_downs"], ngf=DEV["ngf"], norm="instance",
        pooling="Avg", interp="trilinear", norm_eps=1e-2)


@pytest.fixture(scope="module")
def dev():
    """The port's `build_all` state, G carried to a JAX train state with
    JAX's F, and that state carried back; a seeded batch."""
    plan, taps, state0, _ = ptrain.build_all(_cfg(), 2, device="cpu")
    jplan = jax_unet.build_plan(_jax_config())
    jparams_g = jax.tree_util.tree_map(
        jnp.asarray, to_jax_params(plan, state0.params_g))
    jstate = jts.init_train_state(
        jplan, jax.random.PRNGKey(0), tap_layers=TAPS, num_patches=P_ALL,
        netf_nc=16, lr=LR, params_g=jparams_g)
    state_np = jax.tree_util.tree_map(np.asarray, {
        "step": jstate.step, "params_g": jstate.params_g,
        "params_f": jstate.params_f, "lr_scale": jstate.lr_scale})
    rng = np.random.default_rng(6)
    views = rng.standard_normal((1, 2, 16, 16, 16, 1)).astype(np.float32)
    segs = rng.integers(0, 4, (1, 16, 16, 16, 1)).astype(np.int32)
    return dict(plan=plan, jplan=jplan, taps=taps, state0=state0,
                jstate=jstate, state_np=state_np, views=views, segs=segs)


def test_build_all_dev_plan_and_init(dev):
    """`build_all` takes the dev options (no `NotImplementedError`): the
    JAX package's plan, layer for layer, and its parameter layout (a bias
    on every conv of an instance-norm UNet, no norm parameters), traced
    from JAX's `init_params`, not run."""
    plan, jplan = dev["plan"], dev["jplan"]
    assert dev["taps"] == TAPS
    assert [(s.kind, s.in_ch, s.out_ch) for s in plan.layers] == [
        (s.kind, s.in_ch, s.out_ch) for s in jplan.layers]
    assert plan.config.norm_eps == 1e-2
    shapes = jax.eval_shape(lambda: jax_unet.init_params(
        jplan, jax.random.PRNGKey(0)))
    got = to_jax_params(plan, dev["state0"].params_g)
    assert sorted(got) == sorted(shapes)
    for idx, sub in shapes.items():
        assert sorted(got[idx]) == sorted(sub) == ["b", "w"]
        for k in sub:
            assert got[idx][k].shape == sub[k].shape
    for i in plan.conv_indices:
        assert not dev["state0"].params_g[f"model.{i}.bias"].any()


def test_no_relu_input_within_rounding_of_zero(dev):
    """The batch's conditioning, which the gradient tests rest on: every
    relu input (a norm output) ahead of the last tap has the same sign in
    the two frameworks' f32 forwards, so no relu takes another branch on
    the two sides. On a batch with a norm output within f32 rounding of
    zero (seed 5 has one at 1.8e-7, and its sign differs) that one voxel's
    gradient flips and moves the 16^3 level's dW by 1e-2 of its largest
    value, a kink no tolerance should cover."""
    plan = dev["plan"]
    x = np.concatenate([dev["views"][:, 0], dev["views"][:, 1]], 0)
    norms = tuple(i for i, s in enumerate(plan.layers)
                  if s.kind == "norm" and i < max(TAPS))
    _, ref, _ = jax_unet.unet_apply(
        dev["jplan"], dev["jstate"].params_g, jnp.asarray(x), layers=norms,
        train=True, compute_dtype=jnp.float32, conv_impl="xla")
    _, got, _ = unet_apply_train(plan, dev["state0"].params_g,
                                 torch.from_numpy(x), layers=norms,
                                 compute_dtype=torch.float32, plain=True)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r) > 0, g.numpy() > 0)


def test_nce_forward_matches_jax(dev):
    """The loss and each tap's NCE within 1e-4 relative; every gradient of
    G and F within 1e-4 of its leaf's largest value. A conv bias ahead of
    an instance norm, whose gradient the norm removes, holds f32 rounding
    noise on both sides (under 1e-6 of the network's largest gradient):
    within 1e-5 of that."""
    plan, jplan, jstate = dev["plan"], dev["jplan"], dev["jstate"]

    def jloss(pg, pf):
        return jts.nce_forward(
            jplan, pg, pf, jnp.asarray(dev["views"]),
            jnp.asarray(dev["segs"]), jax.random.PRNGKey(3),
            nce=jts.NCEOptions(temperature=0.33), train=True,
            compute_dtype=jnp.float32, conv_impl="xla", tap_layers=TAPS,
            num_patches=P_ALL)

    (ref, raux), (rg, rf) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jstate.params_g,
                                              jstate.params_f)
    state = from_jax_train_state(dev["state_np"], plan)
    loss, aux, grads_g, grads_f = ts.nce_loss_and_grads(
        plan, state.params_g, state.params_f,
        torch.from_numpy(dev["views"]), torch.from_numpy(dev["segs"]),
        torch.Generator().manual_seed(3), nce=ts.NCEOptions(temperature=0.33),
        compute_dtype=torch.float32, tap_layers=TAPS, num_patches=P_ALL)
    assert abs(float(loss) - float(ref)) <= 1e-4 * abs(float(ref))
    assert sorted(aux["per_layer"]) == sorted(raux["per_layer"])
    for k, v in aux["per_layer"].items():
        r = float(raux["per_layer"][k])
        assert abs(float(v) - r) <= 1e-4 * abs(r), k
    assert aux["new_g_stats"] == {}
    ref_g = {k: v for k, v in from_jax_params(plan, jax.tree_util.tree_map(
        np.asarray, rg)).items() if v.is_floating_point()}
    ref_f = ts.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        jax.tree_util.tree_map(np.asarray, rf))
    for got, ref in ((grads_g, ref_g), (grads_f, ref_f)):
        pairs = [(k, g, r) for (k, g), (_, r) in zip(ts.tree_items(got),
                                                     ts.tree_items(ref))]
        assert [k for k, _, _ in pairs] == [k for k, _ in ts.tree_items(ref)]
        net = max(float(r.abs().max()) for _, _, r in pairs)
        for k, g, r in pairs:
            err = float((g - r).abs().max())
            leaf = float(r.abs().max())
            if leaf < 1e-5 * net:  # rounding noise on both sides
                assert err <= 1e-5 * net, k
            else:
                assert err <= 1e-4 * leaf, k


def test_train_steps_match_jax(dev):
    """One step from the same state: the loss within 1e-4 relative and
    every updated parameter of G within 1e-2 of the learning rate of
    JAX's wherever JAX's gradient is above 1e-3 of its leaf's largest
    (AdamW's first update is about lr * sign(g): an element whose gradient
    is rounding noise steps a whole lr either way; a conv bias ahead of an
    instance norm, whose whole gradient is noise under 1e-5 of the
    network's largest, moves nothing the norm lets through).
    Then three free-running steps on the same batch: each loss within
    1e-3 relative, the gradient norms within 1e-3."""
    plan, jplan = dev["plan"], dev["jplan"]
    jstep = jts.build_train_step(
        jplan, num_patches=P_ALL, tap_layers=TAPS, nce_temperature=0.33,
        lr=LR, donate=False, conv_impl="xla", compute_dtype=jnp.float32)
    step = ts.build_train_step(plan, lr=LR, compute_dtype=torch.float32,
                               tap_layers=TAPS, num_patches=P_ALL)
    views, segs = dev["views"], dev["segs"]
    jstate = dev["jstate"]
    state = from_jax_train_state(dev["state_np"], plan)

    def jgrads(p):
        return jax.grad(lambda pg: jts.nce_forward(
            jplan, pg, jstate.params_f, jnp.asarray(views), jnp.asarray(segs),
            jax.random.PRNGKey(5), nce=jts.NCEOptions(temperature=0.33),
            train=True, compute_dtype=jnp.float32, conv_impl="xla",
            tap_layers=TAPS, num_patches=P_ALL)[0])(p)

    g0 = from_jax_params(plan, jax.tree_util.tree_map(
        np.asarray, jax.jit(jgrads)(jstate.params_g)))
    for i in range(3):
        jstate, rm = jstep(jstate, jnp.asarray(views), jnp.asarray(segs),
                           jax.random.PRNGKey(5))
        state, m = step(state, views, segs, torch.Generator().manual_seed(5))
        ref = float(rm["loss"])
        tol = 1e-4 if i == 0 else 1e-3
        assert abs(float(m["loss"]) - ref) <= tol * abs(ref), i
        for k in ("grad_norm_G", "grad_norm_F"):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-3)
        if i == 0:
            ref_p = from_jax_params(plan, jax.tree_util.tree_map(
                np.asarray, jstate.params_g))
            net = max(float(g.abs().max()) for g in g0.values())
            for k, v in state.params_g.items():
                g = g0[k].abs()
                if float(g.max()) < 1e-5 * net:
                    continue  # rounding noise: a conv bias ahead of a norm
                live = g > 1e-3 * g.max()
                err = (v - ref_p[k]).abs()[live]
                assert err.numel() == 0 or float(err.max()) <= 1e-2 * LR, k
    assert state.step == int(jstate.step) == 3


def test_frozen_layers_of_the_dev_plan(dev):
    """`unfreeze_layers` on the dev plan: JAX's frozen ids (every conv and
    norm up to the last tap but the ones kept; the instance norms hold no
    parameters), and a step through `build_all` leaves the frozen convs'
    weights and biases as they were and moves the weights of every other
    conv up to the last tap."""
    plan = dev["plan"]
    frozen = ts.frozen_layer_ids(plan, [31, 34], TAPS)
    assert frozen == jts.frozen_layer_ids(dev["jplan"], [31, 34], TAPS)
    assert set(frozen) == {i for i, s in enumerate(plan.layers)
                           if s.kind in ("conv", "norm")
                           and i <= max(TAPS)} - {31, 34}
    _, _, state, step = ptrain.build_all(_cfg(unfreeze_layers="31,34"), 2,
                                         device="cpu")
    new, _ = step(state, dev["views"], dev["segs"],
                  torch.Generator().manual_seed(5))
    for i in plan.conv_indices:
        if i in frozen:
            for leaf in ("weight", "bias"):
                k = f"model.{i}.{leaf}"
                assert torch.equal(new.params_g[k], state.params_g[k]), k
        elif i <= max(TAPS):
            k = f"model.{i}.weight"
            assert not torch.equal(new.params_g[k], state.params_g[k]), k


def _h5(path, n_subjects=2, size=16, seed=0):
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        for i in range(n_subjects):
            g = f.create_group(f"{i:06d}")
            g.create_dataset("img", data=rng.random((2, size, size, size),
                                                    np.float32))
            g.create_dataset("seg", data=rng.integers(
                0, 3, (size, size, size)).astype(np.uint8))


def test_trainer_cli_dev_and_warm_start(tmp_path, dev):
    """The CLI's flags give the dev config (`--normG instance --norm_eps_G
    1e-2 --pool_type Avg --interp_type trilinear`); the trainer runs it on
    the CPU warm-started from a JAX run's G (the JAX package's nested
    pytree, written by its `save_pytree`), which loads exactly; a warm
    start from the port's own run dir loads what that run left."""
    plan = dev["plan"]
    _h5(str(tmp_path / "train_data.hdf5"))
    jdir = tmp_path / "ckpt" / "jaxrun"
    os.makedirs(jdir)
    jg = to_jax_params(plan, ts.tree_map(lambda v: v + 0.01,
                                         dev["state0"].params_g))
    jckpt.save_pytree(str(jdir / "latest_net_G.npz"), jg)
    loaded = params_g_from_checkpoint(
        plan, load_pytree(str(jdir / "latest_net_G.npz")))
    merged = load_partial(plan, dev["state0"].params_g, loaded)
    for k, v in from_jax_params(plan, jg).items():
        torch.testing.assert_close(merged[k], v, rtol=0, atol=0)

    argv = ["--name", "dev", "--ckpt_dir", str(tmp_path / "ckpt"),
            "--dataroot", str(tmp_path), "--ngf", "4", "--num_downs", "3",
            "--output_nc", "4", "--normG", "instance", "--norm_eps_G",
            "1e-2", "--pool_type", "Avg", "--interp_type", "trilinear",
            "--crop_size", "16", "--nce_layers", "13,24,31,37",
            "--netF_nc", "16", "--n_mlps", "2", "--num_patches", "16",
            "--max_iters", "2", "--print_freq", "1", "--save_latest_freq",
            "2", "--evaluation_freq", "100", "--n_epochs", "1",
            "--n_epochs_decay", "0", "--data_parallel_devices", "1",
            "--pretrained_G_only_ckpt", str(jdir / "latest_net_G.npz"),
            "--device", "cpu"]
    args = ptrain.build_parser().parse_args(argv)
    cfg = ptrain.config_from_args(args)
    assert (cfg.normG, cfg.norm_eps_G, cfg.pool_type, cfg.interp_type) == (
        "instance", 1e-2, "Avg", "trilinear")
    state = ptrain.train(cfg, device=args.device)
    assert state.step == 2
    assert all(torch.isfinite(v).all() for v in state.params_g.values())
    run_dir = tmp_path / "ckpt" / "dev"
    again = load_partial(plan, dev["state0"].params_g, params_g_from_checkpoint(
        plan, load_pytree(str(run_dir / "latest_net_G.npz"))))
    for k, v in state.params_g.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)
