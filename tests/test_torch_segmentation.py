"""The port's few-shot segmentation model and train step on the CPU against
the JAX package, on the same seeded numpy inputs and the same weights
(carried across with `segmentation.model.to_jax_seg_params` /
`from_jax_seg_params`): losses, head and model, the train and eval
forwards, the train step (loss, gradients, Adam from JAX's optax state,
the cosine schedule). `test_torch_segmentation_loop.py` holds the
transforms, data, validation and the loop. A tiny UNet (num_downs 2, ngf 4, output_nc 4), 4
foreground classes (5 logits), crop 16, volumes 24^3; JAX runs its XLA
path (`conv_impl="xla"`), as its own `tests/test_segmentation.py` does.
Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anatomix_tpu.models import unet as jax_unet
from anatomix_tpu.segmentation import losses as jl
from anatomix_tpu.segmentation import model as jm
from anatomix_tpu.segmentation import train as jtr
from anatomix_tpu_torch.models.unet import init_params
from anatomix_tpu_torch.segmentation import losses as pl
from anatomix_tpu_torch.segmentation import model as pm
from anatomix_tpu_torch.segmentation import train as ptr

TINY = dict(num_downs=2, ngf=4, output_nc=4)
N_CLASSES = 4
CROP = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny volumes: the suite runs several
    workers, and many threads on small ops only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port_model(seed=0):
    """The port's tiny model with non-trivial running stats, and the same
    weights in the JAX layout as jnp arrays."""
    plan, params = pm.load_seg_model(N_CLASSES, ckpt_path="scratch",
                                     seed=seed, device="cpu", **TINY)
    rng = np.random.default_rng(100 + seed)
    for k, v in params["backbone"].items():
        if k.endswith("running_mean"):
            params["backbone"][k] = _t(rng.normal(0.0, 0.3, v.shape))
        elif k.endswith("running_var"):
            params["backbone"][k] = _t(rng.uniform(0.5, 2.0, v.shape))
    jplan = jax_unet.build_plan(jax_unet.UnetConfig(
        dimension=3, input_nc=1, **TINY))
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     pm.to_jax_seg_params(plan, params))
    return plan, params, jplan, jparams


def _batch(B=2, seed=3, size=CROP):
    """Images with structure the labels follow, and labels 0..4."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, N_CLASSES + 1, (B, size, size, size))
    img = (rng.standard_normal((B, size, size, size, 1)) * 0.3
           + lab[..., None] * 0.5).astype(np.float32)
    return img, lab.astype(np.int32)


# -----------------------------------------------------------------------------
# losses

@pytest.mark.parametrize("include_background", [False, True])
def test_losses_match_jax(include_background):
    """Dice (with and without the background, class 3 absent from the
    labels), cross entropy and DiceCE within 1e-6 relative."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 6, 7, 5)).astype(np.float32) * 2
    labels = rng.integers(0, 5, (2, 5, 6, 7))
    labels[labels == 3] = 4
    for lab in (labels, labels[..., None].astype(np.float32)):
        got = pl.dice_loss(_t(logits), torch.from_numpy(lab),
                           include_background=include_background)
        ref = jl.dice_loss(jnp.asarray(logits), jnp.asarray(lab),
                           include_background=include_background)
        assert _rel(got, ref) <= 1e-6
        got = pl.dice_ce_loss(_t(logits), torch.from_numpy(lab),
                              include_background=include_background)
        ref = jl.dice_ce_loss(jnp.asarray(logits), jnp.asarray(lab),
                              include_background=include_background)
        assert _rel(got, ref) <= 1e-6
    got = pl.cross_entropy_loss(_t(logits), torch.from_numpy(labels))
    ref = jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert _rel(got, ref) <= 1e-6


# -----------------------------------------------------------------------------
# head and model

def test_head_matches_jax():
    """The 1x1x1 head with carried weights, within 1e-6 relative."""
    rng = np.random.default_rng(1)
    head = {"w": rng.standard_normal((1, 1, 1, 4, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    feats = rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32)
    ref = jm.apply_head(jax.tree_util.tree_map(jnp.asarray, head),
                        jnp.asarray(feats))
    plan, _ = pm.load_seg_model(N_CLASSES, ckpt_path="scratch",
                                device="cpu", **TINY)
    port_head = pm.from_jax_seg_params(
        plan, {"backbone": _jax_backbone(plan), "head": head})["head"]
    assert port_head["weight"].shape == (5, 4, 1, 1, 1)
    assert _rel(pm.apply_head(port_head, _t(feats)), ref) <= 1e-6


def _jax_backbone(plan):
    from anatomix_tpu_torch.models.convert import to_jax_params

    return to_jax_params(plan, init_params(plan,
                                           torch.Generator().manual_seed(0)))


def test_head_init_bound():
    """nn.Conv3d's default init, as MONAI's UnetOutBlock has it: weight and
    bias in +-1/sqrt(fan_in) (0.25 for 16 features), the range used.
    The JAX package draws the weight from +-sqrt(6 / fan_in) (0.61;
    ROADMAP F7), which the port does not copy."""
    head = pm.init_head(torch.Generator().manual_seed(0), 16, 4)
    assert head["weight"].shape == (5, 16, 1, 1, 1)
    assert head["bias"].shape == (5,)
    for v in head.values():
        assert v.abs().max() <= 0.25
    assert head["weight"].abs().max() > 0.2
    jhead = jm.init_head(jax.random.PRNGKey(0), 16, 4)
    assert float(jnp.abs(jhead["w"]).max()) > 0.25  # F7
    # the reference's head is a plain nn.Conv3d
    conv = torch.nn.Conv3d(16, 5, 1)
    assert conv.weight.abs().max() <= 0.25


def test_load_seg_model_matches_jax(tmp_path):
    """From 'scratch' the same plan and parameter layout as JAX's (the
    draws differ); from a seeded `.pth` the same backbone, array for
    array."""
    plan, params = pm.load_seg_model(N_CLASSES, ckpt_path="scratch",
                                     device="cpu", **TINY)
    jplan = jax_unet.build_plan(jax_unet.UnetConfig(
        dimension=3, input_nc=1, **TINY))
    # JAX's scratch path traced, not run (its eager init takes ~20 s)
    jparams = jax.eval_shape(lambda: jm.load_seg_model(
        N_CLASSES, ckpt_path="scratch", **TINY)[1])
    assert [(s.kind, s.in_ch, s.out_ch) for s in plan.layers] == [
        (s.kind, s.in_ch, s.out_ch) for s in jplan.layers]
    got = pm.to_jax_seg_params(plan, params)
    shapes = jax.tree_util.tree_map(np.shape, got)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                            jparams)
    pth = str(tmp_path / "tiny.pth")
    torch.save(init_params(plan, torch.Generator().manual_seed(3)), pth)
    plan, params = pm.load_seg_model(N_CLASSES, ckpt_path=pth, device="cpu",
                                     **TINY)
    _, jparams = jm.load_seg_model(N_CLASSES, ckpt_path=pth, **TINY)
    got = pm.to_jax_seg_params(plan, params)["backbone"]
    ref = jax.tree_util.tree_map(np.asarray, jparams["backbone"])
    assert sorted(got) == sorted(ref)
    for idx in ref:
        assert sorted(got[idx]) == sorted(ref[idx])
        for leaf in ref[idx]:
            np.testing.assert_array_equal(got[idx][leaf], ref[idx][leaf])
    # the head: nn.Conv3d's layout, drawn from `seed + 1`
    again = pm.load_seg_model(N_CLASSES, ckpt_path=pth, device="cpu",
                              **TINY)[1]["head"]
    torch.testing.assert_close(again, params["head"], rtol=0, atol=0)


def test_backbones_the_walks_train(tmp_path):
    """A backbone with residual connections (an option the JAX package
    runs) now trains: its train-mode logits and running stats match JAX's
    `seg_forward(train=True)`, `build_seg_train_step` takes a step, and
    the eval forward after it (batch norms live, not folded: ROADMAP F10)
    matches JAX's unfolded eval forward; an instance-norm backbone (the dev
    UNet's options) trains through the general walk; the ViT variant is
    refused."""
    from anatomix_tpu_torch.models.unet import (
        UnetConfig,
        build_plan,
        trainable_state,
    )

    plan, params = pm.load_seg_model(
        N_CLASSES, ckpt_path="scratch", norm="instance", pooling="Avg",
        interp="trilinear", device="cpu", **TINY)
    x, lab = _batch(B=1)
    assert pm.seg_forward(plan, params, _t(x)).shape == (1, 16, 16, 16, 5)
    logits, stats = pm.seg_forward(plan, params, _t(x), train=True)
    assert logits.shape == (1, 16, 16, 16, 5) and stats == {}
    assert torch.isfinite(logits).all()
    rplan = build_plan(UnetConfig(input_nc=1, residual_connection=True,
                                  **TINY))
    rng = np.random.default_rng(7)
    backbone = trainable_state(rplan, init_params(
        rplan, torch.Generator().manual_seed(4)))
    for k, v in backbone.items():
        if k.endswith("running_mean"):
            backbone[k] = _t(rng.normal(0.0, 0.3, v.shape))
        elif k.endswith("running_var"):
            backbone[k] = _t(rng.uniform(0.5, 2.0, v.shape))
    rparams = {"backbone": backbone, "head": dict(params["head"])}
    jplan = jax_unet.build_plan(jax_unet.UnetConfig(
        dimension=3, input_nc=1, residual_connection=True, **TINY))

    def jparams():
        return jax.tree_util.tree_map(jnp.asarray,
                                      pm.to_jax_seg_params(rplan, rparams))

    ref, jstats = jm.seg_forward(jplan, jparams(), jnp.asarray(x),
                                 train=True, conv_impl="xla")
    got, stats = pm.seg_forward(rplan, rparams, _t(x), train=True,
                                plain=False)
    assert _rel(got, ref) <= 1e-4 and sorted(stats) == sorted(jstats)
    for idx, (mean, var) in stats.items():
        assert _rel(mean, jstats[idx][0]) <= 1e-5
        assert _rel(var, jstats[idx][1]) <= 1e-5
    opt = ptr.make_seg_optimizer(rparams)
    step = ptr.build_seg_train_step(rplan, opt)
    before = {k: v.clone() for k, v in rparams["backbone"].items()}
    loss = step(rparams, _t(x), torch.from_numpy(lab))
    assert torch.isfinite(loss) and any(
        not torch.equal(before[k], v)
        for k, v in rparams["backbone"].items())
    ref = jm.seg_forward(jplan, jparams(), jnp.asarray(x), conv_impl="xla")
    for plain in (True, False):
        got = pm.seg_forward(rplan, rparams, _t(x), plain=plain)
        assert _rel(got, ref) <= 1e-5, plain
    with pytest.raises(ValueError, match="ViT"):
        pm.load_seg_model(N_CLASSES, hf_variant="anatomix-dev-vit",
                          cache_path=str(tmp_path / "vit.npz"), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        pm.load_seg_model(N_CLASSES, device="cpu")


# -----------------------------------------------------------------------------
# forwards

@pytest.mark.parametrize("plain", [True, False])
def test_eval_forward_matches_jax(plain):
    """Eval logits (batch norm on the running stats): the eager f32 UNet
    (`plain`, the CPU's default) and the BN-folded fused forward on the
    kernels' plain versions, within 1e-5 relative."""
    plan, params, jplan, jparams = _port_model()
    x, _ = _batch()
    ref = jm.seg_forward(jplan, jparams, jnp.asarray(x), conv_impl="xla")
    got = pm.seg_forward(plan, params, _t(x), plain=plain)
    assert got.shape == ref.shape == (2, 16, 16, 16, 5)
    assert _rel(got, ref) <= 1e-5


def _float64(fn, *args):
    """`fn(*args)` with the port's plain path evaluated in float64: inside,
    `Tensor.float()` and `torch.float32` mean float64 and factories make
    float64 (as `tests/test_torch_vit_pretrain.py`'s witness does)."""
    default = torch.get_default_dtype()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        mp.setattr(torch, "float32", torch.float64)
        torch.set_default_dtype(torch.float64)
        try:
            return fn(*args)
        finally:
            torch.set_default_dtype(default)


def _params64(params):
    return {g: {k: v.detach().double() for k, v in d.items()}
            for g, d in params.items()}


@pytest.mark.parametrize("plain", [True, False])
def test_train_forward_matches_jax(plain):
    """Train-mode logits and the updated running stats at B = 2: the plain
    walk (`F.conv3d`) and the kernel walk (its wrappers' plain versions on
    the CPU, in f32). Against a float64 witness (the port's plain walk in
    float64) the logits are within 1e-5 relative and the stats within
    1e-6; against JAX within those plus JAX's own distance from the
    witness. JAX's one-pass batch-norm variance E[x^2] - E[x]^2 at the
    4^3 bottleneck puts its f32 logits 1.3-3.3e-5 from the witness on
    these batches, the port's two-pass variance 4-6e-6."""
    plan, params, jplan, jparams = _port_model()
    x, _ = _batch()
    ref, jstats = jm.seg_forward(jplan, jparams, jnp.asarray(x), train=True,
                                 conv_impl="xla")
    got, stats = pm.seg_forward(plan, params, _t(x), train=True, plain=plain)
    w, wstats = _float64(lambda: pm.seg_forward(
        plan, _params64(params), torch.from_numpy(x).double(), train=True,
        plain=True))
    assert w.dtype == torch.float64
    assert _rel(got, w) <= 1e-5
    assert _rel(got, ref) <= 1e-5 + _rel(ref, w)
    assert sorted(stats) == sorted(jstats) == sorted(wstats)
    for idx, (mean, var) in stats.items():
        for k, v in enumerate((mean, var)):
            assert _rel(v, wstats[idx][k]) <= 1e-6
            assert _rel(v, jstats[idx][k]) <= 1e-6 + _rel(jstats[idx][k],
                                                          wstats[idx][k])


# -----------------------------------------------------------------------------
# the train step

def _jax_loss_and_grads(jplan, jparams, x, lab):
    def loss_fn(p):
        logits, stats = jm.seg_forward(jplan, p, x, train=True,
                                       conv_impl="xla")
        return jl.dice_ce_loss(logits, lab), stats

    return jax.value_and_grad(loss_fn, has_aux=True)(jparams)


def _grads_by_name(plan, jgrads):
    """JAX's gradient pytree -> {trainable leaf name: numpy}, through the
    same layout map as the weights."""
    tree = pm.from_jax_seg_params(
        plan, jax.tree_util.tree_map(np.asarray, jgrads))
    return {name: v.numpy() for name, v in ptr.trainable_leaves(tree)}


def _loss_and_grads(plan, params, x, lab, plain=None):
    leaves = ptr.trainable_leaves(params)
    for _, v in leaves:
        v.requires_grad_()
    loss, _ = ptr.seg_loss(plan, params, x, torch.from_numpy(lab),
                           plain=plain)
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    return loss.detach(), {name: g.detach().double().numpy()
                           for (name, _), g in zip(leaves, grads)}


def _grad_err(got, ref):
    """The largest over leaves of mean|got - ref| / std(ref)."""
    return max(float(np.abs(got[n] - ref[n]).mean() / max(ref[n].std(),
                                                          1e-30))
               for n in ref)


@pytest.mark.parametrize("seed", [4, 7])
def test_loss_and_gradients_match_jax(seed):
    """The DiceCE loss within 1e-6 relative; the gradient of every
    trainable leaf as mean|err|/std within 1e-4 of JAX's and of a float64
    witness (the port's plain path in float64), on the plain and the
    kernel walk; JAX's running-stat gradients are zero (the port's
    optimizer never sees them).

    Conditioning: a max-pool window whose two largest inputs lie within
    f32 rounding of each other sends an f32 gradient to the other voxel,
    which moves a leaf's gradient by 2e-3 to 3e-2 of its std. Over batch
    seeds 3-12 that happens to the port's f32 walk on 2 batches (3, 5)
    and to JAX's on 4 (5, 6, 10, 12, where JAX's own 1-ulp spread shows
    it); elsewhere the port reads 4e-6 to 2.1e-5 from the witness and JAX
    3e-5 to 8e-5. Such a batch says nothing at 1e-4, so these batches sit
    on no kink of either f32 evaluation: JAX's 1-ulp spread is asserted
    under 1e-4 here, and the port's distance from the witness."""
    plan, params, jplan, jparams = _port_model()
    x, lab = _batch(seed=seed)
    (jloss, _), jgrads = _jax_loss_and_grads(jplan, jparams, jnp.asarray(x),
                                             jnp.asarray(lab))
    (_, _), jwit = _jax_loss_and_grads(jplan, jparams,
                                       jnp.asarray(_ulp(x)), jnp.asarray(lab))
    ref = _grads_by_name(plan, jgrads)
    assert _grad_err(_grads_by_name(plan, jwit), ref) <= 1e-4
    wloss, witness = _float64(lambda: _loss_and_grads(
        plan, _params64(params), torch.from_numpy(x).double(), lab,
        plain=True))
    assert _grad_err(ref, witness) <= 1e-4
    for plain in (True, False):
        loss, grads = _loss_and_grads(plan, params, _t(x), lab, plain=plain)
        assert _rel(loss, jloss) <= 1e-6 and _rel(loss, wloss) <= 1e-6
        assert sorted(grads) == sorted(ref)
        assert _grad_err(grads, ref) <= 1e-4
        assert _grad_err(grads, witness) <= 1e-4
    for sub in jgrads["backbone"].values():
        for leaf in ("mean", "var"):
            if leaf in sub:
                assert not np.asarray(sub[leaf]).any()


def _load_adam_state(optimizer, params, state):
    """Set the optimizer's moments and count from `adam_state`'s layout
    (here JAX's optax state, converted to the same names)."""
    step = torch.tensor(float(state["count"]))
    for name, p in ptr.trainable_leaves(params):
        optimizer.state[p] = {
            "step": step.clone(),
            "exp_avg": torch.as_tensor(state["mu"][name]).to(p).clone(),
            "exp_avg_sq": torch.as_tensor(state["nu"][name]).to(p).clone(),
        }


def _adam_state_by_name(plan, jopt):
    adam = jopt[0]
    mu = pm.from_jax_seg_params(plan, jax.tree_util.tree_map(np.asarray,
                                                             adam.mu))
    nu = pm.from_jax_seg_params(plan, jax.tree_util.tree_map(np.asarray,
                                                             adam.nu))
    return {"count": int(adam.count),
            "mu": dict(ptr.trainable_leaves(mu)),
            "nu": dict(ptr.trainable_leaves(nu))}


def _ulp(a):
    return np.nextafter(np.asarray(a, np.float32), np.float32(np.inf))


def test_three_steps_from_jax_state_match_jax():
    """Three steps, each started from JAX's parameters and optax state on
    its own batch: the loss within 1e-6 relative and the learning rate the
    cosine schedule's at each count; every leaf after the step within 2.5x
    JAX's own spread (its step from the same state with the images 1 ulp
    up) + 2e-3 of the learning rate, wherever |g| > 1e-3 max|g| of the
    leaf (JAX's gradient); the running stats within 1e-6 of the float64
    witness and of JAX + JAX's distance from it. Adam's first
    update is lr g / (|g| + eps), about +-lr for any gradient above 1e-8,
    so an element whose gradient is rounding noise (a batch-norm bias
    ahead of another batch norm, whose shift that norm removes) steps a
    whole lr either way; later updates m / sqrt(v) amplify the gradients'
    f32 differences (held above) where the moments nearly cancel: the
    steps read up to 1.34e-3 lr apart (JAX's spread 1.1e-4 lr). A wrong
    bias correction or a schedule an epoch off moves a step by 0.1-0.5
    lr."""
    lr, n_epochs, spe = 2e-4, 4, 2
    plan, params, jplan, jparams = _port_model()
    tx = optax.adam(jtr.cosine_annealing(lr, n_epochs, spe))
    jopt = tx.init(jparams)
    jstep = jtr.build_seg_train_step(jplan, tx)
    for i in range(3):
        x, lab = _batch(seed=20 + i)
        _, jg = _jax_loss_and_grads(jplan, jparams, jnp.asarray(x),
                                    jnp.asarray(lab))
        jg = _grads_by_name(plan, jg)
        new_j, new_jopt, jloss = jstep(jparams, jopt, jnp.asarray(x),
                                       jnp.asarray(lab))
        witness, _, _ = jstep(jparams, jopt, jnp.asarray(_ulp(x)),
                              jnp.asarray(lab))
        params = pm.from_jax_seg_params(
            plan, jax.tree_util.tree_map(np.asarray, jparams))
        _, wstats = _float64(lambda: pm.seg_forward(
            plan, _params64(params), torch.from_numpy(x).double(),
            train=True, plain=True))
        opt = ptr.make_seg_optimizer(params, lr)
        _load_adam_state(opt, params, _adam_state_by_name(plan, jopt))
        step = ptr.build_seg_train_step(
            plan, opt, ptr.cosine_annealing(lr, n_epochs, spe))
        loss = step(params, _t(x), torch.from_numpy(lab))
        assert _rel(loss, jloss) <= 1e-6
        assert ptr.adam_count(opt) == i + 1
        assert opt.param_groups[0]["lr"] == pytest.approx(
            float(jtr.cosine_annealing(lr, n_epochs, spe)(i)), rel=1e-6)
        ref = pm.from_jax_seg_params(
            plan, jax.tree_util.tree_map(np.asarray, new_j))
        wit = dict(ptr.trainable_leaves(pm.from_jax_seg_params(
            plan, jax.tree_util.tree_map(np.asarray, witness))))
        got = dict(ptr.trainable_leaves(params))
        for name, r in ptr.trainable_leaves(ref):
            big = torch.from_numpy(np.abs(jg[name])
                                   > 1e-3 * np.abs(jg[name]).max())
            assert big.any()
            spread = (wit[name] - r).abs()[big].max().item()
            err = (got[name].detach() - r).abs()[big].max().item()
            assert err <= 2.5 * spread + 2e-3 * lr, (i, name, err, spread)
        for k, v in ref["backbone"].items():
            if k.endswith(("running_mean", "running_var")):
                idx, stat = k.split(".")[1], int(k.endswith("var"))
                w = wstats[idx][stat]
                assert _rel(params["backbone"][k], w) <= 1e-6, (i, k)
                assert _rel(params["backbone"][k], v) <= 1e-6 + _rel(v, w)
        jparams, jopt = new_j, new_jopt


def test_cosine_schedule_matches_jax():
    """Over two epochs of three steps: the port's schedule at each count
    equals JAX's (f32) to f32 rounding and torch's CosineAnnealingLR
    stepped per epoch to 1e-12; the learning rate the step used is the
    schedule's at the count before the update."""
    lr, n_epochs, spe = 2e-4, 2, 3
    sched = ptr.cosine_annealing(lr, n_epochs, spe)
    jsched = jtr.cosine_annealing(lr, n_epochs, spe)
    w = torch.zeros(1, requires_grad=True)
    torch_opt = torch.optim.SGD([w], lr=lr)
    torch_sched = torch.optim.lr_scheduler.CosineAnnealingLR(
        torch_opt, T_max=n_epochs)
    plan, params = pm.load_seg_model(N_CLASSES, ckpt_path="scratch",
                                     device="cpu", **TINY)
    opt = ptr.make_seg_optimizer(params, lr)
    step = ptr.build_seg_train_step(plan, opt, sched)
    x, lab = _batch(B=1)
    rows = []
    for count in range(n_epochs * spe):
        step(params, _t(x), torch.from_numpy(lab))
        used = opt.param_groups[0]["lr"]
        rows.append((count, used, float(jsched(count)),
                     torch_opt.param_groups[0]["lr"]))
        if count % spe == spe - 1:
            torch_opt.step()
            torch_sched.step()
    print("count, port lr, JAX lr, torch CosineAnnealingLR")
    for row in rows:
        print(*row)
    for count, used, jlr, tlr in rows:
        assert used == sched(count)
        assert used == pytest.approx(jlr, rel=2 ** -23)
        assert used == pytest.approx(tlr, rel=1e-12)
    assert rows[0][1] == lr and rows[spe][1] == pytest.approx(lr / 2)
