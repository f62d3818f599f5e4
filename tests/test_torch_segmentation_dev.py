"""Few-shot segmentation on an instance-norm backbone (the `anatomix-dev`
options: instance norm, Avg pool, trilinear) on the CPU against the JAX
package, on the same seeded numpy inputs and the same weights (carried
across with `segmentation.model.to_jax_seg_params`): the train-mode
logits, the DiceCE loss and every trainable leaf's gradient through the
general train walk, the eval predictor, the two loading routes' norm eps,
and the CLI with `--norm instance --interp trilinear --pooling Avg`. A tiny
UNet (num_downs 2, ngf 4, output_nc 4), 4 foreground classes, crop 16; JAX
runs its XLA path (`conv_impl="xla"`). Each test states its tolerance.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.models import unet as jax_unet
from anatomix_tpu.segmentation import losses as jl
from anatomix_tpu.segmentation import model as jm
from anatomix_tpu_torch.models import registry
from anatomix_tpu_torch.models.unet import init_params
from anatomix_tpu_torch.models.unet_train import unet_apply_train
from anatomix_tpu_torch.segmentation import losses as pl
from anatomix_tpu_torch.segmentation import model as pm
from anatomix_tpu_torch.segmentation import train as ptr
from anatomix_tpu_torch.utils.checkpoint import load_pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = dict(num_downs=2, ngf=4, output_nc=4, norm="instance", pooling="Avg",
           interp="trilinear")
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


def _model():
    """The port's tiny instance-norm model (its conv biases made nonzero)
    and the same weights in the JAX layout as jnp arrays."""
    plan, params = pm.load_seg_model(N_CLASSES, ckpt_path="scratch",
                                     device="cpu", **DEV)
    rng = np.random.default_rng(100)
    for k, v in params["backbone"].items():
        if k.endswith(".bias"):
            params["backbone"][k] = _t(rng.normal(0.0, 0.3, v.shape))
    jplan = jax_unet.build_plan(jax_unet.UnetConfig(
        dimension=3, input_nc=1, **DEV))
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


def _witness(fn, params, x):
    """`fn(params, x)` on the port's plain path in float64 (the f32 routes'
    witness, as `tests/test_torch_segmentation.py` takes it)."""
    from test_torch_segmentation import _float64, _params64

    return _float64(lambda: fn(_params64(params),
                               torch.from_numpy(x).double()))


@pytest.mark.parametrize("plain", [True, False])
def test_train_forward_matches_jax(plain):
    """Train-mode logits of the general walk at B = 2 (the plain walk, and
    the kernel walk on its wrappers' plain versions, in f32): within 1e-5
    relative of a float64 witness (the port's plain walk in float64), and
    of JAX's within that plus JAX's own distance from the witness (JAX's
    f32 logits read 0.9-1.9e-5 from it on batch seeds 3-7, the port's
    2-3e-6); no running stats on either side."""
    plan, params, jplan, jparams = _model()
    x, _ = _batch()
    ref, jstats = jm.seg_forward(jplan, jparams, jnp.asarray(x), train=True,
                                 conv_impl="xla")
    got, stats = pm.seg_forward(plan, params, _t(x), train=True, plain=plain)
    w, _ = _witness(lambda p, v: pm.seg_forward(plan, p, v, train=True,
                                                plain=True), params, x)
    assert w.dtype == torch.float64
    assert got.shape == ref.shape == (2, 16, 16, 16, 5)
    assert _rel(got, w) <= 1e-5
    assert _rel(got, ref) <= 1e-5 + _rel(ref, w)
    assert stats == {} and jstats == {}


def _jax_loss_and_grads(jplan, jparams, x, lab):
    def loss_fn(p):
        logits, _ = jm.seg_forward(jplan, p, x, train=True, conv_impl="xla")
        return jl.dice_ce_loss(logits, lab)

    return jax.value_and_grad(loss_fn)(jparams)


def _loss_and_grads(plan, params, x, lab, plain):
    leaves = ptr.trainable_leaves(params)
    for _, v in leaves:
        v.requires_grad_()
    loss, _ = ptr.seg_loss(plan, params, x, torch.from_numpy(lab),
                           plain=plain)
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    return loss.detach(), {name: g.detach().double().numpy()
                           for (name, _), g in zip(leaves, grads)}


def test_no_relu_input_within_rounding_of_zero():
    """The batch's conditioning, which the gradient test rests on: every
    relu input (a norm output) has the same sign in the two frameworks'
    f32 forwards, so no relu takes another branch on the two sides (one
    that did would move a level's dW by about 1e-2)."""
    plan, params, jplan, jparams = _model()
    x, _ = _batch()
    norms = tuple(i for i, s in enumerate(plan.layers) if s.kind == "norm")
    _, ref, _ = jax_unet.unet_apply(
        jplan, jparams["backbone"], jnp.asarray(x), layers=norms,
        train=True, compute_dtype=jnp.float32, conv_impl="xla")
    _, got, _ = unet_apply_train(plan, params["backbone"], _t(x),
                                 layers=norms, compute_dtype=torch.float32,
                                 plain=True)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r) > 0, g.numpy() > 0)


def test_loss_and_gradients_match_jax():
    """The DiceCE loss within 1e-6 relative of the float64 witness, and of
    JAX's within that plus JAX's distance from it; the gradient of every
    trainable leaf within 1e-4 of its largest value, on the plain and the
    kernel walk, except the conv biases ahead of an instance norm, whose
    gradient the norm removes: f32 rounding noise on both sides, within
    1e-5 of the largest gradient of the model."""
    plan, params, jplan, jparams = _model()
    x, lab = _batch()
    jloss, jgrads = _jax_loss_and_grads(jplan, jparams, jnp.asarray(x),
                                        jnp.asarray(lab))
    tree = pm.from_jax_seg_params(plan, jax.tree_util.tree_map(np.asarray,
                                                               jgrads))
    ref = {n: v.double().numpy() for n, v in ptr.trainable_leaves(tree)}
    net = max(np.abs(v).max() for v in ref.values())
    wloss = _witness(lambda p, v: pm.seg_forward(
        plan, p, v, train=True, plain=True)[0], params, x)
    wloss = pl.dice_ce_loss(wloss, torch.from_numpy(lab))
    for plain in (True, False):
        loss, grads = _loss_and_grads(plan, params, _t(x), lab, plain)
        assert _rel(loss, wloss) <= 1e-6
        assert _rel(loss, jloss) <= 1e-6 + _rel(jloss, wloss)
        assert sorted(grads) == sorted(ref)
        for n, r in ref.items():
            err = np.abs(grads[n] - r).max()
            leaf = np.abs(r).max()
            if leaf < 1e-5 * net:
                assert err <= 1e-5 * net, (plain, n)
            else:
                assert err <= 1e-4 * leaf, (plain, n, err / leaf)


@pytest.mark.parametrize("plain", [True, False])
def test_eval_predictor_matches_jax(plain):
    """The eval logits: the eager f32 UNet (`plain`) and the fused forward
    of the unfolded live-norm plan (`unet_apply_fused` on the kernels'
    plain versions, f32 on the CPU): within 1e-5 relative of the float64
    witness, and of JAX's `seg_forward` within that plus JAX's distance
    from it."""
    plan, params, jplan, jparams = _model()
    x, _ = _batch()
    ref = jm.seg_forward(jplan, jparams, jnp.asarray(x), conv_impl="xla")
    got = pm.make_seg_predictor(plan, params, plain=plain)(_t(x))
    w = _witness(lambda p, v: pm.make_seg_predictor(plan, p, plain=True)(v),
                 params, x)
    assert got.shape == ref.shape == (2, 16, 16, 16, 5)
    assert _rel(got, w) <= 1e-5
    assert _rel(got, ref) <= 1e-5 + _rel(ref, w)


def test_loading_routes_and_their_norm_eps(tmp_path, monkeypatch):
    """The two routes to an instance-norm backbone keep their eps, as the
    JAX package's do (ROADMAP fault F8): `--pretrained_ckpt` builds the
    plan with `UnetConfig`'s default 1e-5, as JAX's `_load_backbone` does;
    a registry variant keeps its own (1e-2 for `anatomix-dev`; here the
    variant cut to the tiny widths, read from a local `.pth`). The
    variant's model trains: one step, a finite loss, the weights moved."""
    plan, params = pm.load_seg_model(N_CLASSES, ckpt_path="scratch",
                                     device="cpu", **DEV)
    pth = str(tmp_path / "tiny_dev.pth")
    torch.save(init_params(plan, torch.Generator().manual_seed(3)), pth)
    plan_c, _ = pm.load_seg_model(N_CLASSES, ckpt_path=pth, device="cpu",
                                  **DEV)
    jplan_c, _ = jm.load_seg_model(N_CLASSES, ckpt_path=pth, **DEV)
    assert plan_c.config.norm_eps == jplan_c.config.norm_eps == 1e-5
    kw = dict(registry.ANATOMIX_VARIANTS["anatomix-dev"]["unet_kwargs"],
              num_downs=2, ngf=4, output_nc=4)
    monkeypatch.setitem(registry.ANATOMIX_VARIANTS, "anatomix-dev",
                        {"unet_kwargs": kw, "output_channels": 4})
    plan_h, params_h = pm.load_seg_model(
        N_CLASSES, hf_variant="anatomix-dev", cache_path=pth, device="cpu")
    assert plan_h.config.norm_eps == 1e-2
    assert plan_h.layers == plan.layers
    before = params_h["backbone"]["model.0.weight"].clone()
    step = ptr.build_seg_train_step(plan_h, ptr.make_seg_optimizer(params_h))
    x, lab = _batch()
    loss = step(params_h, _t(x), torch.from_numpy(lab))
    assert np.isfinite(float(loss))
    assert not torch.equal(params_h["backbone"]["model.0.weight"], before)


def test_cli_dev_options_on_the_cpu(tmp_path):
    """`python -m anatomix_tpu_torch.segmentation.train --device cpu
    --norm instance --interp trilinear --pooling Avg` for 2 epochs with
    `--val_interval 1`: the checkpoints, finite train and validation
    losses."""
    from test_torch_segmentation_loop import _dataset

    root = _dataset(str(tmp_path / "data"), n_train=3)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "anatomix_tpu_torch.segmentation.train",
         "--exp_name", "dev", "--dataset", root, "--n_classes", "4",
         "--pretrained_ckpt", "scratch", "--crop_size", "16",
         "--batch_size", "2", "--n_epochs", "2", "--n_iters_per_epoch", "2",
         "--train_amount", "2", "--val_interval", "1", "--num_downs", "2",
         "--ngf", "4", "--output_nc", "4", "--norm", "instance", "--interp",
         "trilinear", "--pooling", "Avg", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ckpt = tmp_path / "finetuning_runs" / "checkpoints" / "dev"
    names = sorted(os.listdir(ckpt))
    assert {"epoch0001.npz", "epoch0002.npz"} <= set(names)
    state = load_pytree(str(ckpt / "epoch0002.npz"))
    assert int(state["opt_state"]["count"]) == 4
    assert "model.0.bias" in state["params"]["backbone"]
    with open(tmp_path / "finetuning_runs" / "runs" / "dev"
              / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    vals = [r["val_loss_mean_dice"] for r in recs
            if "val_loss_mean_dice" in r]
    assert len(losses) == 4 and len(vals) == 2
    assert all(np.isfinite(losses)) and all(np.isfinite(vals))
