"""The port's pretraining trainer as a whole against the JAX package's, on
the CPU: both `train` loops on one H5 file, warm-started from one run dir
the JAX package wrote from its own init, at a configuration where neither
framework's random draws matter:

* no augmentation, the crop the volume's size (8^3), one subject with two
  timepoints taken in order (`view_order`), so every batch is the same
  pair of views;
* `num_patches` (512) at least every tap's voxel count, so the patch
  sampler takes every voxel of every tap, in an order that changes neither
  the loss nor its gradients.

Then the port warm-starts from the run dir the JAX trainer wrote after its
steps (the JAX package's nested `latest_net_G.npz` layout) and its first
loss is held against JAX's `nce_forward` on those parameters.

The JAX package cannot read back the list of projector weights its own
`save_pytree` writes for F (`_unflatten` looks the list items up as
groups); the JAX trainer here reads its warm start through the port's
reader, which reads both layouts, in place of its own.
"""

import dataclasses
import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anatomix_tpu.models.unet import UnetConfig as JUnetConfig
from anatomix_tpu.models.unet import build_plan as jbuild_plan
from anatomix_tpu.pretraining import train as jtrain
from anatomix_tpu.pretraining.config import PretrainConfig as JConfig
from anatomix_tpu.pretraining.train_step import NCEOptions as JNCE
from anatomix_tpu.pretraining.train_step import nce_forward as jnce_forward
from anatomix_tpu.utils import checkpoint as jckpt
from anatomix_tpu_torch.pretraining import train as ptrain
from anatomix_tpu_torch.pretraining.config import PretrainConfig
from anatomix_tpu_torch.pretraining.dataset import normalize_img
from anatomix_tpu_torch.utils.checkpoint import load_pytree

S = 8
TAPS = (17, 20, 24, 31, 37)  # 2^3 bottleneck, 4^3 and 8^3 decoder, exit
STEPS = 3
# the loss of steps 2 and 3, port against JAX, relative. AdamW's first
# update moves every weight by about lr whatever its gradient's size, so a
# gradient within rounding of zero takes either sign's step and free-running
# steps may drift apart; measured 1.8e-7 (step 2) and 8.9e-8 (step 3) on
# the CPU, step 1 8.6e-8
TOL_LATER_STEPS = 1e-5


def _cfg_kw(tmp):
    return dict(
        name="run", ckpt_dir=str(tmp / "ckpt"), dataroot=str(tmp),
        input_nc=1, output_nc=4, ngf=4, num_downs=2, nce_layers=TAPS,
        netF_nc=16, n_mlps=2, num_patches=S ** 3, crop_size=S,
        batch_size=1, augment=False, view_order=True, n_epochs=STEPS + 1,
        n_epochs_decay=0, print_freq=1, display_freq=0,
        save_latest_freq=100, evaluation_freq=100, max_iters=STEPS,
        data_parallel_devices=1, pretrained_name="init",
    )


def _losses(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["loss/loss"] for r in recs if "loss/loss" in r]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    tmp = tmp_path_factory.mktemp("loop")
    rng = np.random.default_rng(3)
    with h5py.File(tmp / "train_data.hdf5", "w") as f:
        g = f.create_group("000000")
        g.create_dataset("img", data=rng.random((2, S, S, S), np.float32))
        g.create_dataset("seg", data=rng.integers(0, 4, (S, S, S)).astype(
            np.uint8))
    kw = _cfg_kw(tmp)
    # the shared warm start: JAX's own init, saved by JAX's save_pytree
    init_dir = tmp / "ckpt" / "init"
    os.makedirs(init_dir)
    _, _, jstate0, _ = jtrain.build_all(JConfig(**kw), 1)
    jckpt.save_pytree(str(init_dir / "latest_net_G.npz"), jstate0.params_g)
    jckpt.save_pytree(str(init_dir / "latest_net_F.npz"), jstate0.params_f)

    monkeypatch_module.setattr(jckpt, "load_pytree", load_pytree)
    jtrain.train(JConfig(**{**kw, "name": "jax"}))
    pstate = ptrain.train(PretrainConfig(**{**kw, "name": "port"}),
                          device="cpu")
    return tmp, kw, pstate


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_loop_losses_match_jax(runs):
    tmp, _, pstate = runs
    ref = _losses(tmp / "ckpt" / "jax")
    got = _losses(tmp / "ckpt" / "port")
    assert len(ref) == len(got) == STEPS and pstate.step == STEPS
    rel = [abs(g - r) / abs(r) for g, r in zip(got, ref)]
    assert rel[0] <= 1e-4, (got, ref)
    assert max(rel[1:]) <= TOL_LATER_STEPS, (got, ref, rel)
    # the losses moved: the warm start and the steps took effect
    assert len(set(ref)) == STEPS


def test_warm_start_from_a_jax_run(runs, tmp_path):
    """The port's trainer warm-starts from the run dir JAX's trainer wrote
    (G in the JAX package's nested layout, F as its lists); its first loss
    is JAX's `nce_forward` on those parameters and the loop's batch."""
    tmp, kw, _ = runs
    cfg = PretrainConfig(**{**kw, "name": "port_from_jax",
                            "pretrained_name": "jax", "max_iters": 1})
    ptrain.train(cfg, device="cpu")
    got = _losses(tmp / "ckpt" / "port_from_jax")[0]

    jdir = tmp / "ckpt" / "jax"
    params_g = load_pytree(str(jdir / "latest_net_G.npz"))
    params_f = load_pytree(str(jdir / "latest_net_F.npz"))
    assert isinstance(params_g["0"], dict)  # the JAX package's layout
    with h5py.File(tmp / "train_data.hdf5", "r") as f:
        img = np.asarray(f["000000"]["img"])
        seg = np.asarray(f["000000"]["seg"])
    # the loop's batch: timepoints 0 then 1, normalized, sent as f16
    views = np.stack([normalize_img(img[t], cfg.percentile,
                                    cfg.zero_centered).astype(np.float16)
                      .astype(np.float32) for t in (0, 1)])[None, ..., None]
    jcfg = JConfig(**kw)
    plan = jbuild_plan(JUnetConfig(dimension=3, input_nc=1, output_nc=4,
                                   num_downs=2, ngf=4))
    loss_fn = jax.jit(lambda g, f, v, sg: jnce_forward(
        plan, g, f, v, sg, jax.random.PRNGKey(0), tap_layers=TAPS,
        num_patches=S ** 3, nce=JNCE(temperature=jcfg.nce_T), train=True)[0])
    ref = loss_fn(jax.tree_util.tree_map(jnp.asarray, params_g),
                  jax.tree_util.tree_map(jnp.asarray, params_f),
                  jnp.asarray(views),
                  jnp.asarray(seg, jnp.int32)[None, ..., None])
    assert abs(got - float(ref)) <= 1e-4 * abs(float(ref)), (got, ref)


def test_configs_agree(runs):
    """The two runs were given one configuration (the port's copy of the
    dataclass has the JAX package's fields and defaults)."""
    tmp, _, _ = runs
    with open(tmp / "ckpt" / "jax" / "train_opt.json") as f:
        ref = json.load(f)
    with open(tmp / "ckpt" / "port" / "train_opt.json") as f:
        got = json.load(f)
    assert {k: v for k, v in got.items() if k != "name"} == {
        k: v for k, v in ref.items() if k != "name"}
    assert [f.name for f in dataclasses.fields(PretrainConfig)] == [
        f.name for f in dataclasses.fields(JConfig)]
