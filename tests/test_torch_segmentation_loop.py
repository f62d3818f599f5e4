"""The port's few-shot segmentation input, validation and loop on the CPU
against the JAX package, on the same seeded numpy inputs and the same
weights: the transforms fed the parameters JAX drew, data handling and the
epoch order, sliding-window validation, the predictor's pack, the overfit
run and the CLI (`test_torch_segmentation.py` holds the model and the
step). A tiny UNet (num_downs 2, ngf 4, output_nc 4), 4 foreground classes
(5 logits), crop 16, volumes 24^3; JAX runs its XLA path. Each test states
its tolerance.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.models import unet as jax_unet
from anatomix_tpu.ops import augment as ja
from anatomix_tpu.ops.sliding_window import (
    sliding_window_inference as jax_sliding_window_inference,
)
from anatomix_tpu.segmentation import data as jd
from anatomix_tpu.segmentation import model as jm
from anatomix_tpu.segmentation import train as jtr
from anatomix_tpu.segmentation import transforms as jt
from anatomix_tpu.utils.nifti import save_volume
from anatomix_tpu_torch.models.unet import init_params
from anatomix_tpu_torch.ops.sliding_window import sliding_window_inference
from anatomix_tpu_torch.segmentation import data as pd
from anatomix_tpu_torch.segmentation import model as pm
from anatomix_tpu_torch.segmentation import train as ptr
from anatomix_tpu_torch.segmentation import transforms as pt
from anatomix_tpu_torch.utils.checkpoint import load_pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _port_model():
    """The port's tiny model and the same weights in the JAX layout."""
    plan, params = pm.load_seg_model(N_CLASSES, ckpt_path="scratch",
                                     device="cpu", **TINY)
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
    return img, lab.astype(np.int64)


# -----------------------------------------------------------------------------
# transforms

def _jax_draws(key, crop, shape):
    """The parameters JAX's `train_transform` draws from `key`, in the
    port's layout (its key splits replayed)."""
    keys = jax.random.split(key, 9)
    kz, ky, kx = jax.random.split(keys[0], 3)
    params = {"crop": [int(jax.random.randint(k, (), 0, max(n - crop, 0) + 1))
                       for k, n in zip((kz, ky, kx), shape)],
              "size": crop}

    def coin(k):
        kp, kf = jax.random.split(k)
        return float(jax.random.uniform(kp)) < 0.33, kf

    on, kf = coin(keys[1])
    k1, k2 = jax.random.split(kf)
    params["noise"] = {
        "std": float(jax.random.uniform(k1, (), minval=0.0, maxval=0.1)),
        "field": torch.from_numpy(np.array(
            jax.random.normal(k2, (crop,) * 3, jnp.float32))),
    } if on else None
    on, kf = coin(keys[2])
    params["bias"] = np.array(jax.random.uniform(
        kf, (20,), minval=0.0, maxval=0.05)) if on else None
    on, kf = coin(keys[3])
    params["gibbs"] = float(jax.random.uniform(
        kf, (), minval=0.0, maxval=0.33)) if on else None
    on, kf = coin(keys[4])
    params["contrast"] = float(jax.random.uniform(
        kf, (), minval=0.5, maxval=4.5)) if on else None
    on, kf = coin(keys[5])
    params["smooth"] = [float(s) for s in jax.random.uniform(
        kf, (3,), minval=0.0, maxval=0.1)] if on else None
    on, kf = coin(keys[6])
    if on:
        k1, k2, k3 = jax.random.split(kf, 3)
        params["sharpen"] = tuple(
            float(jax.random.uniform(k, (), minval=lo, maxval=hi))
            for k, (lo, hi) in ((k1, (0.5, 1.0)), (k2, (0.5, 1.0)),
                                (k3, (10.0, 30.0))))
    else:
        params["sharpen"] = None
    params["affine"] = (np.array(ja.rand_affine_params(
        keys[8], rotate_range=math.pi / 4, scale_range=0.2,
        shear_range=0.2)) if float(jax.random.uniform(keys[7])) < 0.98
        else None)
    return params


def _covering_keys(n_max=400):
    """Seeds whose draws switch every branch on at least once and off at
    least once (the affine, p = 0.98, off at least once too)."""
    names = ("noise", "bias", "gibbs", "contrast", "smooth", "sharpen",
             "affine")
    seen = {n: set() for n in names}
    chosen = []
    for seed in range(n_max):
        keys = jax.random.split(jax.random.PRNGKey(seed), 9)
        flags = [float(jax.random.uniform(jax.random.split(keys[i])[0]))
                 < 0.33 for i in range(1, 7)]
        flags.append(float(jax.random.uniform(keys[7])) < 0.98)
        if any(f not in seen[n] for n, f in zip(names, flags)):
            chosen.append(seed)
            for n, f in zip(names, flags):
                seen[n].add(f)
        if all(len(s) == 2 for s in seen.values()):
            return chosen
    raise AssertionError(f"no covering seeds in {n_max}: {seen}")


def test_train_transform_matches_jax():
    """The port's apply fed the parameters JAX's `train_transform` drew:
    the image within 1e-5 and the label equal, for keys that switch every
    branch on and off."""
    rng = np.random.default_rng(4)
    shape = (24, 22, 20)
    img = (rng.standard_normal(shape) * 50 + 100).astype(np.float32)
    lab = rng.integers(0, 5, shape).astype(np.float32)
    seeds = _covering_keys()
    for seed in seeds:
        key = jax.random.PRNGKey(seed)
        jimg, jlab = jt.train_transform(key, jnp.asarray(img),
                                        jnp.asarray(lab), CROP)
        params = _jax_draws(key, CROP, shape)
        got_img, got_lab = pt.apply_train_transform(_t(img), _t(lab), params)
        assert got_img.shape == got_lab.shape == (CROP,) * 3
        assert np.abs(got_img.numpy() - np.asarray(jimg)).max() <= 1e-5, seed
        np.testing.assert_array_equal(got_lab.numpy(), np.asarray(jlab))
    # the port's own draw covers the same layout
    gen = torch.Generator().manual_seed(0)
    im, lb = pt.train_transform(gen, _t(img), _t(lab), CROP)
    assert im.shape == lb.shape == (CROP,) * 3
    assert 0.0 <= im.min() and im.max() <= 1.0 + 1e-6
    assert torch.equal(lb, lb.round())


def test_val_transform_matches_jax():
    img = (np.random.default_rng(5).standard_normal((9, 8, 7)) * 30
           ).astype(np.float32)
    assert _rel(pt.val_transform(_t(img)),
                jt.val_transform(jnp.asarray(img))) <= 1e-7


# -----------------------------------------------------------------------------
# data

def _dataset(root, n_train=5, size=24, seed=0):
    """imagesTr/labelsTr/imagesVal/labelsVal of blocks with labels 0..4."""
    rng = np.random.default_rng(seed)
    for sub in ("imagesTr", "labelsTr", "imagesVal", "labelsVal"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def pair(img_dir, lab_dir, name):
        lab = np.zeros((size,) * 3, np.float32)
        for c in range(1, N_CLASSES + 1):
            o = rng.integers(0, size - 8, 3)
            lab[o[0]:o[0] + 8, o[1]:o[1] + 8, o[2]:o[2] + 8] = c
        img = (lab * 40 + rng.standard_normal(lab.shape) * 10).astype(
            np.float32)
        save_volume(os.path.join(root, img_dir, name), img)
        save_volume(os.path.join(root, lab_dir, name), lab)

    for i in range(n_train):
        pair("imagesTr", "labelsTr", f"case{i * 7 % 11}.nii.gz")
    pair("imagesVal", "labelsVal", "val0.nii.gz")
    return root


def test_data_handler_and_cache_match_jax(tmp_path):
    assert pd.natsorted(["x10", "x2", "X1", "x1b"]) == jd.natsorted(
        ["x10", "x2", "X1", "x1b"])
    root = _dataset(str(tmp_path))
    for amount, iters, bs in ((3, 5, 2), (2, 75, 3), (5, 1, 1)):
        assert pd.data_handler(root, amount, iters, bs) == jd.data_handler(
            root, amount, iters, bs)
    cache, jcache = pd.VolumeCache(), jd.VolumeCache()
    path = pd.data_handler(root)[0][0]
    got = cache.get(path)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jcache.get(path))
    assert cache.get(path) is got


def test_epoch_order_matches_jax(tmp_path, monkeypatch):
    """The files each step of two epochs reads, in order, equal JAX's main
    loop's (`data_handler` and the `default_rng(0)` permutations)."""
    root = _dataset(str(tmp_path / "data"))
    monkeypatch.chdir(tmp_path)
    plan, _ = pm.load_seg_model(N_CLASSES, ckpt_path="scratch",
                                device="cpu", **TINY)
    pth = str(tmp_path / "tiny.pth")
    torch.save(init_params(plan, torch.Generator().manual_seed(0)), pth)
    argv = ["--exp_name", "order", "--dataset", root, "--n_classes", "4",
            "--pretrained_ckpt", pth, "--crop_size", "16",
            "--batch_size", "2", "--n_epochs", "2", "--n_iters_per_epoch",
            "3", "--val_interval", "10", "--num_downs", "2", "--ngf", "4",
            "--output_nc", "4"]
    seen_j, seen_p = [], []

    def jax_transform(key, img, lab, crop):
        seen_j.append(float(jnp.sum(img)))
        return jnp.zeros((crop,) * 3), jnp.zeros((crop,) * 3)

    # the scalars are not what this test reads: no TensorBoard writer
    class NoLogger:
        def __init__(self, *args, **kwargs):
            pass

        def log(self, step, scalars):
            pass

        def close(self):
            pass

    monkeypatch.setattr(jtr, "ScalarLogger", NoLogger)
    monkeypatch.setattr(ptr, "ScalarLogger", NoLogger)
    monkeypatch.setattr(jtr, "train_transform", jax_transform)
    monkeypatch.setattr(jtr, "build_seg_train_step",
                        lambda plan, tx, **kw: lambda p, o, i, l: (
                            p, o, jnp.float32(0.0)))
    jtr.main(jtr.build_parser().parse_args(argv))

    def port_batch(cache, images, labels, idxs, crop, gen, field_gen=None):
        seen_p.extend(float(cache.get(images[i]).sum()) for i in idxs)
        return torch.zeros((len(idxs), crop, crop, crop, 1)), torch.zeros(
            (len(idxs), crop, crop, crop), dtype=torch.long)

    monkeypatch.setattr(ptr, "load_batch", port_batch)
    ptr.main(ptr.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert len(seen_p) == 2 * 3 * 2
    assert seen_p == pytest.approx(seen_j, rel=1e-6)


# -----------------------------------------------------------------------------
# validation

def test_validate_and_sliding_window_match_jax(tmp_path):
    """`validate` on a 24^3 volume (crop 16, overlap 0.7, sw_batch 4,
    constant blend) within 1e-6; the sliding-window logits within 1e-5
    relative (the eager and the fused eval forward alike)."""
    root = _dataset(str(tmp_path), n_train=1)
    img_path = os.path.join(root, "imagesVal", "val0.nii.gz")
    lab_path = os.path.join(root, "labelsVal", "val0.nii.gz")
    plan, params, jplan, jparams = _port_model()
    ref = jtr.validate(jplan, jparams, [img_path], [lab_path],
                       jd.VolumeCache(), CROP, N_CLASSES)
    cache = pd.VolumeCache()
    got = ptr.validate(plan, params, [img_path], [lab_path], cache, CROP,
                       N_CLASSES)
    assert abs(got - ref) <= 1e-6
    img = pt.val_transform(cache.get(img_path))[None, ..., None]
    jref = jax_sliding_window_inference(
        jnp.asarray(img.numpy()),
        lambda w: jm.seg_forward(jplan, jparams, w, conv_impl="xla"),
        N_CLASSES + 1, roi_size=(CROP,) * 3, sw_batch_size=4, overlap=0.7,
        mode="constant")
    for plain in (True, False):
        logits = sliding_window_inference(
            img, pm.make_seg_predictor(plan, params, plain=plain),
            N_CLASSES + 1, roi_size=(CROP,) * 3, sw_batch_size=4,
            overlap=0.7, mode="constant")
        assert logits.shape == jref.shape == (1, 24, 24, 24, 5)
        assert _rel(logits, jref) <= 1e-5


def test_predictor_follows_the_parameters():
    """A predictor packs the parameters it was made from: after a step a
    new one reads the new weights and running stats (the old one does
    not), equal to the eager module's on the new parameters."""
    plan, params = pm.load_seg_model(N_CLASSES, ckpt_path="scratch",
                                     device="cpu", **TINY)
    x, lab = _batch()
    before = pm.make_seg_predictor(plan, params, plain=False)
    out0 = before(_t(x))
    step = ptr.build_seg_train_step(plan, ptr.make_seg_optimizer(params,
                                                                  1e-2))
    step(params, _t(x), torch.from_numpy(lab))
    torch.testing.assert_close(before(_t(x)), out0, rtol=0, atol=0)
    after = pm.make_seg_predictor(plan, params, plain=False)(_t(x))
    assert _rel(after - out0, out0) > 1e-3
    assert _rel(after, pm.make_seg_predictor(plan, params,
                                              plain=True)(_t(x))) <= 1e-5


# -----------------------------------------------------------------------------
# the loop

def test_overfit_tiny():
    """The port's counterpart of `test_seg_overfit_tiny`: a tiny scratch
    model on one volume, Adam at 1e-3, 15 steps: the loss falls below 0.7x
    its first value."""
    plan, params = pm.load_seg_model(2, ckpt_path="scratch", device="cpu",
                                     **TINY)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 16, 16, 16, 1)).astype(np.float32)
    lab = np.zeros((1, 16, 16, 16), np.int64)
    lab[0, :8] = 1
    lab[0, 8:, :8] = 2
    img = _t(img + lab[..., None] * 2.0)
    lab = torch.from_numpy(lab)
    step = ptr.build_seg_train_step(plan, ptr.make_seg_optimizer(params,
                                                                  1e-3))
    losses = [float(step(params, img, lab)) for _ in range(15)]
    assert losses[-1] < losses[0] * 0.7, losses


def test_cli_runs_on_the_cpu(tmp_path):
    """`python -m anatomix_tpu_torch.segmentation.train --device cpu` for 2
    epochs with `--val_interval 1`: the best and per-epoch checkpoints,
    the scalars, a finite loss."""
    root = _dataset(str(tmp_path / "data"), n_train=3)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "anatomix_tpu_torch.segmentation.train",
         "--exp_name", "tiny", "--dataset", root, "--n_classes", "4",
         "--pretrained_ckpt", "scratch", "--crop_size", "16",
         "--batch_size", "2", "--n_epochs", "2", "--n_iters_per_epoch", "2",
         "--train_amount", "2", "--val_interval", "1", "--num_downs", "2", "--ngf", "4",
         "--output_nc", "4", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ckpt = tmp_path / "finetuning_runs" / "checkpoints" / "tiny"
    names = sorted(os.listdir(ckpt))
    assert "best_dict_epoch0001.npz" in names
    assert {"epoch0001.npz", "epoch0002.npz"} <= set(names)
    state = load_pytree(str(ckpt / "epoch0002.npz"))
    assert int(state["epoch"]) == 2 and int(state["opt_state"]["count"]) == 4
    assert state["params"]["head"]["weight"].shape == (5, 4, 1, 1, 1)
    with open(tmp_path / "finetuning_runs" / "runs" / "tiny"
              / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    vals = [r["val_loss_mean_dice"] for r in recs
            if "val_loss_mean_dice" in r]
    assert len(losses) == 4 and len(vals) == 2
    assert all(np.isfinite(losses)) and all(np.isfinite(vals))
