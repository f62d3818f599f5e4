"""The port's pretraining loop on the CPU: the two-view dataset and the
paired augmentation against the JAX package's (the augment through the
parameters JAX drew, replayed from its key splits), the JAX trainer tests'
assertions on the port's trainer (run and resume, the plateau policy, the
visual dumps), the CLI, its parser against JAX's, and warm start."""

import dataclasses
import json
import os
import runpy
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.ops import augment as ja
from anatomix_tpu.pretraining import dataset as jds
from anatomix_tpu.pretraining import train as jtrain
from anatomix_tpu.pretraining.config import PretrainConfig as JConfig
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan, init_params
from anatomix_tpu_torch.pretraining import dataset as pds
from anatomix_tpu_torch.pretraining import train as ptrain
from anatomix_tpu_torch.pretraining.config import PretrainConfig
from anatomix_tpu_torch.pretraining.warmstart import (
    EarlyStopping,
    head_layer_keys,
    load_partial,
    params_g_from_checkpoint,
    resolve_warm_start,
)
from anatomix_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_pytree,
    save_json,
)


def _make_h5(path, n_subjects=3, size=16, n_tps=2, seed=0):
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        for i in range(n_subjects):
            g = f.create_group(f"{i:06d}")
            g.create_dataset("img", data=rng.random((n_tps, size, size, size),
                                                    np.float32))
            g.create_dataset("seg", data=rng.integers(
                0, 3, (size, size, size)).astype(np.uint8))


def _tiny_kw(tmp_path, **kw):
    base = dict(
        name="t", ckpt_dir=str(tmp_path / "ckpt"), dataroot=str(tmp_path),
        ndims=3, input_nc=1, output_nc=4, ngf=4, num_downs=2,
        nce_layers=(11, 33), netF_nc=16, n_mlps=2, num_patches=16,
        crop_size=16, batch_size=1, n_epochs=1, n_epochs_decay=0,
        print_freq=2, save_latest_freq=2, evaluation_freq=2,
        n_val_during_train=1, max_iters=3, data_parallel_devices=1,
    )
    base.update(kw)
    return base


def _tiny_cfg(tmp_path, **kw):
    return PretrainConfig(**_tiny_kw(tmp_path, **kw))


# -----------------------------------------------------------------------------
# dataset

def test_normalize_img_matches_jax():
    arr = np.random.default_rng(0).gamma(2.0, 30.0, 4000).astype(np.float32)
    for pct in (None, 99.0, 99.99):
        for zc in (True, False):
            np.testing.assert_array_equal(
                pds.normalize_img(arr, pct, zc),
                jds.normalize_img(arr, pct, zc))
    flat = np.full(10, 3.0, np.float32)  # no range: only the centering
    np.testing.assert_array_equal(pds.normalize_img(flat),
                                  jds.normalize_img(flat))


@pytest.mark.parametrize("view_order", [False, True])
def test_dataset_matches_jax(tmp_path, view_order):
    """One H5 file and one numpy seed pick the same subjects, timepoints
    and arrays, bit for bit; a mapping of the same arrays reads the same;
    `__len__` pads up to the batch size."""
    path = str(tmp_path / "d.hdf5")
    _make_h5(path, n_subjects=2, size=6, n_tps=4)
    kw = dict(view_order=view_order, batch_size=3)
    jd = jds.H5TwoViewDataset(path, JConfig(**kw))
    pd_ = pds.H5TwoViewDataset(path, PretrainConfig(**kw))
    with h5py.File(path, "r") as f:
        mapping = {s: {"img": np.asarray(f[s]["img"]),
                       "seg": np.asarray(f[s]["seg"])} for s in f}
    md = pds.H5TwoViewDataset(mapping, PretrainConfig(**kw))
    assert len(pd_) == len(jd) == len(md) == 3
    assert pd_.subjects == jd.subjects == md.subjects
    rj, rp, rm = (np.random.default_rng(5) for _ in range(3))
    for item in range(7):
        ref = jd.get(item, rj)
        for got in (pd_.get(item, rp), md.get(item, rm)):
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype == np.float32
                np.testing.assert_array_equal(g, r)
        assert not np.array_equal(ref[0], ref[1])  # distinct timepoints
    for d in (jd, pd_, md):
        d.close()


# -----------------------------------------------------------------------------
# paired augmentation

def _replay_chain(key, cfg, shape):
    """The parameters JAX's `_intensity_chain` draws from `key`, in the
    port's layout."""
    keys = jax.random.split(key, 5)
    out = {}
    for k, (name, p) in zip(keys, pds.INTENSITY_CHAIN):
        kp, kf = jax.random.split(k)
        out[name] = None
        if not getattr(cfg, name) or not float(jax.random.uniform(kp)) < p:
            continue
        if name == "blur":
            out[name] = np.asarray(jax.random.uniform(
                kf, (3,), minval=0.0, maxval=2.0)).tolist()
        elif name == "noise":
            k1, k2 = jax.random.split(kf)
            out[name] = {
                "std": float(jax.random.uniform(k1, (), minval=0.0,
                                                maxval=0.25)),
                "field": torch.from_numpy(np.array(
                    jax.random.normal(k2, shape, jnp.float32)))}
        elif name == "bias":
            out[name] = np.asarray(jax.random.uniform(
                kf, (20,), minval=-0.5, maxval=0.5))
        elif name == "gamma":
            out[name] = float(jnp.exp(jax.random.uniform(
                kf, (), minval=-0.4, maxval=0.4)))
        else:
            k1, k2, k3 = jax.random.split(kf, 3)
            out[name] = (int(jax.random.randint(k1, (), 0, 3)),
                         int(jax.random.randint(k2, (), 2, 11)),
                         float(jax.random.uniform(k3, (), minval=0.1,
                                                  maxval=0.5)))
    return out


def _replay_pair(key, cfg, shape):
    """The parameters JAX's `make_pair_augment(cfg)` draws from `key`."""
    kflip, kaff_p, kaff, kint_a, kint_b, kcrop = jax.random.split(key, 6)
    params = {"flip": None, "affine": None, "inten": None, "crop": None}
    if cfg.augment and cfg.geo_augment:
        kp, kf = jax.random.split(kflip)
        if float(jax.random.uniform(kp)) < 0.9:
            params["flip"] = np.asarray(
                jax.random.bernoulli(kf, 0.5, (3,))).tolist()
        if float(jax.random.uniform(kaff_p)) < 0.5:
            kr, ks = jax.random.split(kaff)
            deg = jnp.deg2rad(45.0)
            rot = jax.random.uniform(kr, (3,), minval=-deg, maxval=deg)
            scale = 1.0 + jax.random.uniform(ks, (3,), minval=-0.4,
                                             maxval=0.4)
            params["affine"] = np.asarray(
                ja.affine_matrix_3d(rotate=rot, scale=scale))
    if cfg.augment and cfg.inten_augment:
        a = _replay_chain(kint_a, cfg, shape)
        b = a if cfg.apply_same_inten_augment else _replay_chain(
            kint_b, cfg, shape)
        params["inten"] = [a, b]
    if cfg.crop_size > 0:
        params["crop"] = [
            int(jax.random.randint(k, (), 0, max(n - cfg.crop_size, 0) + 1))
            for k, n in zip(jax.random.split(kcrop, 3), shape)]
    return params


def test_pair_augment_matches_jax(tmp_path):
    """The port's `apply_pair_augment` with the parameters replayed from
    JAX's key against JAX's `make_pair_augment(cfg)(key, a, b, seg)`: the
    views within 1e-5, the seg exact; over the keys every transform of the
    chain and both spatial ones run at least once."""
    kw = _tiny_kw(tmp_path, crop_size=12)
    jaug = jds.make_pair_augment(JConfig(**kw))
    cfg = PretrainConfig(**kw)
    rng = np.random.default_rng(1)
    shape = (14, 15, 16)
    a = rng.random(shape).astype(np.float32) * 2 - 1
    b = rng.random(shape).astype(np.float32) * 2 - 1
    seg = rng.integers(0, 4, shape).astype(np.float32)
    seen = set()
    for s in range(10):
        key = jax.random.PRNGKey(s)
        rv, rs = jaug(key, jnp.asarray(a), jnp.asarray(b), jnp.asarray(seg))
        params = _replay_pair(key, cfg, shape)
        gv, gs = pds.apply_pair_augment(
            params, torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(seg), crop_size=cfg.crop_size)
        assert gv.shape == rv.shape == (2, 12, 12, 12, 1)
        assert gs.shape == rs.shape == (12, 12, 12, 1)
        rel = (np.abs(gv.numpy() - np.asarray(rv)).max()
               / np.abs(np.asarray(rv)).max())
        assert rel <= 1e-5, (s, rel)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
        seen |= {k for k in ("flip", "affine") if params[k] is not None}
        seen |= {n for chain in params["inten"] for n, v in chain.items()
                 if v is not None}
    assert seen == {"flip", "affine", "blur", "noise", "bias", "gamma",
                    "motion"}


def test_pair_augment_shared_spatial(tmp_path):
    """Spatial transforms are shared across views: two identical views stay
    identical when the per-view intensity augments are off
    (`tests/test_pretraining_loop.py:74-89`)."""
    aug = pds.make_pair_augment(_tiny_cfg(tmp_path, inten_augment=False))
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.standard_normal((16, 16, 16)).astype(
        np.float32))
    seg = torch.from_numpy(rng.integers(0, 3, (16, 16, 16)).astype(
        np.float32))
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        views, seg_out = aug(gen, img, img, seg)
        assert views.shape == (2, 16, 16, 16, 1)
        assert seg_out.shape == (16, 16, 16, 1)
        torch.testing.assert_close(views[0], views[1], rtol=0, atol=1e-5)


def test_pair_augment_same_intensity_flag(tmp_path):
    """`apply_same_inten_augment`: one intensity draw for both views
    (`tests/test_pretraining_loop.py:92-101`); without it the views
    differ."""
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.standard_normal((16, 16, 16)).astype(
        np.float32))
    seg = torch.zeros((16, 16, 16))
    same = pds.make_pair_augment(_tiny_cfg(tmp_path,
                                           apply_same_inten_augment=True))
    views, _ = same(torch.Generator().manual_seed(0), img, img, seg)
    torch.testing.assert_close(views[0], views[1], rtol=0, atol=1e-4)
    own = pds.make_pair_augment(_tiny_cfg(tmp_path))
    gen = torch.Generator().manual_seed(0)
    differ = [not torch.allclose(v[0], v[1], atol=1e-4) for v, _ in
              (own(gen, img, img, seg) for _ in range(3))]
    assert any(differ)


# -----------------------------------------------------------------------------
# the trainer (the JAX trainer tests' assertions,
# `tests/test_pretraining_loop.py:153-212`)

def test_trainer_runs_and_resumes(tmp_path):
    _make_h5(str(tmp_path / "train_data.hdf5"))
    _make_h5(str(tmp_path / "val_data.hdf5"), n_subjects=1)
    cfg = _tiny_cfg(tmp_path)
    state = ptrain.train(cfg, device="cpu")
    assert state.step == 3
    run_dir = os.path.join(cfg.ckpt_dir, cfg.name)
    for name in ("latest_train_state.npz", "latest_net_G.npz",
                 "latest_net_F.npz", "train_opt.json", "2_net_G.npz",
                 "best_val_net_G.npz", "scalars.jsonl"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "loss/loss" in r] == [2]
    assert [r["step"] for r in recs if "loss/val" in r] == [2]
    assert all(np.isfinite(v) for r in recs for v in r.values())

    # resume: continue to 5 iters, from the saved state and step
    state2 = ptrain.train(_tiny_cfg(tmp_path, continue_train=True,
                                    max_iters=5), device="cpu")
    assert state2.step == 5
    assert state2.opt_state_g["count"] == 5

    # warm start from the port's own run: G and F as the run left them
    plan = build_plan(UnetConfig(input_nc=1, output_nc=4, num_downs=2,
                                 ngf=4))
    fresh = {k: v for k, v in init_params(
        plan, torch.Generator().manual_seed(9)).items()
        if v.is_floating_point()}
    loaded = params_g_from_checkpoint(
        plan, load_pytree(os.path.join(run_dir, "latest_net_G.npz")))
    merged = load_partial(plan, fresh, loaded)
    for k, v in state2.params_g.items():
        torch.testing.assert_close(merged[k], v, rtol=0, atol=0)


def test_trainer_plateau_policy(tmp_path, monkeypatch):
    """lr_policy=plateau: a stagnant val loss halves the LR after `patience`
    bad evals (ReduceLROnPlateau), and the state is saved for a resume."""
    _make_h5(str(tmp_path / "train_data.hdf5"))
    _make_h5(str(tmp_path / "val_data.hdf5"), n_subjects=1)
    monkeypatch.setattr(ptrain, "compute_val_loss", lambda *a, **k: 1.0)
    cfg = _tiny_cfg(tmp_path, lr_policy="plateau", evaluation_freq=1,
                    max_iters=8, n_epochs=4, save_latest_freq=100,
                    print_freq=100)
    state = ptrain.train(cfg, device="cpu")
    # evals 2..8 are all bad; patience 5 -> drop at the 7th eval
    assert state.lr_scale == 0.5
    with open(os.path.join(cfg.ckpt_dir, cfg.name,
                           "plateau_state.json")) as f:
        assert json.load(f)["lr"] == cfg.lr * 0.5
    with pytest.raises(ValueError, match="plateau"):
        ptrain.train(_tiny_cfg(tmp_path, lr_policy="plateau"),
                     val_h5=str(tmp_path / "missing.hdf5"), device="cpu")


def test_trainer_visual_dumps(tmp_path):
    """The save_latest cadence dumps the live views and seg under visuals/
    (reference `trainers/train.py:302-309`); the data may be a mapping."""
    from anatomix_tpu_torch.utils.nifti import read_nifti

    _make_h5(str(tmp_path / "d.hdf5"))
    with h5py.File(tmp_path / "d.hdf5", "r") as f:
        mapping = {s: {"img": np.asarray(f[s]["img"]),
                       "seg": np.asarray(f[s]["seg"])} for s in f}
    cfg = _tiny_cfg(tmp_path, save_latest_freq=2, display_freq=2)
    ptrain.train(cfg, mapping, device="cpu")
    vis = os.path.join(cfg.ckpt_dir, cfg.name, "visuals")
    for name in ("latest_view1.nii.gz", "latest_view2.nii.gz",
                 "latest_seg.nii.gz"):
        assert os.path.exists(os.path.join(vis, name)), name
    vol, _ = read_nifti(os.path.join(vis, "latest_view1.nii.gz"))
    assert vol.shape == (16, 16, 16)


def test_trainer_cli(tmp_path, monkeypatch):
    """`python -m anatomix_tpu_torch.pretraining.train --device cpu ...`
    writes the run dir."""
    _make_h5(str(tmp_path / "train_data.hdf5"))
    argv = ["train", "--device", "cpu", "--dataroot", str(tmp_path),
            "--ckpt_dir", str(tmp_path / "ckpt"), "--name", "cli",
            "--ngf", "4", "--num_downs", "2", "--crop_size", "16",
            "--nce_layers", "11,33", "--netF_nc", "16", "--n_mlps", "2",
            "--num_patches", "16", "--max_iters", "3", "--print_freq", "1"]
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_path(ptrain.__file__, run_name="__main__")
    run_dir = tmp_path / "ckpt" / "cli"
    for name in ("train_opt.json", "scalars.jsonl", "latest_train_state.npz",
                 "latest_net_G.npz", "latest_net_F.npz"):
        assert (run_dir / name).exists(), name
    assert json.loads((run_dir / "train_opt.json").read_text())[
        "nce_layers"] == [11, 33]


def test_trainer_is_single_device(tmp_path, monkeypatch):
    """The two configs the single-device trainer once refused now train:
    `multihost=True` with no launcher's variables is a world of one (the
    single-device run), `data_parallel_devices=2` two gloo ranks on a
    global batch of 2 (`tests/test_torch_parallel_train.py` holds their
    losses to the single-device run's)."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    _make_h5(str(tmp_path / "train_data.hdf5"), n_subjects=4)
    for name, kw in (("mh", dict(multihost=True)),
                     ("dp", dict(data_parallel_devices=2, batch_size=2))):
        state = ptrain.train(_tiny_cfg(tmp_path, name=name, max_iters=2,
                                       **kw), device="cpu")
        assert state.step == 2
        run_dir = tmp_path / "ckpt" / name
        assert (run_dir / "latest_train_state.npz").exists()
        recs = [json.loads(line) for line in
                (run_dir / "scalars.jsonl").read_text().splitlines()]
        assert [r["step"] for r in recs if "loss/loss" in r] == [2]


def test_batch_pipeline_transfer(tmp_path):
    """The batch sent as f16 images and i16 labels (the JAX package's
    quantization), augmented and cropped; labels past int16 raise."""
    cfg = _tiny_cfg(tmp_path, augment=False, crop_size=8)
    img = np.random.default_rng(3).random((2, 8, 8, 8)).astype(np.float32)
    seg = np.arange(512, dtype=np.float32).reshape(8, 8, 8) % 7
    ds = pds.H5TwoViewDataset({"s": {"img": img, "seg": seg}}, cfg)
    pipe = ptrain.BatchPipeline(ds, cfg, np.random.default_rng(0),
                                torch.device("cpu"), (1, 2))
    views, segs = pipe([0])
    assert views.shape == (1, 2, 8, 8, 8, 1) and segs.dtype == torch.int64
    a, b, _ = ds.get(0, np.random.default_rng(0))
    np.testing.assert_array_equal(
        views[0, :, ..., 0].numpy(),
        np.stack([a, b]).astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(segs[0, ..., 0].numpy(), seg)
    big = pds.H5TwoViewDataset(
        {"s": {"img": img, "seg": np.full((8, 8, 8), 40000.0)}}, cfg)
    with pytest.raises(ValueError, match="int16"):
        ptrain.BatchPipeline(big, cfg, np.random.default_rng(0),
                             torch.device("cpu"), (1, 2))([0])


# -----------------------------------------------------------------------------
# CLI parsing

@pytest.mark.parametrize("argv", [
    [],
    ["--nce_layers", "11,33", "--nce_weights", "1,3", "--augment", "false",
     "--lr", "1e-3", "--netG", "primus", "--pretrained_name", "other"],
])
def test_parser_matches_jax(argv):
    """The same argv gives the JAX package's `PretrainConfig`, with
    `nce_layers` as ints and `nce_weights` normalized to sum 1; `--device`
    is the port's own."""
    ref = jtrain.config_from_args(jtrain.build_parser().parse_args(argv))
    args = ptrain.build_parser().parse_args(argv)
    assert args.device == "cuda"
    got = ptrain.config_from_args(args)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if argv:
        assert got.nce_layers == (11, 33)
        assert got.nce_weights == (0.25, 0.75)
    assert ptrain.build_parser().parse_args(
        argv + ["--device", "cpu"]).device == "cpu"


# -----------------------------------------------------------------------------
# warm start (`tests/test_warmstart_and_cli.py:19-84`, on the port)

def _sd(plan, seed):
    return {k: v for k, v in init_params(
        plan, torch.Generator().manual_seed(seed)).items()
        if v.is_floating_point()}


def test_load_partial_exact_and_head_reinit():
    plan = build_plan(UnetConfig(input_nc=1, output_nc=4, num_downs=2,
                                 ngf=4))
    cur, src = _sd(plan, 0), _sd(plan, 1)
    merged = load_partial(plan, cur, {k: v.numpy() for k, v in src.items()})
    torch.testing.assert_close(merged["model.0.weight"],
                               src["model.0.weight"], rtol=0, atol=0)

    # an output head of another width keeps its fresh init
    plan2 = build_plan(UnetConfig(input_nc=1, output_nc=7, num_downs=2,
                                  ngf=4))
    cur2 = _sd(plan2, 2)
    merged2 = load_partial(plan2, cur2, src)
    (head,) = head_layer_keys(plan2)
    torch.testing.assert_close(merged2[f"model.{head}.weight"],
                               cur2[f"model.{head}.weight"], rtol=0, atol=0)

    # a mismatch elsewhere raises
    bad = dict(src)
    bad["model.0.weight"] = torch.zeros((4, 2, 3, 3, 3))
    with pytest.raises(ValueError, match="Shape mismatch"):
        load_partial(plan, cur, bad)
    with pytest.raises(ValueError, match="missing"):
        load_partial(plan, cur, {k: v for k, v in src.items()
                                 if k != "model.0.weight"})


def test_resolve_warm_start_precedence(tmp_path):
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    assert resolve_warm_start(run_dir) == (None, None, None)
    g, f, r = resolve_warm_start(run_dir,
                                 pretrained_g_only_ckpt="/x/net_G.npz")
    assert g == "/x/net_G.npz" and f is None and r is None
    g, f, r = resolve_warm_start(
        run_dir, pretrained_name="other",
        pretrained_g_only_ckpt="/x/net_G.npz", ckpt_root=str(tmp_path))
    assert g.endswith("other/latest_net_G.npz")
    assert f.endswith("other/latest_net_F.npz")
    state = os.path.join(run_dir, "latest_train_state.npz")
    open(state, "wb").close()
    g, f, r = resolve_warm_start(run_dir, continue_train=True,
                                 pretrained_name="other",
                                 ckpt_root=str(tmp_path))
    assert r == state and g is None


def test_early_stopping():
    es = EarlyStopping(patience=2)
    assert not es.step(1.0)
    assert not es.step(0.9)
    assert not es.step(0.95)
    assert es.step(0.91)  # the second non-improvement stops
    assert es.should_stop


# -----------------------------------------------------------------------------
# utilities the loop uses

def test_utils_of_the_loop(tmp_path):
    from anatomix_tpu_torch.utils.logging import ScalarLogger
    from anatomix_tpu_torch.utils.profiling import annotate, trace
    from anatomix_tpu_torch.utils.visualization import (
        panel_figure,
        save_tensor,
        tensor2img,
    )

    vol = np.random.default_rng(0).random((8, 8, 8)).astype(np.float32)
    img = tensor2img(torch.from_numpy(vol))
    assert img.shape == (8, 8) and img.min() >= 0 and img.max() <= 1
    assert panel_figure({"a": vol, "b": vol}) is not None  # matplotlib here
    save_tensor(torch.from_numpy(vol)[None, ..., None],
                str(tmp_path / "v" / "t.nii.gz"))
    assert (tmp_path / "v" / "t.nii.gz").exists()

    with trace(str(tmp_path / "prof")) as prof:
        with annotate("test-region"):
            torch.ones(4).add_(1)
    assert any(e.key == "test-region" for e in prof.key_averages())
    assert (tmp_path / "prof" / "trace.json").exists()

    log = ScalarLogger(str(tmp_path / "log"))
    log.log(3, {"a": 1.5})
    log.close()
    rec = json.loads((tmp_path / "log" / "scalars.jsonl").read_text())
    assert rec["step"] == 3 and rec["a"] == 1.5

    save_json(str(tmp_path / "o.json"), {"k": (1, 2)})
    assert json.loads((tmp_path / "o.json").read_text()) == {"k": [1, 2]}
    ck = tmp_path / "ck"
    assert latest_checkpoint(str(ck)) is None
    os.makedirs(ck)
    for name in ("epoch_001.npz", "epoch_010.npz", "other.npz"):
        (ck / name).write_bytes(b"")
    assert latest_checkpoint(str(ck)).endswith("epoch_010.npz")
