"""The port's data-parallel pretraining on gloo ranks: the step against the
JAX package's mesh step on 2 virtual CPU devices, the step's loss and
gradients at 2 ranks against one rank on the same global batch (the
batch norms' statistics and backward through the group, the projector's
BatchNorm1d, the patch draws in the single-device order), and the trainer
at 1 and 2 ranks (`data_parallel_devices=2`, and `multihost` under a
torchrun-style environment): the same losses as the single-device run,
one writer, the same validation loss.

As in `tests/test_torch_pretrain.py`, the step is held against JAX in f32
with `num_patches` >= every tap's voxels (512 at 8^3), so the two
frameworks' different random draws do not matter; against the port's own
single-device step the draws are the same ones."""

import json
import os
import socket
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from anatomix_tpu.models.unet import UnetConfig as JUnetConfig
from anatomix_tpu.models.unet import build_plan as jbuild_plan
from anatomix_tpu.pretraining import train_step as jts
from anatomix_tpu_torch.models.convert import from_jax_train_state
from anatomix_tpu_torch.models.convert import to_jax_params
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan, init_params
from anatomix_tpu_torch.parallel import launch
from anatomix_tpu_torch.pretraining import train as ptrain
from anatomix_tpu_torch.pretraining import train_step as ts
from anatomix_tpu_torch.pretraining.config import PretrainConfig

import torch_parallel_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(input_nc=1, output_nc=4, num_downs=2, ngf=4)
TAPS = (17, 20, 24, 31, 37)  # 2^3 bottleneck, 4^3 and 8^3 decoder, exit
P_ALL = 512  # every voxel of every tap at 8^3


@pytest.fixture(scope="module")
def tiny():
    """The tiny UNet's train state on both sides (G from the port's seeded
    init, F from JAX's) and a global batch of 2 view pairs at 8^3."""
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
    rng = np.random.default_rng(5)
    views = rng.standard_normal((2, 2, 8, 8, 8, 1)).astype(np.float32)
    segs = rng.integers(0, 4, (2, 8, 8, 8, 1)).astype(np.int32)
    return dict(jplan=jplan, plan=plan, jstate=jstate, state_np=state_np,
                views=views, segs=segs)


def test_dp_step_matches_jax_mesh_step(tiny):
    """3 steps at 2 ranks (one view pair each) against JAX's step on a
    2-device 'data' mesh, f32: the loss within 1e-3 relative, the
    gradient norms 1e-3 and the running variance 1e-4, as the
    single-device parity test holds them."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jstep = jts.build_train_step(
        tiny["jplan"], num_patches=P_ALL, tap_layers=TAPS,
        nce_temperature=0.33, lr=1e-3, donate=False, conv_impl="xla",
        compute_dtype=jnp.float32, mesh=mesh)
    data = NamedSharding(mesh, P("data"))
    jstate = jax.device_put(tiny["jstate"], NamedSharding(mesh, P()))
    jviews = jax.device_put(jnp.asarray(tiny["views"]), data)
    jsegs = jax.device_put(jnp.asarray(tiny["segs"]), data)
    ref = []
    for _ in range(3):
        jstate, m = jstep(jstate, jviews, jsegs, jax.random.PRNGKey(5))
        ref.append({k: float(v) for k, v in m.items()})
    step_kw = dict(tap_layers=TAPS, num_patches=P_ALL, lr=1e-3,
                   compute_dtype=torch.float32)
    results = launch.spawn(workers.dp_steps, 2, "cpu", TINY,
                           tiny["state_np"], tiny["views"], tiny["segs"], 3,
                           step_kw, 5)
    (metrics, params_g, _), (metrics1, params_g1, _) = results
    for got, r in zip(metrics, ref):
        assert abs(got["loss"] - r["loss"]) <= 1e-3 * abs(r["loss"])
        assert got["lr"] == pytest.approx(r["lr"], rel=1e-6)
        for k in ("grad_norm_G", "grad_norm_F"):
            assert got[k] == pytest.approx(r[k], rel=1e-3)
    # the ranks hold replicas: the same metrics and parameters
    assert metrics1 == metrics
    for k in params_g:
        np.testing.assert_array_equal(params_g[k], params_g1[k])
    np.testing.assert_allclose(params_g["model.1.running_var"],
                               np.asarray(jstate.params_g["1"]["var"]),
                               rtol=1e-4)


@pytest.mark.parametrize("fg_mask", [False, True])
def test_dp_loss_and_grads_match_one_rank(tiny, fg_mask):
    """A global batch of 4 pairs over 2 ranks against one process on the
    whole batch, 16 patches a tap (the draws matter): the loss, every
    gradient (the batch norms' backward reduces over the group) and the
    new running statistics of the UNet's and the projector's batch norms
    within 1e-5 (the loss, relative; the statistics, of their largest),
    the gradients within 1e-4 of their largest."""
    plan = tiny["plan"]
    rng = np.random.default_rng(6)
    views = rng.standard_normal((4, 2, 8, 8, 8, 1)).astype(np.float32)
    segs = rng.integers(0, 4, (4, 8, 8, 8, 1)).astype(np.int32)
    kw = dict(tap_layers=TAPS, num_patches=16,
              nce=ts.NCEOptions(temperature=0.33),
              compute_dtype=torch.float32)
    state = from_jax_train_state(tiny["state_np"], plan)
    one_kw = dict(kw)
    if fg_mask:
        one_kw["fg_masks"] = torch.from_numpy(segs[..., 0] > 0)
    loss, aux, grads_g, grads_f = ts.nce_loss_and_grads(
        plan, state.params_g, state.params_f, torch.from_numpy(views),
        torch.from_numpy(segs), torch.Generator().manual_seed(9), **one_kw)
    got = launch.spawn(workers.dp_grads, 2, "cpu", TINY, tiny["state_np"],
                       views, segs, dict(kw, fg_from_segs=fg_mask), 9)
    for total, gg, gf, g_stats, f_stats in got:
        assert abs(total - float(loss)) <= 1e-5 * abs(float(loss))
        # each leaf to a share of its tree's largest value: the running
        # statistics 1e-5; the gradients 1e-4, since the two routes sum the
        # batch norms' statistics in another order and this step is
        # ill-conditioned (a 1-ulp change of the views moves its gradients
        # by 1.3-1.4e-2 of the largest, max-pool ties and relu kinks); the
        # two routes read up to 1.44e-5 apart, and a batch norm whose
        # backward skipped the group would read ~1e-1
        for ref_tree, got_tree, tol in (
                (grads_g, gg, 1e-4), (grads_f, gf, 1e-4),
                (aux["new_g_stats"], g_stats, 1e-5),
                (aux["new_f_stats"], f_stats, 1e-5)):
            pairs = [(k, g, r.numpy()) for (k, g), (_, r) in zip(
                ts.tree_items(got_tree), ts.tree_items(ref_tree))]
            net = max(float(np.abs(r).max()) for _, _, r in pairs)
            for k, g, r in pairs:
                assert float(np.abs(g - r).max()) <= tol * net, k


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_dp_vit_steps_match_one_rank(version):
    """The ViT (`netG="primus"`, a small Primus: embed 32, one block, 16^3
    crops; the v2 tokenizer at patch 8, or v1's patch embed at patch 4 with
    the stage decoder) over 2 ranks, 2 steps on a global batch of 2 pairs
    with 64 patches: the losses and gradient norms of the single-device
    steps within 1e-5 (the projector's batch norms reduce over the
    group)."""
    from anatomix_tpu_torch.models.vit3d import PrimusConfig

    patch = 8 if version == "v2" else 4
    cfg = PrimusConfig(input_channels=1, num_classes=4, embed_dim=32,
                       eva_depth=1, eva_numheads=2,
                       patch_embed_size=(patch,) * 3,
                       input_shape=(16, 16, 16), num_register_tokens=2,
                       qk_norm=True, out_norm="demean", scale_attn_inner=True,
                       init_values=0.1, version=version)
    rng = np.random.default_rng(8)
    views = rng.standard_normal((2, 2, 16, 16, 16, 1)).astype(np.float32)
    segs = rng.integers(0, 4, (2, 16, 16, 16, 1)).astype(np.int32)
    state = ts.init_train_state(cfg, torch.Generator().manual_seed(3),
                                tap_layers=(-1,), netf_nc=16, device="cpu")
    step = ts.build_train_step(cfg, tap_layers=(-1,), num_patches=64,
                               lr=1e-3, compute_dtype=torch.float32)
    ref = []
    for _ in range(2):
        state, m = step(state, views, segs, torch.Generator().manual_seed(3))
        ref.append({k: float(x) for k, x in m.items()})
    got = launch.spawn(workers.dp_vit_steps, 2, "cpu", cfg, views, segs, 2,
                       3)
    assert got[0] == got[1]
    for g, r in zip(got[0], ref):
        for k in ("loss", "grad_norm_G", "grad_norm_F"):
            assert g[k] == pytest.approx(r[k], rel=1e-5), k


# -----------------------------------------------------------------------------
# the trainer

def _make_h5(path, n_subjects, size=16):
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        for i in range(n_subjects):
            g = f.create_group(f"{i:06d}")
            g.create_dataset("img", data=rng.random((2, size, size, size),
                                                    np.float32))
            g.create_dataset("seg", data=rng.integers(
                0, 3, (size, size, size)).astype(np.uint8))


def _cfg(tmp_path, name, **kw):
    base = dict(
        name=name, ckpt_dir=str(tmp_path / "ckpt"), dataroot=str(tmp_path),
        ndims=3, input_nc=1, output_nc=4, ngf=4, num_downs=2,
        nce_layers=(11, 33), netF_nc=16, n_mlps=2, num_patches=16,
        crop_size=16, batch_size=2, n_epochs=1, n_epochs_decay=0,
        print_freq=1, display_freq=0, save_latest_freq=2, evaluation_freq=2,
        n_val_during_train=1, max_iters=2, lr_policy="plateau",
        data_parallel_devices=1,
    )
    base.update(kw)
    return PretrainConfig(**base)


def _records(run_dir, key):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r[key]) for r in recs if key in r]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun_style(cfg, world):
    """`world` processes of the trainer with torchrun's variables."""
    path = os.path.join(cfg.ckpt_dir, f"{cfg.name}.json")
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    cfg.save(path)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=ROOT, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "torch_parallel_workers.py"),
             path], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def test_trainer_data_parallel_matches_one_device(tmp_path):
    """2 steps (batch 2) with validation and the plateau at step 2: one
    device, two spawned gloo ranks (`data_parallel_devices=2`) and two
    torchrun-style processes (`multihost`) log the same losses and the same
    validation loss, each once; the spawned run returns rank 0's state."""
    _make_h5(str(tmp_path / "train_data.hdf5"), 4)
    _make_h5(str(tmp_path / "val_data.hdf5"), 2)
    one = ptrain.train(_cfg(tmp_path, "one"), device="cpu")
    dp = ptrain.train(_cfg(tmp_path, "dp2", data_parallel_devices=2),
                      device="cpu")
    _torchrun_style(_cfg(tmp_path, "mh2", multihost=True), 2)
    runs = {n: str(tmp_path / "ckpt" / n) for n in ("one", "dp2", "mh2")}
    ref = _records(runs["one"], "loss/loss")
    assert [s for s, _ in ref] == [1, 2]
    for name in ("dp2", "mh2"):
        got = _records(runs[name], "loss/loss")
        # one writer: one record a step
        assert [s for s, _ in got] == [1, 2], name
        for (_, a), (_, b) in zip(got, ref):
            assert a == pytest.approx(b, rel=1e-4), name
        (vs, v), = _records(runs[name], "loss/val")
        (_, v1), = _records(runs["one"], "loss/val")
        assert vs == 2 and v == pytest.approx(v1, rel=1e-4), name
        assert os.path.exists(os.path.join(runs[name],
                                           "latest_train_state.npz"))
    assert dp.step == one.step == 2
    assert dp.params_g.keys() == one.params_g.keys()
    for k, v in one.params_g.items():
        assert dp.params_g[k].device.type == "cpu"
        assert dp.params_g[k].shape == v.shape


def test_trainer_refuses_an_uneven_batch(tmp_path):
    with pytest.raises(ValueError, match="divide evenly"):
        ptrain.train(_cfg(tmp_path, "odd", batch_size=3,
                          data_parallel_devices=2), device="cpu")
