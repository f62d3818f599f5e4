"""The port's parallel inference paths on gloo ranks against the JAX package
on the CPU: the halo exchange, K1's D-valid mode (its plain version), the
spatially sharded UNet (nearest: against JAX's sharded forward; trilinear:
against the unsharded forward, which JAX's sharded forward misses, ROADMAP
F9), the window-sharded sliding window (UNet and a small Primus) and the
dry run. JAX runs in this process on the conftest's 8 virtual CPU devices;
the port's ranks are spawned processes (`parallel.launch.spawn`) that run
`tests/torch_parallel_workers.py`, which imports no JAX."""

import datetime
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from anatomix_tpu import extract as jax_extract
from anatomix_tpu.models import vit3d as jax_primus
from anatomix_tpu.models.unet import UnetConfig as JUnetConfig
from anatomix_tpu.models.unet import build_plan as jbuild_plan
from anatomix_tpu.models.unet import unet_apply
from anatomix_tpu.ops.conv import conv3d as jconv3d
from anatomix_tpu.parallel import spatial_sharded_unet
from anatomix_tpu.parallel.spatial import halo_pad_d as jhalo_pad_d
from anatomix_tpu_torch.kernels.conv import (
    conv3x3x3_dvalid_ndhwc,
    conv3x3x3_dvalid_ndhwc_plain,
)
from anatomix_tpu_torch.models.convert import to_jax_params
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan, init_params
from anatomix_tpu_torch.models.vit3d import PrimusConfig
from anatomix_tpu_torch.models.vit3d.convert import from_jax_primus_params
from anatomix_tpu_torch.ops.conv import pack_conv_weight
from anatomix_tpu_torch.parallel import launch, receptive_field
from anatomix_tpu_torch.parallel import dryrun
from anatomix_tpu_torch.parallel.dryrun import TINY
from anatomix_tpu_torch.parallel.mesh import shard_batch

import torch_parallel_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(input_nc=1, output_nc=4, num_downs=2, ngf=4)
# the JAX package's own bound for its sharded forward
# (tests/test_parallel.py:61)
ATOL, RTOL = 2e-4, 1e-3


def _jmesh(n, axis):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _seeded_sd(plan, seed=0):
    """The port's seeded init, with batch-norm running stats drawn away
    from (0, 1) so eval mode is not trivial (as tests/test_parallel.py
    does)."""
    sd = init_params(plan, torch.Generator().manual_seed(seed))
    r = np.random.default_rng(seed)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = torch.from_numpy(
                r.standard_normal(sd[k].shape[0]).astype(np.float32) * 0.1)
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(
                (r.random(sd[k].shape[0]) + 0.5).astype(np.float32))
    return {k: v for k, v in sd.items() if v.is_floating_point()}


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


# -----------------------------------------------------------------------------
# the halo exchange and K1's D-valid mode

@pytest.mark.parametrize("pad_type", ["reflect", "replicate", "zeros"])
def test_halo_pad_d_matches_jax(pad_type):
    """Each of 4 ranks' haloed shard, bit for bit, against JAX's
    `halo_pad_d` under `shard_map` on 4 devices."""
    x = np.random.default_rng(1).standard_normal(
        (2, 16, 5, 3, 3)).astype(np.float32)
    ref = jax.shard_map(
        lambda v: jhalo_pad_d(v, "space", pad_type), mesh=_jmesh(4, "space"),
        in_specs=P(None, "space"), out_specs=P(None, "space"),
        check_vma=False)(jnp.asarray(x))
    got = launch.spawn(workers.halo, 4, "cpu", x, pad_type)
    np.testing.assert_array_equal(np.concatenate(got, axis=1),
                                  np.asarray(ref))


@pytest.mark.parametrize("pad_type", ["reflect", "zeros"])
def test_dvalid_conv_plain_matches_jax_valid_conv(pad_type):
    """K1's D-valid plain version on a haloed input: JAX's explicit H/W pad
    and VALID `conv3d`, as its sharded conv computes it."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 6, 5, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 3, 4)).astype(np.float32) * 0.2
    b = rng.standard_normal(4).astype(np.float32)
    mode = "reflect" if pad_type == "reflect" else "constant"
    ref = jconv3d(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (1, 1), (1, 1),
                                           (0, 0)), mode=mode),
                  jnp.asarray(w), jnp.asarray(b), padding="VALID")
    w_t = torch.from_numpy(w).permute(4, 3, 0, 1, 2)
    kw = dict(act="none", pad_type=pad_type, out_dtype=torch.float32)
    got = conv3x3x3_dvalid_ndhwc_plain(
        torch.from_numpy(x), pack_conv_weight(w_t), torch.from_numpy(b), **kw)
    assert got.shape == (2, 5, 6, 5, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # the wrapper takes the plain version for a CPU tensor and counts
    # nothing
    before = conv3x3x3_dvalid_ndhwc.launches
    again = conv3x3x3_dvalid_ndhwc(
        torch.from_numpy(x), pack_conv_weight(w_t), torch.from_numpy(b), **kw)
    assert torch.equal(again, got)
    assert conv3x3x3_dvalid_ndhwc.launches == before


# -----------------------------------------------------------------------------
# the spatially sharded UNet

@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_spatial_sharded_unet_matches_jax(norm):
    """4 ranks, nearest upsampling, D = 32 (shards of 8): against JAX's
    `spatial_sharded_unet` on 4 devices, which equals its unsharded forward
    for these models."""
    cfg = dict(SMALL, norm=norm)
    plan = build_plan(UnetConfig(**cfg))
    sd = _seeded_sd(plan)
    jplan = jbuild_plan(JUnetConfig(dimension=3, **cfg))
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(plan, sd))
    vol = np.random.default_rng(3).standard_normal(
        (1, 32, 16, 16, 1)).astype(np.float32)
    ref = np.asarray(spatial_sharded_unet(
        jplan, params, _jmesh(4, "space"))(jnp.asarray(vol)))
    got = launch.spawn(workers.sharded_full, 4, "cpu", cfg, _np(sd), vol)
    for g in got:  # every rank returns the whole gathered volume
        np.testing.assert_allclose(g, ref, atol=ATOL, rtol=RTOL)


def test_spatial_sharded_trilinear_unet_matches_unsharded():
    """F9: the dev topology (instance norm, Avg pool, trilinear) on 4
    ranks against JAX's *unsharded* `unet_apply`; JAX's own sharded
    forward clamps the upsample at each seam and misses it by more than
    0.1 (planes 7-9, 15-17, 23-25 of 32)."""
    cfg = dict(SMALL, norm="instance", pooling="Avg", interp="trilinear",
               norm_eps=1e-2)
    plan = build_plan(UnetConfig(**cfg))
    sd = _seeded_sd(plan)
    jplan = jbuild_plan(JUnetConfig(dimension=3, **cfg))
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(plan, sd))
    vol = np.random.default_rng(0).standard_normal(
        (1, 32, 16, 16, 1)).astype(np.float32)
    ref = np.asarray(unet_apply(jplan, params, jnp.asarray(vol)))
    jax_sharded = np.asarray(spatial_sharded_unet(
        jplan, params, _jmesh(4, "space"))(jnp.asarray(vol)))
    assert np.abs(jax_sharded - ref).max() > 0.1
    got = launch.spawn(workers.sharded_full, 4, "cpu", cfg, _np(sd), vol)
    np.testing.assert_allclose(got[0], ref, atol=ATOL, rtol=RTOL)


def test_spatial_sharded_rejects_bad_divisibility():
    """D must divide over the 'space' ranks times 2**num_downs, as in
    JAX."""
    plan = build_plan(UnetConfig(**SMALL))
    with pytest.raises(RuntimeError, match="divisible"):
        launch.spawn(workers.sharded_full, 2, "cpu", SMALL,
                     _np(_seeded_sd(plan)),
                     np.zeros((1, 20, 16, 16, 1), np.float32))


def test_receptive_field_matches_jax():
    from anatomix_tpu.parallel.spatial import receptive_field as jrf

    for kw in (dict(num_downs=4, ngf=16, output_nc=16), SMALL):
        cfg = dict(dict(input_nc=1), **kw)
        assert receptive_field(build_plan(UnetConfig(**cfg))) == jrf(
            jbuild_plan(JUnetConfig(dimension=3, **cfg)))


# -----------------------------------------------------------------------------
# the window-sharded sliding window

def test_window_sharded_sliding_unet_matches_jax_mesh():
    """2 ranks, roi 8, overlap 0.5, sw_batch 2 on a 24x16x16 volume (18
    windows, 20 padded): against JAX's mesh path on 2 devices."""
    plan = build_plan(UnetConfig(**SMALL))
    sd = _seeded_sd(plan)
    jplan = jbuild_plan(JUnetConfig(dimension=3, **SMALL))
    params = to_jax_params(plan, sd)
    vol = np.random.default_rng(4).standard_normal(
        (1, 24, 16, 16, 1)).astype(np.float32)
    kw = dict(roi_size=(8, 8, 8), sw_batch_size=2, overlap=0.5)
    ref = np.asarray(jax_extract.make_feature_extractor(
        jplan, params, strategy="sliding", compute_dtype=jnp.float32,
        mesh=_jmesh(2, "data"), **kw)(jnp.asarray(vol)))
    got = launch.spawn(workers.sharded_sliding, 2, "cpu", SMALL, _np(sd),
                       vol, kw)
    np.testing.assert_allclose(got[0], ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0], got[1])


def test_window_sharded_sliding_primus_matches_jax_mesh():
    """A small Primus (embed 64, 2 blocks, 16^3 windows) on a 24x16x16
    volume over 2 ranks: against JAX's mesh path at the ViT's f32 model
    tolerance (1e-3 of the largest feature, tests/test_torch_vit.py), and
    against the port's unsharded stitch at 1e-5."""
    kw = dict(input_channels=1, num_classes=8, embed_dim=64, eva_depth=2,
              eva_numheads=2, patch_embed_size=(8, 8, 8),
              input_shape=(16, 16, 16), num_register_tokens=2,
              init_values=0.1, scale_attn_inner=True, qk_norm=True,
              out_norm="demean", out_norm_eps=1e-2, in_eps=1e-2,
              tokenizer_base_features=8)
    jcfg = jax_primus.PrimusConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jax_primus.init_primus_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    cfg = PrimusConfig(**kw)
    sd = from_jax_primus_params(cfg, params)
    vol = (np.random.default_rng(5).standard_normal((1, 24, 16, 16, 1))
           * 0.3 + 0.5).astype(np.float32)
    skw = dict(overlap=0.5, sw_batch_size=2)
    ref = np.asarray(jax_extract.make_feature_extractor(
        jcfg, params, compute_dtype=jnp.float32, mesh=_jmesh(2, "data"),
        **skw)(jnp.asarray(vol)))
    got = launch.spawn(workers.sharded_sliding, 2, "cpu", cfg, _np(sd),
                       vol, skw)
    assert got[0].shape == (1, 24, 16, 16, 8)
    assert np.abs(got[0] - ref).max() < 1e-3 * np.abs(ref).max()
    from anatomix_tpu_torch.extract import make_feature_extractor

    one = make_feature_extractor(cfg, sd, compute_dtype=torch.float32,
                                 device="cpu", **skw)(vol).numpy()
    np.testing.assert_allclose(got[0], one, rtol=1e-5, atol=1e-5)


# -----------------------------------------------------------------------------
# meshes and the dry run

def test_shard_batch_takes_contiguous_rows():
    from anatomix_tpu_torch.parallel.mesh import Mesh

    m = Mesh(("data", "space"), (2, 2), (1, 0), (None, None),
             torch.device("cpu"))
    assert m.shape == {"data": 2, "space": 2} and m.size == 4
    x = torch.arange(8)
    assert shard_batch(m, x).tolist() == [4, 5, 6, 7]
    assert shard_batch(m, x, "space").tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="divide"):
        shard_batch(m, torch.arange(3))
    with pytest.raises(ValueError, match="no 'model' axis"):
        m.group("model")


def test_multihost_helpers_single_process(monkeypatch):
    """No launcher variables: `initialize_distributed` is the single-process
    no-op; `fold_in_process` is rank 0's seed."""
    from anatomix_tpu_torch.parallel import multihost

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_distributed(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize_distributed(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize_distributed(device="cpu")
    a = multihost.fold_in_process(3)
    assert a == multihost.fold_in_process(3) != multihost.fold_in_process(4)


def test_meshes_of_ranks():
    """space_mesh(2, 2) on 4 ranks: rank = d * 2 + s, the 'space' groups
    are neighbouring ranks and the 'data' groups stride 2, as JAX's mesh
    keeps the innermost axis fastest; `replicate` broadcasts rank 0's
    tree; `global_batch_from_local` takes each rank's rows as they are."""
    got = launch.spawn(workers.mesh_helpers, 4, "cpu")
    for rank, (coords, groups, a, b, rows) in enumerate(got):
        assert coords == (rank // 2, rank % 2)
        assert groups["space"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert groups["data"] == [rank % 2, rank % 2 + 2]
        assert a == [0.0, 0.0, 0.0] and b == [0, 1] and rows == (2, 3)


def test_spatial_sharded_batch_of_two_matches_unsharded():
    """Two volumes at once on 2 ranks (the walk runs the batch items one
    after the other) against the port's unsharded forward."""
    cfg = dict(SMALL, norm="instance", pooling="Avg", interp="trilinear",
               norm_eps=1e-2)
    plan = build_plan(UnetConfig(**cfg))
    sd = _seeded_sd(plan)
    vol = np.random.default_rng(7).standard_normal(
        (2, 16, 8, 8, 1)).astype(np.float32)
    from anatomix_tpu_torch.extract import make_feature_extractor

    ref = make_feature_extractor(plan, sd, strategy="full", device="cpu",
                                 compute_dtype=torch.float32)(vol).numpy()
    got = launch.spawn(workers.sharded_full, 2, "cpu", cfg, _np(sd), vol)
    np.testing.assert_allclose(got[0], ref, atol=ATOL, rtol=RTOL)


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="of 2 failed"):
        launch.spawn(workers.halo, 2, "cpu",
                     np.zeros((1, 4, 2, 2, 1), np.float32), "mirror")


def test_spawn_keeps_a_rank_that_outlasts_the_group_timeout():
    """A run has no deadline: a rank busy far longer than the process
    group's timeout is waited for, while no collective waits on it."""
    got = launch.spawn(workers.sleeper, 2, "cpu", 4.0, False,
                       group_timeout=datetime.timedelta(seconds=1))
    assert got == [0, 1]


def test_spawn_fails_a_collective_that_outwaits_the_group_timeout():
    """A rank that waits in a collective longer than the group's timeout
    fails, and the run ends with its error."""
    with pytest.raises(RuntimeError, match="of 2 failed"):
        launch.spawn(workers.sleeper, 2, "cpu", 6.0, True,
                     group_timeout=datetime.timedelta(seconds=1))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_on_cpu_ranks(n):
    """`python -m anatomix_tpu_torch.parallel.dryrun --n N --device cpu`:
    phases 1-5 and 7 (the ViT's mesh step, v2 and v1), each held against
    one rank."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m", "anatomix_tpu_torch.parallel.dryrun", "--n",
         str(n), "--device", "cpu"], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip({n}) ok: loss=")
    assert "vit_loss_rel=" in line and "vit1_loss_rel=" in line
    assert TINY["num_downs"] == 2


def test_dryrun_trainer_phase_on_cpu_ranks():
    """The dry run's `--train` phase: the trainer over 2 gloo ranks logs
    two step losses and one val loss, each within `TOL_TRAIN` of one
    device's."""
    t = dryrun.trainer_losses(2, "cpu")
    assert len(t["dp"]) == len(t["one"]) == 2
    assert len(t["dp_val"]) == len(t["one_val"]) == 1
    for a, b in zip(t["dp"] + t["dp_val"], t["one"] + t["one_val"]):
        assert a == pytest.approx(b, rel=dryrun.TOL_TRAIN[torch.float32])

