"""Rank functions of the port's parallel tests (`tests/test_torch_parallel*.py`).

`parallel.launch.spawn` starts each rank from a fresh interpreter that
imports this module, so it imports torch and the port only, never JAX:
inputs arrive as numpy arrays and results go back as numpy arrays.

Run as a script it is one process of a `torchrun`-style launch of the
trainer (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT` set by the
test): `python torch_parallel_workers.py CONFIG.json`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from anatomix_tpu_torch.extract import make_feature_extractor
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan
from anatomix_tpu_torch.parallel.mesh import (
    data_mesh,
    shard_batch,
    space_mesh,
)
from anatomix_tpu_torch.parallel.spatial import halo_pad_d
from anatomix_tpu_torch.pretraining import train_step as ts


def _sd(sd_np):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd_np.items()}


def _np_tree(tree):
    return ts.tree_map(lambda v: v.detach().cpu().numpy()
                       if torch.is_tensor(v) else v, tree)


def halo(rank, world, dev, x_np, pad_type):
    """This rank's D-shard of `x_np` with its halo planes."""
    mesh = space_mesh(1, world, device=dev)
    x = shard_batch(mesh, torch.from_numpy(x_np).transpose(0, 1), "space")
    return halo_pad_d(x.transpose(0, 1).contiguous(), mesh.group("space"),
                      pad_type).numpy()


def sleeper(rank, world, dev, seconds, reduce_after):
    """Rank 1 sleeps `seconds` before it returns (or before it joins an
    all-reduce that rank 0 waits in, with `reduce_after`); every rank
    returns its rank."""
    import time

    if rank == 1:
        time.sleep(seconds)
    if reduce_after:
        torch.distributed.all_reduce(torch.zeros(1))
    return rank


def mesh_helpers(rank, world, dev):
    """This rank's coordinates and groups on a (2, world / 2) mesh, a tree
    after `replicate`, and the rows `global_batch_from_local` accepts."""
    from anatomix_tpu_torch.parallel import (
        global_batch_from_local,
        replicate,
    )

    m = space_mesh(2, world // 2, device=dev)
    tree = {"a": torch.full((3,), float(rank)), "b": [torch.arange(2) + rank]}
    replicate(m, tree)
    local = global_batch_from_local(m, {"views": np.ones((2, 3), np.float32)})
    return (m.coords, {a: torch.distributed.get_process_group_ranks(
                m.group(a)) for a in m.axis_names},
            tree["a"].tolist(), tree["b"][0].tolist(),
            tuple(local["views"].shape))


def sharded_full(rank, world, dev, config, sd_np, vol_np):
    """The f32 `full` features of `vol_np` through the 'space' route."""
    plan = build_plan(UnetConfig(**config))
    fx = make_feature_extractor(
        plan, _sd(sd_np), strategy="full", compute_dtype=torch.float32,
        device=dev, mesh=space_mesh(1, world, device=dev))
    return fx(vol_np).numpy()


def sharded_sliding(rank, world, dev, plan_or_cfg, sd_np, vol_np, kw):
    """The f32 sliding features of `vol_np`, windows sharded over a 'data'
    mesh of the world (a UNet config dict, or a `PrimusConfig`)."""
    plan = (build_plan(UnetConfig(**plan_or_cfg))
            if isinstance(plan_or_cfg, dict) else plan_or_cfg)
    fx = make_feature_extractor(
        plan, _sd(sd_np), strategy="sliding", compute_dtype=torch.float32,
        device=dev, mesh=data_mesh(world, device=dev), **kw)
    return fx(vol_np).numpy()


def dp_steps(rank, world, dev, config, state_np, views, segs, n_steps,
             step_kw, seed):
    """`n_steps` data-parallel steps from the JAX-layout train state
    `state_np` on the global batch (views, segs), this rank on its rows;
    the metrics of each step and the final parameters."""
    from anatomix_tpu_torch.models.convert import from_jax_train_state

    plan = build_plan(UnetConfig(**config))
    mesh = data_mesh(world, device=dev)
    state = from_jax_train_state(state_np, plan)
    step = ts.build_train_step(plan, mesh=mesh, **step_kw)
    v = shard_batch(mesh, torch.from_numpy(views))
    s = shard_batch(mesh, torch.from_numpy(segs))
    metrics = []
    for _ in range(n_steps):
        state, m = step(state, v, s, torch.Generator().manual_seed(seed))
        metrics.append({k: float(x) for k, x in m.items()})
    return metrics, _np_tree(state.params_g), _np_tree(state.params_f)


def dp_vit_steps(rank, world, dev, cfg, views, segs, n_steps, seed):
    """`n_steps` data-parallel steps of the ViT (`cfg` a `PrimusConfig`)
    from its seeded state; each step's metrics."""
    mesh = data_mesh(world, device=dev)
    state = ts.init_train_state(cfg, torch.Generator().manual_seed(seed),
                                tap_layers=(-1,), netf_nc=16, device=dev)
    step = ts.build_train_step(cfg, mesh=mesh, tap_layers=(-1,),
                               num_patches=64, lr=1e-3,
                               compute_dtype=torch.float32)
    v = shard_batch(mesh, torch.from_numpy(views))
    s = shard_batch(mesh, torch.from_numpy(segs))
    metrics = []
    for _ in range(n_steps):
        state, m = step(state, v, s, torch.Generator().manual_seed(seed))
        metrics.append({k: float(x) for k, x in m.items()})
    return metrics


def dp_grads(rank, world, dev, config, state_np, views, segs, kw, seed):
    """The data-parallel loss and gradients (summed over the ranks, as the
    step sums them) of `nce_loss_and_grads` on the global batch, and the
    new running statistics; `kw["fg_from_segs"]` draws the patches from
    each shard's foreground (label > 0)."""
    from anatomix_tpu_torch.models.convert import from_jax_train_state

    plan = build_plan(UnetConfig(**config))
    mesh = data_mesh(world, device=dev)
    state = from_jax_train_state(state_np, plan)
    kw = dict(kw)
    v = shard_batch(mesh, torch.from_numpy(views))
    s = shard_batch(mesh, torch.from_numpy(segs))
    if kw.pop("fg_from_segs", False):  # the foreground masks of this shard
        kw["fg_masks"] = s[..., 0] > 0
    loss, aux, grads_g, grads_f = ts.nce_loss_and_grads(
        plan, state.params_g, state.params_f, v, s,
        torch.Generator().manual_seed(seed), mesh=mesh, **kw)
    group = mesh.group("data")
    ts.all_reduce_flat([g for _, g in ts.tree_items(grads_g)]
                       + [g for _, g in ts.tree_items(grads_f)], group)
    total = loss.clone()
    torch.distributed.all_reduce(total, group=group)
    return (float(total), _np_tree(grads_g), _np_tree(grads_f),
            _np_tree(aux["new_g_stats"]), _np_tree(aux["new_f_stats"]))


def _train_from_env(path: str) -> None:
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import train

    train(PretrainConfig.load(path), device="cpu")


if __name__ == "__main__":
    _train_from_env(sys.argv[1])
