"""The pretraining trainer (the port of `anatomix_tpu/pretraining/
train.py`): `build_all`, the loop `train`, its validation loss and its CLI.

    python -m anatomix_tpu_torch.pretraining.train --dataroot D --name N \
        [--device cpu] [--max_iters 3] ...

reads `D/train_data.hdf5` (and `D/val_data.hdf5` when present) and runs
`PretrainConfig`'s loop on the card (`--device cpu` for the plain PyTorch
path): a prefetching batch pipeline (host read and normalization, an f16 /
i16 transfer, the paired augmentation on the device, on a side stream),
the train step, the print / display / save / eval cadences with best-val
and plateau bookkeeping, resume (`continue_train`) and warm start
(`pretrained_name`, `pretrained_G_only_ckpt`, from this trainer's run dirs
or the JAX package's), and the final checkpoints. `build_all` alone gives
what the loop calls once per batch, for the UNet (`netG="unet"`) or the
Primus ViT (`netG="primus"`):

    plan, taps, state, step = build_all(cfg, steps_per_epoch)
    state, metrics = step(state, views, segs, generator)

with `views` (B, 2, D, H, W, 1) f32, `segs` (B, D, H, W, 1) int and a
`torch.Generator` on the device for the patch sampler.

Data parallelism (`anatomix_tpu/pretraining/train.py:173-228`): with
`data_parallel_devices` n > 1 (or 0, the default, on a machine with more
than one card and a batch they divide) `train` spawns n local ranks
(`parallel/launch.spawn`, rank r on `cuda:r`; gloo ranks for
`device="cpu"`); with `multihost` each process of a `torchrun` launch is
one rank (`parallel/multihost.initialize_distributed`):

    torchrun --nproc_per_node N -m anatomix_tpu_torch.pretraining.train \
        --multihost true --batch_size B ...

`batch_size` is the global batch. Every rank draws the whole global
batch's random parameters (the epoch order, each item's timepoints and
pair-augment draws) from the same seeded generators, and reads, normalizes
and augments only its own contiguous items, so any world size gives the
single-device run's losses. Rank 0 alone writes the run dir; validation
runs on every rank on the same inputs, so the plateau scale stays the same
everywhere.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from anatomix_tpu_torch.device import resolve_device
from anatomix_tpu_torch.models.unet import (
    UnetConfig,
    UnetPlan,
    build_plan,
    check_supported,
)
from anatomix_tpu_torch.models.vit3d.primus import PrimusConfig
from anatomix_tpu_torch.models.vit3d.primus_train import \
    check_train_supported as check_primus_supported
from anatomix_tpu_torch.parallel.launch import spawn
from anatomix_tpu_torch.parallel.mesh import data_mesh
from anatomix_tpu_torch.parallel.multihost import (
    global_data_mesh,
    initialize_distributed,
)
from anatomix_tpu_torch.pretraining.config import PretrainConfig
from anatomix_tpu_torch.pretraining.dataset import (
    H5TwoViewDataset,
    apply_pair_augment,
    draw_pair_params,
)
from anatomix_tpu_torch.pretraining.schedulers import (
    PlateauState,
    make_schedule,
)
from anatomix_tpu_torch.pretraining.train_step import (
    NCEOptions,
    build_train_step,
    frozen_layer_ids,
    init_train_state,
    nce_forward,
    tree_map,
)
from anatomix_tpu_torch.pretraining.warmstart import (
    load_partial,
    params_g_from_checkpoint,
    resolve_warm_start,
)
from anatomix_tpu_torch.utils.checkpoint import (
    load_pytree,
    load_train_state,
    save_pytree,
    save_train_state,
)
from anatomix_tpu_torch.utils.logging import ScalarLogger
from anatomix_tpu_torch.utils.profiling import annotate
from anatomix_tpu_torch.utils.visualization import log_panels, save_tensor


def frozen_layers(cfg: PretrainConfig, plan, taps) -> tuple[int, ...]:
    """The UNet layers `cfg.unfreeze_layers` leaves frozen (none for the
    ViT)."""
    if not (cfg.unfreeze_layers and cfg.netG == "unet"):
        return ()
    return frozen_layer_ids(
        plan, [int(i) for i in cfg.unfreeze_layers.split(",")], taps)


def build_all(cfg: PretrainConfig, steps_per_epoch: int, *,
              device: str | torch.device = "cuda", plain: bool = False,
              mesh=None):
    """The backbone's plan (a UNet plan, or for `netG="primus"` the
    `PrimusConfig` the JAX package builds), its tap layers, a seeded train
    state (`cfg.seed`) on `device` and the train step, at `cfg`'s settings.
    Runs on the card unless `device="cpu"`; raises without a card. The step
    computes in bf16 on the card (the kernels) and in f32 on the CPU (the
    plain path, as the JAX package's trainer does on the CPU); `plain=True`
    gives the f32 plain path on the card too. With a `parallel.Mesh` the
    step is data parallel over its 'data' axis (`build_train_step`), and
    every rank builds the same seeded state."""
    dev = resolve_device(device)
    if cfg.netG == "unet":
        plan = build_plan(UnetConfig(
            dimension=cfg.ndims, input_nc=cfg.input_nc,
            output_nc=cfg.output_nc, num_downs=cfg.num_downs, ngf=cfg.ngf,
            norm=cfg.normG, activation=cfg.actG, pooling=cfg.pool_type,
            interp=cfg.interp_type, norm_eps=cfg.norm_eps_G,
        ))
        check_supported(plan.config)
        taps = cfg.tap_layers()
    elif cfg.netG == "primus":
        # the 26M ViT at the crop size (`anatomix_tpu/pretraining/train.py`)
        plan = PrimusConfig(
            input_channels=cfg.input_nc, num_classes=cfg.output_nc,
            input_shape=(cfg.crop_size,) * 3, out_norm="demean",
            qk_norm=True, scale_attn_inner=True, init_values=0.1,
            in_eps=cfg.norm_eps_G,
        )
        check_primus_supported(plan)
        taps = (-1,)  # the ViT exposes a single feature scale
    else:
        raise NotImplementedError(f"netG {cfg.netG!r}")
    # plateau is loss-driven: a constant schedule scaled by state.lr_scale
    schedule = None if cfg.lr_policy == "plateau" else make_schedule(
        cfg.lr, cfg.lr_policy, n_epochs=cfg.n_epochs,
        n_epochs_decay=cfg.n_epochs_decay, steps_per_epoch=steps_per_epoch)
    frozen = frozen_layers(cfg, plan, taps)
    state = init_train_state(
        plan, torch.Generator().manual_seed(cfg.seed), tap_layers=taps,
        netf_nc=cfg.netF_nc, n_mlps=cfg.n_mlps, init_type=cfg.init_type,
        init_gain=cfg.init_gain, grad_accum=cfg.grad_accum_iters,
        device=dev,
    )
    step = build_train_step(
        plan, tap_layers=taps, num_patches=cfg.num_patches,
        nce_temperature=cfg.nce_T, lambda_nce=cfg.lambda_NCE,
        weigh_rarity=cfg.weigh_rarity,
        balance_denominator=cfg.balance_denominator,
        weighting_mode=cfg.weighting_mode, nce_weights=cfg.nce_weights,
        lr=cfg.lr, beta1=cfg.beta1, beta2=cfg.beta2,
        weight_decay=cfg.weight_decay,
        grad_clip=cfg.max_norm_G if cfg.clip_grad else None,
        grad_clip_f=cfg.max_norm_F if cfg.clip_grad else None,
        grad_accum=cfg.grad_accum_iters, schedule=schedule,
        compute_dtype=(torch.bfloat16 if dev.type == "cuda" and not plain
                       else torch.float32),
        frozen_layers=frozen, use_fg_mask=cfg.load_mask, plain=plain,
        mesh=mesh,
    )
    return plan, taps, state, step


def compute_val_loss(plan, cfg, taps, state, val_ds, rng_np, n_batches, *,
                     device: str | torch.device = "cuda"):
    """Validation loss on whole volumes, no augmentation (`train.py:317-376`
    of the reference): the mean of eval-mode `nce_forward` over the first
    `n_batches` subjects, the patch sampler of subject i seeded with i."""
    dev = torch.device(device)
    nce = NCEOptions(
        temperature=cfg.nce_T, lambda_nce=cfg.lambda_NCE,
        weigh_rarity=cfg.weigh_rarity,
        balance_denominator=cfg.balance_denominator,
        weighting_mode=cfg.weighting_mode,
    )
    compute_dtype = (torch.bfloat16 if dev.type == "cuda"
                     else torch.float32)
    losses = []
    for i in range(min(n_batches, len(val_ds.subjects))):
        img_a, img_b, seg = val_ds.get(i, rng_np)
        views = torch.stack([torch.from_numpy(img_a),
                             torch.from_numpy(img_b)])[None, ..., None]
        segs = torch.from_numpy(seg).long()[None, ..., None]
        with torch.no_grad():
            loss, _ = nce_forward(
                plan, state.params_g, state.params_f, views.to(dev),
                segs.to(dev), torch.Generator(device=dev).manual_seed(i),
                tap_layers=taps, num_patches=cfg.num_patches, nce=nce,
                nce_weights=cfg.nce_weights, train=False,
                compute_dtype=compute_dtype)
        losses.append(float(loss))
    return float(np.mean(losses)) if losses else float("nan")


class BatchPipeline:
    """One batch of the loop from dataset items: the host read and
    normalization (`H5TwoViewDataset.get`, drawing from `rng`), the
    transfer of the images as f16 and the labels as i16 (the JAX package's
    quantization of the inputs), and the paired augmentation on the device
    (parameters from a CPU generator, noise fields from one on the device).

    On the card it runs on its own CUDA stream, so a worker thread's batch
    overlaps the step on the default stream; the consumer calls `ready`
    before using a batch. The generators belong to the thread that calls
    the pipeline (torch generators are not thread-safe)."""

    def __init__(self, ds: H5TwoViewDataset, cfg, rng: np.random.Generator,
                 device: torch.device, seeds: tuple[int, int]):
        if device.type == "cuda" and device.index is None:
            # the caller's card: a worker thread's current card is card 0
            device = torch.device("cuda", torch.cuda.current_device())
        self.ds, self.cfg, self.rng, self.device = ds, cfg, rng, device
        self.aug_gen = torch.Generator().manual_seed(seeds[0])
        self.field_gen = torch.Generator(device=device).manual_seed(seeds[1])
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def __call__(self, idxs, keep: range | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """views (B, 2, c, c, c, 1) f32 and segs (B, c, c, c, 1) int64 of
        the items at the positions `keep` of `idxs` (all by default). The
        other items' random draws are taken all the same, without reading
        them (data parallelism: another rank holds them)."""
        if self.stream is not None:
            # the calling thread's card (a rank's worker thread starts on
            # card 0)
            torch.cuda.set_device(self.device)
        stream = (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext())
        keep = range(len(idxs)) if keep is None else keep
        views_list, segs_list = [], []
        with stream:
            for pos, i in enumerate(idxs):
                if pos not in keep:
                    with annotate("data/skip"):
                        shape = self.ds.draw(int(i), self.rng)
                        draw_pair_params(self.aug_gen, self.cfg, shape,
                                         self.field_gen)
                    continue
                with annotate("data/read"):
                    img_a, img_b, seg = self.ds.get(int(i), self.rng)
                    if seg.max() >= np.iinfo(np.int16).max:
                        raise ValueError(f"label ids up to {seg.max()} "
                                         "overflow the int16 transfer")
                    host = [img_a.astype(np.float16),
                            img_b.astype(np.float16), seg.astype(np.int16)]
                with annotate("data/h2d"):
                    a, b, sg = (self._to_device(h).float() for h in host)
                with annotate("data/augment"):
                    params = draw_pair_params(self.aug_gen, self.cfg,
                                              a.shape, self.field_gen)
                    v, s = apply_pair_augment(params, a, b, sg,
                                              crop_size=self.cfg.crop_size)
                views_list.append(v)
                segs_list.append(s)
            return (torch.stack(views_list),
                    torch.stack(segs_list).to(torch.int64))

    def ready(self, *tensors: torch.Tensor) -> None:
        """Order the current stream after the pipeline's work, and tell the
        caching allocator the batch's tensors are used there (else their
        memory could go back to the pipeline's stream while the step still
        reads it)."""
        if self.stream is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_stream(self.stream)
        for t in tensors:
            t.record_stream(cur)


def _seeds(seed: int, total_iters: int, n: int) -> list[int]:
    """n 31-bit seeds for the loop's torch generators, from (seed, iter)."""
    return [int(v) & 0x7FFFFFFF for v in
            np.random.SeedSequence([seed, total_iters]).generate_state(n)]


def local_world(cfg: PretrainConfig, device) -> int:
    """The local ranks `train` runs: `data_parallel_devices` when set (the
    global batch must divide over them), else every card when there is
    more than one and they divide the batch, else 1."""
    n = cfg.data_parallel_devices
    if n:
        if n > 1 and cfg.batch_size % n:
            raise ValueError(f"batch_size {cfg.batch_size} must divide "
                             f"evenly over data_parallel_devices {n}")
        return n
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        cards = torch.cuda.device_count()
        if cards > 1 and cfg.batch_size % cards == 0:
            return cards
        if cards > 1:
            print(f"batch_size {cfg.batch_size} does not divide over "
                  f"{cards} cards: training on one")
    return 1


def train(cfg: PretrainConfig, train_h5=None, val_h5=None, *,
          device: str | torch.device = "cuda"):
    """Run the pretraining loop at `cfg` and return the final `TrainState`.
    `train_h5` / `val_h5` default to `cfg.dataroot`'s `train_data.hdf5` /
    `val_data.hdf5` (val only when present); each may be a path or a
    mapping of subject -> {"img", "seg"}. Writes the run dir
    `cfg.ckpt_dir/cfg.name`: `train_opt.json`, `scalars.jsonl`,
    `loss_log.txt`, `latest_train_state.npz`, `latest_net_{G,F}.npz`,
    `<iter>_net_G.npz`, `best_val_net_G.npz` and `visuals/`. Runs on the
    card unless `device="cpu"`; raises without a card.

    Data parallel (see the module docstring): `multihost` joins the
    process group `torchrun` describes and this process runs its rank;
    else `local_world` > 1 spawns the local ranks and returns rank 0's
    final state, on the CPU. A rank that fails ends the run with its
    error."""
    if cfg.multihost:
        if initialize_distributed(device=device):
            mesh = global_data_mesh(device=device)
            return _run(cfg, train_h5, val_h5, mesh.device, mesh)
        # a world of one: the single-device run
    else:
        n = local_world(cfg, device)
        if n > 1:
            return spawn(_train_rank, n, str(torch.device(device)), cfg,
                         train_h5, val_h5)[0]
    return _run(cfg, train_h5, val_h5, resolve_device(device), None)


def _train_rank(rank, world, dev, cfg, train_h5, val_h5):
    """One spawned rank of `train`: its final state (rank 0's on the CPU,
    the others' None)."""
    state = _run(cfg, train_h5, val_h5, dev, data_mesh(world, device=dev))
    if rank:
        return None
    to_cpu = lambda v: v.cpu() if torch.is_tensor(v) else v  # noqa: E731
    return dataclasses.replace(
        state, params_g=tree_map(to_cpu, state.params_g),
        params_f=tree_map(to_cpu, state.params_f),
        opt_state_g=tree_map(to_cpu, state.opt_state_g),
        opt_state_f=tree_map(to_cpu, state.opt_state_f))


def _run(cfg, train_h5, val_h5, dev, mesh):
    """The loop on `dev`: alone (`mesh` None), or as this process's rank of
    the mesh's 'data' axis."""
    rank, world = ((mesh.axis_index("data"), mesh.axis_size("data"))
                   if mesh is not None else (0, 1))
    writer = rank == 0
    if cfg.batch_size % world:
        raise ValueError(f"global batch_size {cfg.batch_size} must divide "
                         f"evenly over {world} ranks")
    local_bs = cfg.batch_size // world
    mine = range(rank * local_bs, (rank + 1) * local_bs)
    run_dir = os.path.join(cfg.ckpt_dir, cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    if writer:
        cfg.save(os.path.join(run_dir, "train_opt.json"))
        if mesh is not None:
            print(f"Data-parallel over {world} ranks, global batch "
                  f"{cfg.batch_size}")

    if train_h5 is None:
        train_h5 = os.path.join(cfg.dataroot, "train_data.hdf5")
    if val_h5 is None:
        val_h5 = os.path.join(cfg.dataroot, "val_data.hdf5")
    train_ds = H5TwoViewDataset(train_h5, cfg, train=True)
    val_ds = (H5TwoViewDataset(val_h5, cfg, train=False)
              if not isinstance(val_h5, (str, os.PathLike))
              or os.path.exists(val_h5)
              else None)
    if cfg.lr_policy == "plateau" and val_ds is None:
        raise ValueError(
            "lr_policy='plateau' steps on the validation loss but no val "
            f"dataset exists at {val_h5}; provide val_data.hdf5 or pick "
            "another lr_policy")

    steps_per_epoch = max(len(train_ds) // cfg.batch_size, 1)
    plan, taps, state, step = build_all(cfg, steps_per_epoch, device=dev,
                                        mesh=mesh)

    # resume / warm start (continue_train > pretrained_name >
    # pretrained_G_only_ckpt; `base_model.py:119-143` of the reference)
    state_path = os.path.join(run_dir, "latest_train_state.npz")
    total_iters = 0
    best_val = float("inf")
    g_ckpt, f_ckpt, resume_path = resolve_warm_start(
        run_dir, continue_train=cfg.continue_train,
        pretrained_name=cfg.pretrained_name,
        pretrained_g_only_ckpt=cfg.pretrained_G_only_ckpt,
        ckpt_root=cfg.ckpt_dir)
    if resume_path:
        # the port's train states always carry lr_scale: the JAX package's
        # migration of its pre-lr_scale files has no counterpart here
        state = load_train_state(resume_path, device=dev, jax_layout=dict(
            plan=plan, like=state, grad_accum=cfg.grad_accum_iters,
            frozen_layers=frozen_layers(cfg, plan, taps)))
        total_iters = state.step
        bv_path = os.path.join(run_dir, "best_val_loss.txt")
        if os.path.exists(bv_path):
            with open(bv_path) as f:
                best_val = float(f.read().strip())
        print(f"Resumed at iter {total_iters} (best val {best_val})")
    else:
        if g_ckpt and os.path.exists(g_ckpt):
            print(f"Warm-starting G from {g_ckpt}")
            loaded = params_g_from_checkpoint(plan, load_pytree(g_ckpt))
            state = dataclasses.replace(
                state, params_g=(
                    load_partial(plan, state.params_g, loaded)
                    if isinstance(plan, UnetPlan)
                    else {k: v.to(dev) for k, v in loaded.items()}))
        if f_ckpt and os.path.exists(f_ckpt):
            print(f"Warm-starting F from {f_ckpt}")
            state = dataclasses.replace(state, params_f=tree_map(
                lambda v: torch.from_numpy(np.array(v, np.float32)).to(dev),
                load_pytree(f_ckpt)))

    # plateau: host-side ReduceLROnPlateau scaling the schedule through
    # state.lr_scale, stepped on the val loss at the eval cadence
    plateau = None
    plateau_path = os.path.join(run_dir, "plateau_state.json")
    if cfg.lr_policy == "plateau":
        plateau = PlateauState(lr=cfg.lr)
        if resume_path and os.path.exists(plateau_path):
            with open(plateau_path) as f:
                plateau = PlateauState(**json.load(f))
            state = dataclasses.replace(state, lr_scale=plateau.lr / cfg.lr)

    logger = (ScalarLogger(run_dir, purge_step=total_iters or None)
              if writer else None)
    # numpy draws as in the JAX package (epoch orders, val and view picks);
    # the prefetch worker reads from its own child generator
    rng_np = np.random.default_rng(cfg.seed + total_iters)
    rng_data = rng_np.spawn(1)[0]
    # torch generators in place of JAX's fold_in(PRNGKey(seed), iter): the
    # augment's (CPU, with its device fields) for the worker thread alone,
    # the patch sampler's (device) for the main thread
    aug_seed, field_seed, sample_seed = _seeds(cfg.seed, total_iters, 3)
    pipeline = BatchPipeline(train_ds, cfg, rng_data, dev,
                             (aug_seed, field_seed))
    sampler = torch.Generator(device=dev).manual_seed(sample_seed)
    on_card = dev.type == "cuda"

    n_epochs_total = cfg.n_epochs + cfg.n_epochs_decay
    t_data, t_step = 0.0, 0.0
    pool = ThreadPoolExecutor(max_workers=1)

    def batch_futures():
        for epoch in range(n_epochs_total):
            order = rng_np.permutation(len(train_ds))
            for start in range(0, steps_per_epoch * cfg.batch_size,
                               cfg.batch_size):
                yield epoch, pool.submit(
                    pipeline, order[start:start + cfg.batch_size], mine)

    try:
        it = batch_futures()
        pending = next(it, None)
        while pending is not None:
            epoch, fut = pending
            t0 = time.perf_counter()
            with annotate("loop/wait_batch"):
                views, segs = fut.result()
                pipeline.ready(views, segs)
            pending = next(it, None)  # queue the next batch at once
            dt_data = time.perf_counter() - t0
            t_data = 0.9 * t_data + 0.1 * dt_data

            t0 = time.perf_counter()
            if on_card:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            with annotate("loop/step"):
                state, metrics = step(state, views, segs, sampler)
            if on_card:
                ev1.record()
                # host wall time is what the loop pays: wait for the step
                # (not for the prefetch on its own stream)
                torch.cuda.current_stream(dev).synchronize()
            dt_step = time.perf_counter() - t0
            t_step = 0.9 * t_step + 0.1 * dt_step
            total_iters += 1

            if writer and total_iters % cfg.print_freq == 0:
                scalars = {f"loss/{k}": float(v) for k, v in metrics.items()
                           if k.startswith("nce_") or k == "loss"}
                scalars["metrics/grad_norm_G"] = float(metrics["grad_norm_G"])
                scalars["metrics/grad_norm_F"] = float(metrics["grad_norm_F"])
                scalars["time/data"] = dt_data
                scalars["time/step"] = dt_step
                if on_card:
                    scalars["time/step_device_ms"] = ev0.elapsed_time(ev1)
                logger.log(total_iters, scalars)
                logger.log_text(
                    f"(epoch: {epoch}, iters: {total_iters}, "
                    f"data: {t_data:.3f}s, step: {t_step:.3f}s) "
                    f"loss: {float(metrics['loss']):.4f}")

            if (writer and cfg.display_freq
                    and total_iters % cfg.display_freq == 0):
                # mid-slice panels of the live batch (`trainers/train.py:
                # 256-258` of the reference)
                def _mid(v):
                    return v[v.shape[0] // 2][None].float().cpu().numpy()

                log_panels(logger, "train/visuals", {
                    "view1": _mid(views[0, 0]), "view2": _mid(views[0, 1]),
                    "seg": _mid(segs[0])}, total_iters)

            if writer and total_iters % cfg.save_latest_freq == 0:
                # volume dumps of the live batch (`trainers/train.py:302-309`;
                # rank 0 holds the global batch's first items)
                vis_dir = os.path.join(run_dir, "visuals")
                save_tensor(views[0, 0].half(),
                            os.path.join(vis_dir, "latest_view1.nii.gz"))
                save_tensor(views[0, 1].half(),
                            os.path.join(vis_dir, "latest_view2.nii.gz"))
                save_tensor(segs[0],
                            os.path.join(vis_dir, "latest_seg.nii.gz"))
                save_train_state(state_path, state)
                save_pytree(os.path.join(run_dir, "latest_net_G.npz"),
                            state.params_g)
                save_pytree(os.path.join(run_dir, "latest_net_F.npz"),
                            state.params_f)

            if total_iters % cfg.evaluation_freq == 0:
                if writer:
                    save_pytree(
                        os.path.join(run_dir, f"{total_iters}_net_G.npz"),
                        state.params_g)
                    save_train_state(state_path, state)
                # validation, and the plateau scale it drives, on every rank
                # on the same inputs: the states stay replicas
                if val_ds is not None:
                    val_loss = compute_val_loss(
                        plan, cfg, taps, state, val_ds, rng_np,
                        cfg.n_val_during_train, device=dev)
                    if writer:
                        logger.log(total_iters, {"loss/val": val_loss})
                    if plateau is not None:
                        new_lr = plateau.step(val_loss)
                        state = dataclasses.replace(
                            state, lr_scale=new_lr / cfg.lr)
                        if writer:
                            with open(plateau_path, "w") as f:
                                json.dump(dataclasses.asdict(plateau), f)
                            logger.log(total_iters, {"lr": new_lr})
                    if val_loss < best_val:
                        best_val = val_loss
                        if writer:
                            save_pytree(
                                os.path.join(run_dir, "best_val_net_G.npz"),
                                state.params_g)
                            with open(os.path.join(run_dir,
                                                   "best_val_loss.txt"),
                                      "w") as f:
                                f.write(str(best_val))

            if cfg.max_iters and total_iters >= cfg.max_iters:
                break
    finally:
        # a batch still being prepared finishes before the run returns
        pool.shutdown(wait=True, cancel_futures=True)

    if writer:
        save_train_state(state_path, state)
        save_pytree(os.path.join(run_dir, "latest_net_G.npz"), state.params_g)
        save_pytree(os.path.join(run_dir, "latest_net_F.npz"), state.params_f)
        logger.close()
    train_ds.close()
    if val_ds is not None:
        val_ds.close()
    return state


def build_parser():
    p = argparse.ArgumentParser(description="anatomix contrastive pretraining")
    defaults = PretrainConfig()
    for field in dataclasses.fields(PretrainConfig):
        name = f"--{field.name}"
        default = getattr(defaults, field.name)
        if isinstance(default, bool):
            p.add_argument(name, type=lambda s: s.lower() in
                           ("1", "true", "yes"), default=default)
        elif field.name == "nce_layers":
            p.add_argument(name, type=str, default="27,31,38,45,52,65")
        elif field.name == "nce_weights":
            p.add_argument(name, type=str, default="1")
        else:
            p.add_argument(name, type=type(default) if default is not None
                           else str, default=default)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    return p


def config_from_args(args) -> PretrainConfig:
    kw = vars(args).copy()
    kw.pop("device", None)
    kw["nce_layers"] = tuple(int(i) for i in str(kw["nce_layers"]).split(","))
    if str(kw["nce_weights"]) == "1":
        kw["nce_weights"] = None
    else:
        w = [float(i) for i in str(kw["nce_weights"]).split(",")]
        total = sum(w)
        kw["nce_weights"] = tuple(i / total for i in w)
    return PretrainConfig(**kw)


if __name__ == "__main__":
    _args = build_parser().parse_args()
    train(config_from_args(_args), device=_args.device)
