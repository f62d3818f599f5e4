"""Few-shot segmentation finetuning: the train step, sliding-window
validation, the epoch loop and its CLI (the port of
`anatomix_tpu/segmentation/train.py`, the reference's
`train_segmentation.py`).

    python -m anatomix_tpu_torch.segmentation.train --exp_name E \
        --dataset D --n_classes N --pretrained_ckpt anatomix.pth \
        [--device cpu] [--n_epochs 500] ...

D holds imagesTr/labelsTr/imagesVal/labelsVal (`*.nii.gz`). The run writes
`finetuning_runs/checkpoints/E/best_dict_epoch*.npz` and `epoch*.npz`
(`utils/checkpoint.save_pytree`) and `finetuning_runs/runs/E/` scalars
(`utils/logging.ScalarLogger`) under the working directory, as the JAX
package does.

The step: the train-mode forward (`model.seg_forward(train=True)`: the
backbone's train walk on the kernels in bf16 on the card, f32 plain path on
the CPU), DiceCE, autograd, `torch.optim.Adam` (lr on the per-epoch cosine
schedule, evaluated at the update count before the step as optax does,
weight decay 0) on the trainable leaves, then the batch-norm running stats
replaced by the step's `new_stats`; the running stats are buffers the
optimizer never sees. Validation: Dice loss of sliding-window logits (crop^3
windows, overlap 0.7, sw_batch 4, constant blend) from a predictor built
from the parameters at that call (`model.make_seg_predictor`: batch norm
folded and the convs packed anew). `record_function` ranges: `seg/data`,
`seg/step` (`seg/forward`, `seg/backward`, `seg/optimizer` inside),
`seg/val`.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from anatomix_tpu_torch.device import resolve_device
from anatomix_tpu_torch.ops.sliding_window import sliding_window_inference
from anatomix_tpu_torch.segmentation.data import VolumeCache, data_handler
from anatomix_tpu_torch.segmentation.losses import dice_ce_loss, dice_loss
from anatomix_tpu_torch.segmentation.model import (
    check_trainable,
    load_seg_model,
    make_seg_predictor,
    seg_forward,
)
from anatomix_tpu_torch.segmentation.transforms import (
    train_transform,
    val_transform,
)
from anatomix_tpu_torch.utils.checkpoint import save_pytree
from anatomix_tpu_torch.utils.logging import ScalarLogger
from anatomix_tpu_torch.utils.profiling import annotate

_STATS = ("running_mean", "running_var")


def cosine_annealing(lr0: float, n_epochs: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """torch's `CosineAnnealingLR(T_max=n_epochs)` stepped per epoch, as a
    function of the update count: lr0 (1 + cos(pi e / n_epochs)) / 2 with
    e = count // steps_per_epoch."""

    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        return lr0 * (1.0 + math.cos(math.pi * epoch / n_epochs)) / 2.0

    return schedule


def trainable_leaves(params: dict[str, Any]) -> list[tuple[str, torch.Tensor]]:
    """`(name, tensor)` of every leaf Adam updates, in a fixed order: the
    backbone's weights and batch-norm scales and biases, then the head."""
    out = [(f"backbone/{k}", v) for k, v in sorted(params["backbone"].items())
           if not k.endswith(_STATS)]
    return out + [(f"head/{k}", v) for k, v in sorted(params["head"].items())]


def make_seg_optimizer(params: dict[str, Any],
                       lr: float = 2e-4) -> torch.optim.Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8, no weight decay) over
    `trainable_leaves(params)`, which it marks `requires_grad`."""
    leaves = [v.requires_grad_() for _, v in trainable_leaves(params)]
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def adam_count(optimizer: torch.optim.Adam) -> int:
    """Updates the optimizer has taken (0 before the first)."""
    state = optimizer.state.get(optimizer.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


def adam_state(optimizer: torch.optim.Adam,
               params: dict[str, Any]) -> dict[str, Any]:
    """The optimizer's moments in optax's `ScaleByAdamState` layout:
    {"count", "mu", "nu"}, the moments keyed by `trainable_leaves` names
    (zeros before the first update)."""
    mu, nu = {}, {}
    for name, p in trainable_leaves(params):
        st = optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p)).detach()
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p)).detach()
    return {"count": adam_count(optimizer), "mu": mu, "nu": nu}


def seg_loss(plan, params, images, labels, *, compute_dtype=None,
             plain=None):
    """`(DiceCE loss, new_stats)` of the train-mode forward."""
    logits, new_stats = seg_forward(plan, params, images, train=True,
                                    compute_dtype=compute_dtype, plain=plain)
    return dice_ce_loss(logits, labels), new_stats


def build_seg_train_step(plan, optimizer: torch.optim.Adam,
                         schedule: Callable[[int], float] | None = None, *,
                         compute_dtype: torch.dtype | None = None,
                         plain: bool | None = None):
    """`step(params, images (B, D, H, W, 1), labels (B, D, H, W)) -> loss`
    (a 0-d tensor): one update of `params` in place by `optimizer` (made by
    `make_seg_optimizer` on these parameters), at `schedule(count)` when a
    schedule is given; the running stats are then replaced by the step's.
    Raises for a backbone the train walks do not cover
    (`model.check_trainable`)."""
    check_trainable(plan)

    def step(params, images, labels):
        dev = params["head"]["weight"].device
        images = torch.as_tensor(images, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        with annotate("seg/forward"):
            loss, new_stats = seg_loss(plan, params, images, labels,
                                       compute_dtype=compute_dtype,
                                       plain=plain)
        optimizer.zero_grad(set_to_none=True)
        with annotate("seg/backward"):
            loss.backward()
        if schedule is not None:
            lr = schedule(adam_count(optimizer))
            for group in optimizer.param_groups:
                group["lr"] = lr
        with annotate("seg/optimizer"):
            optimizer.step()
        backbone = params["backbone"]
        for idx, (mean, var) in new_stats.items():
            backbone[f"model.{idx}.running_mean"] = mean
            backbone[f"model.{idx}.running_var"] = var
        return loss.detach()

    return step


def load_batch(cache: VolumeCache, images: Sequence[str],
               labels: Sequence[str], idxs, crop_size: int,
               gen: torch.Generator,
               field_gen: torch.Generator | None = None):
    """The training batch of samples `idxs`: each volume from `cache`,
    transformed on its device (`train_transform`). Returns images
    (B, c, c, c, 1) f32 and labels (B, c, c, c) int64, c = `crop_size`."""
    imgs, labs = [], []
    for i in idxs:
        im, lb = train_transform(gen, cache.get(images[i]),
                                 cache.get(labels[i]), crop_size, field_gen)
        imgs.append(im)
        labs.append(lb)
    return torch.stack(imgs)[..., None], torch.stack(labs).long()


def validate(plan, params, val_images, val_labels, cache, crop_size,
             n_classes, compute_dtype=None, plain=None):
    """Mean Dice loss over the validation volumes of sliding-window logits
    (`train_segmentation.py:183-224` of the reference)."""
    predict = make_seg_predictor(plan, params, compute_dtype=compute_dtype,
                                 plain=plain)
    losses = []
    for img_path, seg_path in zip(val_images, val_labels):
        img = val_transform(cache.get(img_path))
        logits = sliding_window_inference(
            img[None, ..., None], predict, n_classes + 1,
            roi_size=(crop_size,) * 3, sw_batch_size=4, overlap=0.7,
            mode="constant",
        )
        losses.append(float(dice_loss(logits, cache.get(seg_path)[None])))
    return float(np.mean(losses)) if losses else float("nan")


def main(opt):
    dev = resolve_device(opt.device)
    trimages, trsegs, vaimages, vasegs = data_handler(
        opt.dataset, opt.train_amount, opt.n_iters_per_epoch, opt.batch_size,
    )
    print(f"Training cache: {len(trimages)} images {len(trsegs)} segs")
    print(f"Validation set: {len(vaimages)} images {len(vasegs)} segs")
    plan, params = load_seg_model(
        opt.n_classes, ckpt_path=opt.pretrained_ckpt,
        hf_variant=opt.hf_variant, cache_path=opt.cache_path,
        num_downs=opt.num_downs, ngf=opt.ngf, output_nc=opt.output_nc,
        norm=opt.norm, interp=opt.interp, pooling=opt.pooling, device=dev,
    )
    steps_per_epoch = max(len(trimages) // opt.batch_size, 1)
    optimizer = make_seg_optimizer(params, opt.lr)
    train_step = build_seg_train_step(
        plan, optimizer, cosine_annealing(opt.lr, opt.n_epochs,
                                          steps_per_epoch))

    ckpt_dir = os.path.join("finetuning_runs", "checkpoints", opt.exp_name)
    run_dir = os.path.join("finetuning_runs", "runs", opt.exp_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = ScalarLogger(run_dir)
    cache = VolumeCache(dev)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    field_gen = torch.Generator(device=dev).manual_seed(0)
    best_val_loss = float("inf")
    best_loss_epoch = -1
    global_step = 0

    for epoch in range(opt.n_epochs):
        print("-" * 10)
        print(f"epoch {epoch + 1:04d}/{opt.n_epochs:04d}")
        order = rng.permutation(len(trimages))
        epoch_loss, steps = 0.0, 0
        for start in range(0, steps_per_epoch * opt.batch_size,
                           opt.batch_size):
            idxs = order[start: start + opt.batch_size]
            if len(idxs) < opt.batch_size:
                break
            t0 = time.perf_counter()
            with annotate("seg/data"):
                batch_img, batch_lab = load_batch(
                    cache, trimages, trsegs, idxs, opt.crop_size, gen,
                    field_gen)
            t1 = time.perf_counter()
            with annotate("seg/step"):
                loss = float(train_step(params, batch_img, batch_lab))
            t2 = time.perf_counter()
            epoch_loss += loss
            steps += 1
            global_step += 1
            logger.log(global_step, {"train_loss": loss,
                                     "time/data": t1 - t0,
                                     "time/step": t2 - t1})
        epoch_loss /= max(steps, 1)
        print(f"epoch {epoch + 1} average loss: {epoch_loss:.4f}")

        if (epoch + 1) % opt.val_interval == 0:
            # mid-slice panels (the reference's plot_2d_or_3d_image role)
            from anatomix_tpu_torch.utils.visualization import log_panels

            preds = seg_forward(plan, params, batch_img).argmax(-1).float()
            log_panels(logger, "train/panels", {
                "image": batch_img[0, ..., 0],
                "label": batch_lab[0].float() / (opt.n_classes + 1.0),
                "output": preds[0] / (opt.n_classes + 1.0),
            }, epoch + 1)
            with annotate("seg/val"):
                val_loss = validate(plan, params, vaimages, vasegs, cache,
                                    opt.crop_size, opt.n_classes)
            logger.log(epoch + 1, {"val_loss_mean_dice": val_loss})
            if val_loss < best_val_loss:
                best_val_loss = val_loss
                best_loss_epoch = epoch + 1
                save_pytree(os.path.join(
                    ckpt_dir, f"best_dict_epoch{epoch + 1:04d}.npz"), params)
                print("saved new best loss model")
            print(
                f"current epoch: {epoch + 1} current mean dice: "
                f"{val_loss:.4f} best mean dice: {best_val_loss:.4f} "
                f"at epoch {best_loss_epoch}"
            )
            save_pytree(
                os.path.join(ckpt_dir, f"epoch{epoch + 1:04d}.npz"),
                {"params": params, "opt_state": adam_state(optimizer, params),
                 "epoch": np.asarray(epoch + 1)},
            )
    logger.close()
    return params


def build_parser():
    p = argparse.ArgumentParser(description="Few-shot segmentation finetune")
    p.add_argument("--exp_name", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True,
                   help="dir with imagesTr/labelsTr/imagesVal/labelsVal")
    p.add_argument("--n_classes", type=int, required=True,
                   help="number of foreground classes")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--pretrained_ckpt", type=str, default=None,
                     help=".pth/.npz checkpoint or 'scratch'")
    src.add_argument("--hf_variant", type=str, default=None)
    p.add_argument("--cache_path", type=str, default=None,
                   help="local .pth/.npz of --hf_variant")
    p.add_argument("--crop_size", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=3)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--n_epochs", type=int, default=500)
    p.add_argument("--val_interval", type=int, default=10)
    p.add_argument("--train_amount", type=int, default=3)
    p.add_argument("--n_iters_per_epoch", type=int, default=75)
    p.add_argument("--num_downs", type=int, default=4)
    p.add_argument("--ngf", type=int, default=16)
    p.add_argument("--output_nc", type=int, default=16)
    p.add_argument("--norm", type=str, default="batch")
    p.add_argument("--interp", type=str, default="nearest")
    p.add_argument("--pooling", type=str, default="Max")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
