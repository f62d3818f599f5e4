"""Entry point of the pretraining step: `build_all` (the port of
`anatomix_tpu/pretraining/train.py` build_all).

The trainer loop, its CLI and the H5 dataset are not ported yet (ROADMAP
Queue 1 item 17); `build_all` gives what the loop calls once per batch, for
the UNet (`netG="unet"`) or the Primus ViT (`netG="primus"`):

    plan, taps, state, step = build_all(cfg, steps_per_epoch)
    state, metrics = step(state, views, segs, generator)

with `views` (B, 2, D, H, W, 1) f32, `segs` (B, D, H, W, 1) int and a
`torch.Generator` on the device for the patch sampler.
"""

from __future__ import annotations

import torch

from anatomix_tpu_torch.device import resolve_device
from anatomix_tpu_torch.models.unet import (
    UnetConfig,
    build_plan,
    check_supported,
)
from anatomix_tpu_torch.models.unet_train_block import train_block_eligible
from anatomix_tpu_torch.models.vit3d.primus import PrimusConfig
from anatomix_tpu_torch.models.vit3d.primus import \
    check_supported as check_primus_supported
from anatomix_tpu_torch.pretraining.config import PretrainConfig
from anatomix_tpu_torch.pretraining.schedulers import make_schedule
from anatomix_tpu_torch.pretraining.train_step import (
    build_train_step,
    frozen_layer_ids,
    init_train_state,
)


def build_all(cfg: PretrainConfig, steps_per_epoch: int, *,
              device: str | torch.device = "cuda"):
    """The backbone's plan (a UNet plan, or for `netG="primus"` the
    `PrimusConfig` the JAX package builds), its tap layers, a seeded train
    state (`cfg.seed`) on `device` and the train step, at `cfg`'s settings.
    Runs on the card unless `device="cpu"`; raises without a card."""
    dev = resolve_device(device)
    if cfg.netG == "unet":
        plan = build_plan(UnetConfig(
            dimension=cfg.ndims, input_nc=cfg.input_nc,
            output_nc=cfg.output_nc, num_downs=cfg.num_downs, ngf=cfg.ngf,
            norm=cfg.normG, activation=cfg.actG, pooling=cfg.pool_type,
            interp=cfg.interp_type, norm_eps=cfg.norm_eps_G,
        ))
        check_supported(plan.config)
        if not train_block_eligible(plan):
            raise NotImplementedError(
                "the port's pretraining step covers batch norm, Max pool, "
                "nearest upsampling and reflect padding")
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
    frozen = ()
    if cfg.unfreeze_layers and cfg.netG == "unet":
        frozen = frozen_layer_ids(
            plan, [int(i) for i in cfg.unfreeze_layers.split(",")], taps)
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
        compute_dtype=torch.bfloat16, frozen_layers=frozen,
        use_fg_mask=cfg.load_mask,
    )
    return plan, taps, state, step
