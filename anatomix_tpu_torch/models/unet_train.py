"""Train-mode forward of every UNet the port runs, on channels-last volumes:
the general spatial walk.

The counterpart of the JAX package's `unet_apply(train=True,
conv_impl="pallas_train")` (`anatomix_tpu/models/unet.py`): the same layers
and the same results, `(out, taps, new_stats)`, for batch norm (the
batch's statistics, the running stats updated), instance norm and
`instance_affine` (the JAX package's one-pass f32 statistics,
`ops/norms.tiled_instance_norm`), Max or Avg pool, nearest or trilinear x2
upsampling, reflect, zeros, replicate or circular padding, with or without
skip connections and residual connections, every activation (PReLU's
weight one leaf shared by every act slot, as JAX's `params["prelu"]["w"]`,
so its gradient sums over the slots), and 1-D and 2-D nets lifted to 3-D
(their kernels' zero taps on the lifted axes, which pad with zeros).
The pretraining step and segmentation finetuning take it for every UNet
outside `train_block_eligible` (the 6M family keeps the block walk of
`models/unet_train_block.py`), among them the 94M `anatomix-dev` UNet
(instance norm eps 1e-2, Avg pool, trilinear).

Every conv is `kernels/conv_train.conv3x3x3_train`: forward on K1, input
gradient on the dgrad kernel (with the reflect shell pass), weight
gradient on the wgrad kernel; that includes the entry conv and the convs
whose widths the JAX walk leaves to XLA. Under a live instance norm in
bf16 every conv reads its f32 input and weights through the three-term
split (`ops/conv.split3`, about 2^-16 of the f32 product) and stores f32,
as the inference path does (`models/unet_fused.py`): the norm divides by
each channel's std, which would magnify a bf16 rounding of a smooth
volume. The backward runs on the bf16 roundings of x and w. Otherwise the
convs read and store `compute_dtype`. The decoder materializes
`cat(enc, up(small))`, as the JAX walk does, so every conv has one operand
and its saved input is what the wgrad kernel reads. Norms, pools,
upsampling, activations and the residual adds are torch autograd glue
(XLA ops in the JAX walk).

`plain=True` runs the same walk in f32 with `F.conv3d` under autograd (the
port's reference path on the card).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from anatomix_tpu_torch.kernels.conv_train import conv3x3x3_train
from anatomix_tpu_torch.models.unet import (
    UnetPlan,
    check_supported,
    deflate,
    kernel_pad,
    layer_acts,
    lift_input,
    pool_window,
)
from anatomix_tpu_torch.models.unet_train_block import (
    train_block_eligible,
    unet_apply_train_block,
)
from anatomix_tpu_torch.ops.conv import conv3d_same, full_kernel, lift_weight
from anatomix_tpu_torch.ops.norms import batch_norm_train, instance_norm
from anatomix_tpu_torch.ops.pool import avg_pool, max_pool
from anatomix_tpu_torch.ops.resize import upsample2x


def uses_split(plan: UnetPlan, compute_dtype: torch.dtype) -> bool:
    """Whether the walk's convs read the three-term split: a live instance
    norm with bf16 compute."""
    return (plan.config.norm in ("instance", "instance_affine")
            and compute_dtype == torch.bfloat16)


def unet_apply_train(
    plan: UnetPlan,
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    *,
    layers: Sequence[int] = (),
    eval_norm_layers: Sequence[int] = (),
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
    bn_group=None,
):
    """Train-mode forward of NDHWC `x` with the reference-keyed parameters
    `params` (`model.<idx>.weight`, `.bias`, ...).

    Returns `(out, taps, new_stats)`: the output, the activations at
    `layers` (channels-last; f32 under the split, else `compute_dtype`)
    and `new_stats[str(idx)] = (running_mean, running_var)` updated for
    every batch norm not in `eval_norm_layers` (those use their running
    stats). Instance norms have no running stats and ignore
    `eval_norm_layers`; they stay per sample under data parallelism, where
    `bn_group` gives the batch norms the statistics of the batch the
    group's ranks hold together."""
    cfg = plan.config
    check_supported(cfg)
    cd = torch.float32 if plain else compute_dtype
    split = not plain and uses_split(plan, cd)
    act_dtype = torch.float32 if split else cd
    layers = tuple(layers or ())
    eval_norm_layers = frozenset(eval_norm_layers)
    act, final_act = layer_acts(plan, params)
    pad = kernel_pad(cfg)
    win = pool_window(cfg)
    feat = lift_input(cfg, x).to(act_dtype).contiguous()
    enc_feats: list[torch.Tensor] = []
    taps: list[torch.Tensor] = []
    new_stats: dict[str, tuple] = {}
    res = None
    for idx, spec in enumerate(plan.layers):
        base = f"model.{idx}"
        if spec.kind == "conv":
            w = lift_weight(params[f"{base}.weight"])
            b = params.get(f"{base}.bias")
            if plain:
                feat = conv3d_same(feat, w, b, pad_type=cfg.pad_type)
            else:
                feat = conv3x3x3_train(feat.contiguous(), full_kernel(w), b,
                                       pad, out_dtype=act_dtype, split=split)
        elif spec.kind == "norm" and cfg.norm == "batch":
            mean = params[f"{base}.running_mean"]
            var = params[f"{base}.running_var"]
            scale = params[f"{base}.weight"]
            bias = params[f"{base}.bias"]
            if idx in eval_norm_layers:
                inv = torch.rsqrt(var.float() + cfg.norm_eps) * scale.float()
                feat = (feat.float() * inv + (bias.float() - mean.float()
                                              * inv)).to(feat.dtype)
            else:
                feat, m, v = batch_norm_train(
                    feat, mean, var, scale, bias, eps=cfg.norm_eps,
                    group=bn_group)
                new_stats[str(idx)] = (m, v)
        elif spec.kind == "norm":
            feat = instance_norm(feat, eps=cfg.norm_eps,
                                 scale=params.get(f"{base}.weight"),
                                 bias=params.get(f"{base}.bias"))
        elif spec.kind == "act":
            feat = act(feat)
        elif spec.kind == "final_act":
            feat = final_act(feat)
        elif spec.kind == "pool":
            feat = (max_pool if cfg.pooling == "Max" else avg_pool)(feat,
                                                                   win)
        elif spec.kind == "upsample":
            feat = upsample2x(feat, cfg.interp, win)
        if cfg.residual_connection:
            # the block's conv output, added after its norm and act
            if idx in plan.res_source:
                res = feat
            if idx in plan.res_dest:
                feat = feat + 0.1 * res
        if cfg.use_skip_connection:
            if idx in plan.decoder_idx:
                # the reference concatenates (encoder, decoder) on channels
                feat = torch.cat([enc_feats.pop(), feat], dim=-1)
            if idx in plan.encoder_idx:
                enc_feats.append(feat)
        if idx in layers:
            taps.append(deflate(cfg, feat))
    return deflate(cfg, feat), taps, new_stats


def unet_train_forward(plan, params, x, *, layers=(), eval_norm_layers=(),
                       compute_dtype=torch.bfloat16, plain=False,
                       bn_group=None):
    """The train walk for `plan`, as the JAX package dispatches it: the 6M
    family's block walk where `train_block_eligible` holds, the general
    walk (`unet_apply_train`) for every other UNet. Returns `(out, taps,
    new_stats)`."""
    walk = (unet_apply_train_block if train_block_eligible(plan)
            else unet_apply_train)
    return walk(plan, params, x, layers=layers,
                eval_norm_layers=eval_norm_layers,
                compute_dtype=compute_dtype, plain=plain, bn_group=bn_group)
