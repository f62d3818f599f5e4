"""Train-mode UNet forward of the pretraining step, on channels-last volumes.

The counterpart of the JAX package's block-space walk
(`anatomix_tpu/models/unet_train_block.py`): the same layers and the same
results, `(out, taps, new_stats)`, with batch norm on the batch's
statistics. The port's convs read channels-last tensors, so the walk stays
channels-last and enters the block layout where the JAX walk leaves or
enters it around a resolution change: the max pool is
`kernels/reshuffle.space_to_depth2` then a max over the 8 channel groups
(`ops/pool.max_pool_block`), whose gradient goes to the first maximum of
each window in (d, h, w) scan order, torch's rule, which the JAX walk
copies; the nearest upsample is a channel tile then `depth_to_space2`.
The two permutation kernels run forward and, each as the other's adjoint,
backward. Each conv is `kernels/conv_train.conv3x3x3_train` (forward on
K1, gradients on the dgrad and wgrad kernels), then batch norm in f32
(`ops/norms.batch_norm_train`) and the activation (PReLU with its one
weight shared by every act slot). The decoder
materializes `cat(enc, nearest2x(small))` as the JAX train walk does, so
every decoder conv is a single-operand conv whose saved input is what the
wgrad kernel reads.

`plain=True` runs the same walk in f32 with `F.conv3d` under autograd,
torch's max pool and nearest upsample (the port's reference path on the
card).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from anatomix_tpu_torch.kernels.conv_train import conv3x3x3_train
from anatomix_tpu_torch.kernels.reshuffle import (
    depth_to_space2,
    space_to_depth2,
)
from anatomix_tpu_torch.models.unet import UnetPlan, layer_acts
from anatomix_tpu_torch.ops.conv import conv3d_same
from anatomix_tpu_torch.ops.norms import batch_norm_train
from anatomix_tpu_torch.ops.pool import max_pool, max_pool_block
from anatomix_tpu_torch.ops.resize import upsample2x


def train_block_eligible(plan: UnetPlan) -> bool:
    """The pretraining backbone family the train walk covers (the JAX
    package's `train_block_eligible`): 3-D, batch norm, Max pool, nearest
    x2 decoders, reflect padding, skip connections, no residuals, fewer than
    16 input channels; any activation."""
    cfg = plan.config
    return (
        cfg.dimension == 3
        and cfg.norm == "batch"
        and cfg.pooling == "Max"
        and cfg.interp == "nearest"
        and cfg.pad_type == "reflect"
        and not cfg.residual_connection
        and cfg.use_skip_connection
        and cfg.input_nc < 16
    )


def unet_apply_train_block(
    plan: UnetPlan,
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    *,
    layers: Sequence[int],
    eval_norm_layers: Sequence[int] = (),
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
    bn_group=None,
):
    """Train-mode forward of NDHWC `x` (even extents) with the reference-keyed
    parameters `params` (`model.<idx>.weight`, ...).

    Returns `(out, taps, new_stats)`: the output, the activations at
    `layers` (channels-last, in `compute_dtype`) and
    `new_stats[str(idx)] = (running_mean, running_var)` updated for every
    batch norm not in `eval_norm_layers` (those use their running stats).
    With `bn_group` (data parallelism) the batch norms take the statistics
    of the batch the group's ranks hold together (`ops/norms.
    batch_norm_train`).
    """
    cfg = plan.config
    if not train_block_eligible(plan):
        raise ValueError("plan outside the train walk's domain")
    cd = torch.float32 if plain else compute_dtype
    layers = tuple(layers or ())
    eval_norm_layers = frozenset(eval_norm_layers)
    act, final_act = layer_acts(plan, params)
    feat = x.to(cd).contiguous()
    enc_feats: list[torch.Tensor] = []
    taps: list[torch.Tensor] = []
    new_stats: dict[str, tuple] = {}
    for idx, spec in enumerate(plan.layers):
        base = f"model.{idx}"
        if spec.kind == "conv":
            w = params[f"{base}.weight"]
            b = params.get(f"{base}.bias")
            if plain:
                feat = conv3d_same(feat, w, b, pad_type=cfg.pad_type)
            else:
                feat = conv3x3x3_train(feat, w, b, cfg.pad_type)
        elif spec.kind == "norm":
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
        elif spec.kind == "act":
            feat = act(feat)
        elif spec.kind == "final_act":
            feat = final_act(feat)
        elif spec.kind == "pool":
            if plain:
                feat = max_pool(feat, 2)
            else:
                feat = max_pool_block(space_to_depth2(feat))
        elif spec.kind == "upsample":
            if plain:
                feat = upsample2x(feat, "nearest")
            else:
                # nearest x2 is each voxel's channels once per sub-position
                feat = depth_to_space2(feat.repeat(1, 1, 1, 1, 8))
        if idx in plan.decoder_idx:
            # the reference concatenates (encoder, decoder) on channels
            feat = torch.cat([enc_feats.pop(), feat], dim=-1)
        if idx in plan.encoder_idx:
            enc_feats.append(feat)
        if idx in layers:
            taps.append(feat)
    return feat, taps, new_stats
