"""Inference forward of the anatomix UNets on the port's kernels.

Counterpart of the JAX package's `models/unet_fused.py`, without its TPU
block layout: activations stay channels-last `(B, D, H, W, C)` bf16
throughout. Weights are packed once (`prepack_fused`). Every conv goes to a
kernel of `kernels/conv.py` and keeps its bias. The exit conv stores f32.

- Batch norm is folded into the convs first (`extract.fold_batchnorm`);
  the activation that follows a conv then runs in the conv's epilogue.
- Instance norm stays live (the `anatomix-dev` UNet). Its conv keeps
  `act="none"`; the statistics are torch reductions
  (`ops/norms.instance_norm_stats`, global or per spatial tile) and the
  `norm_apply_ndhwc` kernel applies them together with the following
  activation, as `_following_act` routes it in the JAX package.
  The norm divides each channel by its std, which would magnify the bf16
  rounding of a conv output whose mean is large against its std, so a
  conv that feeds a live norm stores f32. On a smooth volume the std is
  small against the values a bf16 rounding of the convs' operands is
  relative to as well (the 94M forward read 3.6e-2 from the f32 path on a
  smooth field, the plain path in bf16 4.1e-2; PERF.md, P1), so in bf16
  such a model carries every activation as the three-term split of
  `ops/conv.split3` ([hi | lo | hi], 3 C bf16 channels, about 2^-16 of the
  f32 value): the norm-apply and upsample kernels store it, the convs read
  it against weights packed [w_hi; w_hi; w_lo] per operand, pooling runs
  on hi + lo, and the entry conv reads the split f32 volume.
- A nearest decoder conv goes to the up-concat kernel, so neither the 2x
  tensor nor the concat is materialized. A trilinear decoder step runs the
  `upsample2x_trilinear_ndhwc` kernel and then the two-operand conv
  `conv3x3x3_cat_ndhwc` on `(enc, up)`, so the concat is not materialized.
- Pooling is plain PyTorch glue, as it is XLA in the JAX package.

On CPU tensors the kernel wrappers run their plain versions, so the same
forward with `compute_dtype=torch.float32` is the f32 CPU reference of the
kernel path.
"""

from __future__ import annotations

from typing import Any

import torch

from anatomix_tpu_torch.kernels.conv import (
    conv3x3x3_cat_ndhwc,
    conv3x3x3_ndhwc,
    conv3x3x3_upcat_ndhwc,
)
from anatomix_tpu_torch.kernels.norm import norm_apply_ndhwc
from anatomix_tpu_torch.kernels.resize import upsample2x_trilinear_ndhwc
from anatomix_tpu_torch.models.unet import UnetPlan, check_supported
from anatomix_tpu_torch.ops.activations import UNET_LRELU_SLOPE
from anatomix_tpu_torch.ops.conv import (
    merge3,
    pack_conv_weight,
    split3,
    split3_weight,
)
from anatomix_tpu_torch.ops.norms import (
    fold_affine,
    instance_norm_stats,
    tile_maps,
)
from anatomix_tpu_torch.ops.pool import avg_pool, max_pool


def _following_act(plan: UnetPlan, idx: int) -> str:
    """The activation that layer `idx`'s output feeds, skipping folded
    norms ('identity'): it runs in that layer's epilogue. A live norm
    between a conv and its activation takes the activation instead, so the
    conv gets 'none'."""
    cfg = plan.config
    for spec in plan.layers[idx + 1:]:
        if spec.kind == "identity":
            continue
        if spec.kind == "act":
            return cfg.activation
        if spec.kind == "final_act":
            return cfg.final_act
        break
    return "none"


def prepack_fused(
    plan: UnetPlan,
    state_dict: dict[str, torch.Tensor],
    *,
    device: torch.device | str,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> dict[int, dict[str, Any]]:
    """Pack every conv once: weights `(27 * Ci, Co)` in `compute_dtype`
    (for a live-norm model in bf16, the three-term split of each operand's
    rows, `(27 * 3 Ci, Co)`), bias f32, and the activation its epilogue
    runs; each live instance norm gets its f32 affine (or None) and the
    activation it applies. Batch norms must be folded first."""
    check_supported(plan.config)
    if plan.config.norm == "batch" and any(
            spec.kind == "norm" for spec in plan.layers):
        raise ValueError(
            "prepack_fused needs a BN-folded plan (extract.fold_batchnorm)"
        )
    live = plan.config.norm in ("instance", "instance_affine")
    split = live and compute_dtype == torch.bfloat16
    packed = {}
    # each conv's input operands, by channel count: (feat,) or, after an
    # upsample with a skip connection, (enc, small)
    ch, small_ch, enc_chs, operands = plan.config.input_nc, None, [], {}
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            operands[idx] = (ch,) if small_ch is None else small_ch
            ch, small_ch = spec.out_ch, None
        elif spec.kind == "upsample":
            small_ch = ((enc_chs.pop(), ch)
                        if plan.config.use_skip_connection else (ch,))
        if plan.config.use_skip_connection and idx in plan.encoder_idx:
            enc_chs.append(ch)
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            w = state_dict[f"model.{idx}.weight"].float()
            if split:
                parts = torch.split(w, list(operands[idx]), dim=1)
                w = torch.cat([split3_weight(t) for t in parts], dim=1)
                if idx != plan.conv_indices[-1] and \
                        plan.layers[idx + 1].kind != "norm":
                    raise NotImplementedError(
                        "the split carries a conv's output only through a "
                        "live norm")
            b = state_dict.get(f"model.{idx}.bias")
            if b is None:
                b = torch.zeros(spec.out_ch)
            nxt = plan.layers[idx + 1].kind if idx + 1 < len(plan.layers) \
                else None
            packed[idx] = {
                "w": pack_conv_weight(w).to(device=device,
                                            dtype=compute_dtype)
                .contiguous(),
                "b": b.float().to(device).contiguous(),
                "act": _following_act(plan, idx),
                "f32_out": nxt == "norm",
                "split": split,
            }
        elif spec.kind == "norm":
            affine = {
                k: (state_dict[f"model.{idx}.{n}"].float().to(device)
                    if plan.config.norm == "instance_affine" else None)
                for k, n in (("scale", "weight"), ("bias", "bias"))
            }
            packed[idx] = dict(affine, act=_following_act(plan, idx),
                               split=split)
    return packed


def _instance_norm(feat, p, *, eps, tile_counts, out_dtype):
    """Live instance norm + its activation: torch statistics, then the
    norm-apply kernel (which stores the three-term split under
    `p["split"]`)."""
    tile_counts = tuple(tile_counts or (1, 1, 1))
    mean, var = instance_norm_stats(feat, tile_counts)
    a, s = fold_affine(mean, var, eps, p["scale"], p["bias"])
    maps = tile_maps(feat.shape[1:4], tile_counts, feat.device)
    return norm_apply_ndhwc(feat, a.contiguous(), s.contiguous(), maps,
                            act=p["act"], slope=UNET_LRELU_SLOPE,
                            out_dtype=out_dtype, split=p["split"])


def unet_apply_fused(
    plan: UnetPlan,
    packed: dict[int, dict[str, Any]],
    x: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    in_tile_counts: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """Forward of NDHWC `x` (B, D, H, W, Cin); returns f32 (B, D, H, W, Co).
    Spatial extents must be divisible by 2**num_downs. `in_tile_counts`
    gives live instance norms per-tile statistics (`full_tiled`), split at
    each level from that level's own extent."""
    cfg = plan.config
    last_conv = plan.conv_indices[-1]
    split = packed[plan.conv_indices[0]]["split"]
    feat = (split3(x.float()) if split
            else x.to(compute_dtype).contiguous())
    enc_feats: list[torch.Tensor] = []
    small = enc = None  # operands of the next decoder conv
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            p = packed[idx]
            kw = dict(
                act=p["act"], slope=UNET_LRELU_SLOPE, pad_type=cfg.pad_type,
                out_dtype=(torch.float32 if idx == last_conv or p["f32_out"]
                           else compute_dtype),
            )
            if small is not None and cfg.interp == "nearest":
                feat = conv3x3x3_upcat_ndhwc(enc, small, p["w"], p["b"], **kw)
            elif small is not None and enc is not None:
                feat = conv3x3x3_cat_ndhwc(enc, small, p["w"], p["b"], **kw)
            else:
                feat = conv3x3x3_ndhwc(
                    feat if small is None else small, p["w"], p["b"], **kw)
            small = enc = None
        elif spec.kind == "norm":
            feat = _instance_norm(feat, packed[idx], eps=cfg.norm_eps,
                                  tile_counts=in_tile_counts,
                                  out_dtype=compute_dtype)
        elif spec.kind == "pool":
            pool = max_pool if cfg.pooling == "Max" else avg_pool
            feat = (split3(pool(merge3(feat), 2)) if split
                    else pool(feat, 2))
        elif spec.kind == "upsample":
            # nearest: the up-concat conv reads the small tensor itself;
            # trilinear: the upsampled tensor feeds the two-operand conv
            small = (feat if cfg.interp == "nearest"
                     else upsample2x_trilinear_ndhwc(feat, split=split))
            enc = enc_feats.pop() if cfg.use_skip_connection else None
            feat = None
        # 'act' / 'final_act' ran in a conv epilogue or a norm-apply pass;
        # 'identity' is a folded norm
        if cfg.use_skip_connection and idx in plan.encoder_idx:
            enc_feats.append(feat)
    return feat
