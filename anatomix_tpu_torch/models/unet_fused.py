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
  activation, as `_following_act` routes it in the JAX package. The
  statistics and their fold into the affine run in the `record_function`
  range `unet/norm_stats` (opened only while a profiler runs,
  `utils/profiling.annotate`).
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
- Each conv epilogue and norm-apply pass carries its layer's activation
  and slope: LeakyReLU's 0.3, or PReLU as the `lrelu` epilogue with the
  slope read from its weight at pack time (`ops/activations.epilogue`);
  the final activation has its own weight.
- A residual UNet (`feat + 0.1 * conv output` at each block's end) cannot
  fold its batch norms: the residual adds the raw conv output (ROADMAP
  F10). Each residual source conv stores its raw output (f32 where a norm
  follows), and one D1 pass applies the block's norm (the batch norm's
  running affine, the instance norm's statistics, or none), its
  activation and the residual: `act(x a + s) + 0.1 x`.
- A 1-D or 2-D UNet runs lifted to 3-D (leading singleton axes): its
  weights pack as 3x3x3 kernels with zero taps on the lifted axes, which
  pad with zeros (`models/unet.kernel_pad`); pools and upsamples act on
  the real axes. Its decoder materializes the upsample (nearest: a torch
  copy; trilinear: D2 on the lifted volume, whose lifted axes it doubles,
  then their first plane) and runs the two-operand conv, since K3 reads
  its small operand at half resolution on all three axes; the three-fold
  MMAs on a lifted axis's zero taps are item-16 work.

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
from anatomix_tpu_torch.models.unet import (
    UnetPlan,
    check_supported,
    deflate,
    final_prelu_key,
    kernel_pad,
    lift_input,
    pool_window,
    prelu_key,
)
from anatomix_tpu_torch.ops.activations import epilogue
from anatomix_tpu_torch.ops.conv import (
    full_kernel,
    lift_weight,
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
from anatomix_tpu_torch.ops.resize import upsample2x
from anatomix_tpu_torch.utils.profiling import annotate


def _following_act(plan: UnetPlan, idx: int) -> str | None:
    """The activation layer ('act' or 'final_act') that layer `idx`'s
    output feeds, skipping folded norms ('identity'): it runs in that
    layer's epilogue. A live norm between a conv and its activation takes
    the activation instead, so the conv gets None."""
    for spec in plan.layers[idx + 1:]:
        if spec.kind == "identity":
            continue
        if spec.kind in ("act", "final_act"):
            return spec.kind
        break
    return None


def _block_norm(plan: UnetPlan, conv_idx: int) -> int | None:
    """The live norm layer right after conv `conv_idx`, if any."""
    nxt = conv_idx + 1
    if nxt < len(plan.layers) and plan.layers[nxt].kind == "norm":
        return nxt
    return None


def prepack_fused(
    plan: UnetPlan,
    state_dict: dict[str, torch.Tensor],
    *,
    device: torch.device | str,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> dict[int, dict[str, Any]]:
    """Pack every conv once: weights `(27 * Ci, Co)` in `compute_dtype`
    (for a live instance-norm model in bf16, the three-term split of each
    operand's rows, `(27 * 3 Ci, Co)`), bias f32, and the activation and
    slope its epilogue runs; each live norm gets its f32 affine (the batch
    norm's running affine under residuals) and the activation it applies.
    A residual source conv runs no epilogue activation: its entry's
    `block` holds the D1 pass that ends the block. Batch norms must be
    folded first where a fold is exact (`extract.fold_batchnorm`)."""
    cfg = plan.config
    check_supported(cfg)
    residual = cfg.residual_connection
    if cfg.norm == "batch" and not residual and any(
            spec.kind == "norm" for spec in plan.layers):
        raise ValueError(
            "prepack_fused needs a BN-folded plan (extract.fold_batchnorm)"
        )
    live = cfg.norm in ("instance", "instance_affine")
    split = live and compute_dtype == torch.bfloat16
    def following(idx: int) -> tuple[str, float]:
        """(epilogue activation, slope) of the activation layer `idx`
        feeds: PReLU's slope from the shared act weight, or the final
        activation's own."""
        kind = _following_act(plan, idx)
        if kind is None:
            return epilogue("none")
        name = cfg.activation if kind == "act" else cfg.final_act
        key = prelu_key(plan) if kind == "act" else final_prelu_key(plan)
        return epilogue(name, state_dict[key] if name == "prelu" else None)

    packed = {}
    # each conv's input operands, by channel count: (feat,) or, after an
    # upsample with a skip connection, (enc, small)
    ch, small_ch, enc_chs, operands = cfg.input_nc, None, [], {}
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            operands[idx] = (ch,) if small_ch is None else small_ch
            ch, small_ch = spec.out_ch, None
        elif spec.kind == "upsample":
            small_ch = ((enc_chs.pop(), ch)
                        if cfg.use_skip_connection else (ch,))
        if cfg.use_skip_connection and idx in plan.encoder_idx:
            enc_chs.append(ch)
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            w = full_kernel(lift_weight(
                state_dict[f"model.{idx}.weight"].float()))
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
            norm = _block_norm(plan, idx)
            res = residual and idx in plan.res_source
            act, slope = ("none", 0.0) if res else following(idx)
            packed[idx] = {
                "w": pack_conv_weight(w).to(device=device,
                                            dtype=compute_dtype)
                .contiguous(),
                "b": b.float().to(device).contiguous(),
                "act": act, "slope": slope,
                "f32_out": norm is not None,
                "split": split,
            }
            if res:
                packed[idx]["block"] = _pack_block(
                    plan, state_dict, idx, norm, following(
                        norm if norm is not None else idx), split, device)
        elif spec.kind == "norm" and not residual:
            affine = {
                k: (state_dict[f"model.{idx}.{n}"].float().to(device)
                    if cfg.norm == "instance_affine" else None)
                for k, n in (("scale", "weight"), ("bias", "bias"))
            }
            act, slope = following(idx)
            packed[idx] = dict(affine, act=act, slope=slope, split=split)
    return packed


def _pack_block(plan, state_dict, conv_idx, norm, act_slope, split, device):
    """The D1 pass that ends a residual block: its norm's kind and affine
    ((a, s) of a batch norm's running statistics; the instance norm's
    scale and bias), activation, slope and split."""
    cfg = plan.config
    act, slope = act_slope
    out = {"act": act, "slope": slope, "split": split,
           "norm": "none" if norm is None else cfg.norm}
    base = f"model.{norm}"
    if norm is not None and cfg.norm == "batch":
        mean = state_dict[f"{base}.running_mean"].float()
        var = state_dict[f"{base}.running_var"].float()
        a, s = fold_affine(mean, var, cfg.norm_eps,
                           state_dict[f"{base}.weight"].float(),
                           state_dict[f"{base}.bias"].float())
        out.update(a=a.to(device), s=s.to(device))
    elif norm is not None:
        out.update({k: (state_dict[f"{base}.{n}"].float().to(device)
                        if cfg.norm == "instance_affine" else None)
                    for k, n in (("scale", "weight"), ("bias", "bias"))})
    else:
        c = plan.layers[conv_idx].out_ch
        out.update(a=torch.ones(c, device=device),
                   s=torch.zeros(c, device=device))
    return out


def _norm_apply(feat, p, *, eps, tile_counts, out_dtype, post_res=False):
    """A live norm + its activation (+ the block's residual): the affine
    of the batch norm's running statistics, or the instance norm's torch
    statistics (global or per tile), then the norm-apply kernel (which
    stores the three-term split under `p["split"]`)."""
    maps_tiles = (1, 1, 1)
    if "a" in p:
        a = p["a"].reshape(1, 1, 1, 1, -1).expand(
            feat.shape[0], 1, 1, 1, -1)
        s = p["s"].reshape(1, 1, 1, 1, -1).expand_as(a)
    else:
        maps_tiles = tuple(tile_counts or (1, 1, 1))
        with annotate("unet/norm_stats"):
            mean, var = instance_norm_stats(feat, maps_tiles)
            a, s = fold_affine(mean, var, eps, p["scale"], p["bias"])
    maps = tile_maps(feat.shape[1:4], maps_tiles, feat.device)
    return norm_apply_ndhwc(feat, a.contiguous(), s.contiguous(), maps,
                            act=p["act"], slope=p["slope"],
                            out_dtype=out_dtype, split=p["split"],
                            post_res=post_res)


def _upsample_lifted(feat, cfg, split):
    """The decoder's 2x upsample of a lifted 1-D or 2-D volume, on its real
    axes: nearest a torch copy; trilinear D2 on the lifted volume (which
    doubles the lifted axes too, each output plane there the input
    plane), then the first plane of each lifted axis."""
    if cfg.interp == "nearest":
        return upsample2x(feat, "nearest", pool_window(cfg))
    up = upsample2x_trilinear_ndhwc(feat, split=split)
    off = 3 - cfg.dimension
    return up[:, :1, :1 if off == 2 else None].contiguous()


def unet_apply_fused(
    plan: UnetPlan,
    packed: dict[int, dict[str, Any]],
    x: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    in_tile_counts: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """Forward of NDHWC `x` (B, D, H, W, Cin), or (B, L, Cin) / (B, H, W,
    Cin) for a 1-D / 2-D net; returns f32 (B, ..., Co) of the same rank.
    Spatial extents must be divisible by 2**num_downs. `in_tile_counts`
    gives live instance norms per-tile statistics (`full_tiled`), split at
    each level from that level's own extent."""
    cfg = plan.config
    lifted = cfg.dimension < 3
    pad = kernel_pad(cfg)
    last_conv = plan.conv_indices[-1]
    split = packed[plan.conv_indices[0]]["split"]
    x = lift_input(cfg, x)
    feat = (split3(x.float()) if split
            else x.to(compute_dtype).contiguous())
    enc_feats: list[torch.Tensor] = []
    small = enc = None  # operands of the next decoder conv
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            p = packed[idx]
            kw = dict(
                act=p["act"], slope=p["slope"], pad_type=pad,
                out_dtype=(torch.float32 if idx == last_conv or p["f32_out"]
                           else compute_dtype),
            )
            if small is not None and cfg.interp == "nearest" and \
                    not lifted:
                feat = conv3x3x3_upcat_ndhwc(enc, small, p["w"], p["b"], **kw)
            elif small is not None and enc is not None:
                feat = conv3x3x3_cat_ndhwc(enc, small, p["w"], p["b"], **kw)
            else:
                feat = conv3x3x3_ndhwc(
                    feat if small is None else small, p["w"], p["b"], **kw)
            small = enc = None
            if "block" in p:
                feat = _norm_apply(feat, p["block"], eps=cfg.norm_eps,
                                   tile_counts=in_tile_counts,
                                   out_dtype=compute_dtype, post_res=True)
        elif spec.kind == "norm" and idx in packed:
            feat = _norm_apply(feat, packed[idx], eps=cfg.norm_eps,
                               tile_counts=in_tile_counts,
                               out_dtype=compute_dtype)
        elif spec.kind == "pool":
            pool = max_pool if cfg.pooling == "Max" else avg_pool
            win = pool_window(cfg)
            feat = (split3(pool(merge3(feat), win)) if split
                    else pool(feat, win))
        elif spec.kind == "upsample":
            # nearest: the up-concat conv reads the small tensor itself;
            # trilinear: the upsampled tensor feeds the two-operand conv
            if lifted:
                small = _upsample_lifted(feat, cfg, split)
            elif cfg.interp == "nearest":
                small = feat
            else:
                small = upsample2x_trilinear_ndhwc(feat, split=split)
            enc = enc_feats.pop() if cfg.use_skip_connection else None
            feat = None
        # 'act' / 'final_act' ran in a conv epilogue or a norm-apply pass;
        # 'identity' is a folded norm; a residual block's norm and act ran
        # in its D1 pass
        if cfg.use_skip_connection and idx in plan.encoder_idx:
            enc_feats.append(feat)
    return deflate(cfg, feat)
