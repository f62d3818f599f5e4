"""BN-folded bf16 inference forward of the anatomix UNet on the port's
kernels.

Counterpart of the JAX package's `models/unet_fused.py`, without its TPU
block layout: activations stay channels-last `(B, D, H, W, C)` bf16
throughout. Weights are packed once (`prepack_fused`). Every conv goes to a
kernel of `kernels/conv.py`, and the activation that follows it runs in
the kernel's epilogue. Every decoder conv after upsample + concat goes to
the up-concat kernel, so neither the 2x tensor nor the concat is ever
materialized. The exit conv stores f32. Pooling is plain PyTorch glue, as it
is XLA in the JAX package.

On CPU tensors the kernel wrappers run their plain versions, so the same
forward with `compute_dtype=torch.float32` is the f32 CPU reference of the
kernel path.
"""

from __future__ import annotations

from typing import Any

import torch

from anatomix_tpu_torch.kernels.conv import (
    conv3x3x3_ndhwc,
    conv3x3x3_upcat_ndhwc,
)
from anatomix_tpu_torch.models.unet import UnetPlan, check_supported
from anatomix_tpu_torch.ops.activations import UNET_LRELU_SLOPE
from anatomix_tpu_torch.ops.conv import pack_conv_weight
from anatomix_tpu_torch.ops.pool import avg_pool, max_pool


def _epilogue_act(plan: UnetPlan, conv_idx: int) -> str:
    """The activation layer a conv's epilogue absorbs: the next layer after
    folded norms ('identity'), if it is an activation."""
    cfg = plan.config
    for spec in plan.layers[conv_idx + 1:]:
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
    """Pack every conv of a BN-folded plan once: weights `(27 * Ci, Co)` in
    `compute_dtype`, bias f32, and the epilogue activation."""
    check_supported(plan.config)
    if any(spec.kind == "norm" for spec in plan.layers):
        raise ValueError(
            "prepack_fused needs a BN-folded plan (extract.fold_batchnorm)"
        )
    packed = {}
    for idx in plan.conv_indices:
        spec = plan.layers[idx]
        w = state_dict[f"model.{idx}.weight"].float()
        b = state_dict.get(f"model.{idx}.bias")
        if b is None:
            b = torch.zeros(spec.out_ch)
        packed[idx] = {
            "w": pack_conv_weight(w).to(device=device, dtype=compute_dtype)
            .contiguous(),
            "b": b.float().to(device).contiguous(),
            "act": _epilogue_act(plan, idx),
        }
    return packed


def unet_apply_fused(
    plan: UnetPlan,
    packed: dict[int, dict[str, Any]],
    x: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Forward of NDHWC `x` (B, D, H, W, Cin); returns f32 (B, D, H, W, Co).
    Spatial extents must be divisible by 2**num_downs."""
    cfg = plan.config
    last_conv = plan.conv_indices[-1]
    feat = x.to(compute_dtype).contiguous()
    enc_feats: list[torch.Tensor] = []
    small = enc = None  # operands of the next decoder conv
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            p = packed[idx]
            kw = dict(
                act=p["act"], slope=UNET_LRELU_SLOPE, pad_type=cfg.pad_type,
                out_dtype=torch.float32 if idx == last_conv else compute_dtype,
            )
            if small is not None:
                feat = conv3x3x3_upcat_ndhwc(enc, small, p["w"], p["b"], **kw)
                small = enc = None
            else:
                feat = conv3x3x3_ndhwc(feat, p["w"], p["b"], **kw)
        elif spec.kind == "pool":
            feat = (max_pool if cfg.pooling == "Max" else avg_pool)(feat, 2)
        elif spec.kind == "upsample":
            small = feat
            enc = enc_feats.pop() if cfg.use_skip_connection else None
            feat = None
        # 'act' / 'final_act' ran in the conv epilogue; 'identity' is a
        # folded norm
        if cfg.use_skip_connection and idx in plan.encoder_idx:
            enc_feats.append(feat)
    return feat
