"""Segmentation model: a pretrained backbone + a 1x1x1 output head (the port
of `anatomix_tpu/segmentation/model.py`).

The reference's `segmentation_utils.load_model`: the backbone from a local
checkpoint, a registry variant's local file or 'scratch', plus MONAI's
`UnetOutBlock(3, feat_ch, n_classes + 1)`, a single 1x1x1 conv with bias,
no norm, no activation.

Parameters are `{"backbone": state dict, "head": {"weight", "bias"}}`: the
backbone's reference-keyed float leaves (`model.<idx>.weight`, ...,
`.running_mean`, `.running_var`) and the head as `nn.Conv3d` holds it,
weight (n_classes + 1, C, 1, 1, 1). The head is an f32 matmul outside any
kernel, as JAX computes it as an `einsum` outside any Pallas kernel.

`seg_forward(train=True)` runs the train walk in bf16 on the card, or its
f32 plain path (`plain=True`, the default on the CPU): for the 6M family
the block walk of `models/unet_train_block.py` (K1 forward, T-x / T-w
backward, the L permutations for the pools and upsamples), for every other
UNet (the `anatomix-dev` backbone's instance norms, Avg pool and trilinear
decoder) the general walk of `models/unet_train.py` (K1 forward on the
three-term split under a live norm, T-x / T-w backward). The eval forward
(`make_seg_predictor`) folds the batch norms into the convs and packs them
for the fused forward (K1, K3; a live-norm backbone packs its unfolded
plan: K1, D1, D2, D3 and the split) on the card, or runs the eager f32
`Unet` (`plain=True`, the default on the CPU). The pack is built from the
parameters at the call that makes the predictor: after training steps,
make a new one.

A `--pretrained_ckpt` backbone is built with `norm_eps` 1e-5 whatever its
norm (the reference's default, which the JAX package copies), a registry
variant with its own (1e-2 for `anatomix-dev`): ROADMAP fault F8.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from anatomix_tpu_torch.device import resolve_device
from anatomix_tpu_torch.extract import fold_batchnorm
from anatomix_tpu_torch.models.convert import from_jax_params, to_jax_params
from anatomix_tpu_torch.models.load import load_from_hf, load_model
from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
from anatomix_tpu_torch.models.unet import (
    Unet,
    UnetPlan,
    check_supported,
    trainable_state,
)
from anatomix_tpu_torch.models.unet_fused import (
    prepack_fused,
    unet_apply_fused,
)
from anatomix_tpu_torch.models.unet_train import unet_train_forward


def init_head(generator: torch.Generator, feat_channels: int,
              n_classes: int) -> dict[str, torch.Tensor]:
    """The 1x1x1 conv head for (n_classes + 1) output channels with
    `nn.Conv3d`'s default init, as MONAI's `UnetOutBlock` has it: weight and
    bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = `feat_channels`
    (kaiming-uniform with a = sqrt(5)). CPU f32, drawn from `generator`.
    The JAX package draws the weight from U(+-sqrt(6 / fan_in)), against
    its own docstring (ROADMAP fault F7); the port follows the reference."""
    n_out = n_classes + 1
    bound = 1.0 / math.sqrt(feat_channels)

    def uniform(shape):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    return {"weight": uniform((n_out, feat_channels, 1, 1, 1)),
            "bias": uniform((n_out,))}


def apply_head(head: dict[str, torch.Tensor],
               feats: torch.Tensor) -> torch.Tensor:
    """feats (B, D, H, W, C) -> logits (B, D, H, W, n_classes + 1), f32."""
    w = head["weight"].reshape(head["weight"].shape[0], -1).float()
    return feats.float() @ w.t() + head["bias"].float()


def _is_vit(variant: str) -> bool:
    return "vit_kwargs" in ANATOMIX_VARIANTS.get(variant, {})


def load_seg_model(
    n_classes: int,
    *,
    ckpt_path: str | None = None,
    hf_variant: str | None = None,
    cache_path: str | None = None,
    num_downs: int = 4,
    ngf: int = 16,
    output_nc: int = 16,
    norm: str = "batch",
    interp: str = "nearest",
    pooling: str = "Max",
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """`(plan, params)` on `device` (the card unless the caller asks for the
    CPU; raises without one before reading anything). Exactly one of
    `ckpt_path` (`.pth`, `.npz` or `"scratch"`, seeded random weights) and
    `hf_variant` (a UNet variant read from its local file `cache_path`; the
    port downloads nothing). The head is drawn from a CPU generator seeded
    `seed + 1`."""
    dev = resolve_device(device)
    if (ckpt_path is None) == (hf_variant is None):
        raise ValueError("Provide exactly one of `ckpt_path` or `hf_variant`.")
    if hf_variant is not None:
        if _is_vit(hf_variant):
            raise ValueError(
                f"{hf_variant!r} is a ViT backbone: segmentation finetunes "
                "the UNet variants, as the JAX package does")
        plan, backbone = load_from_hf(hf_variant, cache_path, device=dev)
        feat_channels = ANATOMIX_VARIANTS[hf_variant]["output_channels"]
    else:
        plan, backbone = load_model(
            ckpt_path=ckpt_path, num_downs=num_downs, ngf=ngf,
            output_nc=output_nc, norm=norm, interp=interp, pooling=pooling,
            allow_scratch=True, seed=seed, device=dev,
        )
        feat_channels = output_nc
    backbone = trainable_state(plan, backbone)
    head = init_head(torch.Generator().manual_seed(seed + 1), feat_channels,
                     n_classes)
    return plan, {"backbone": backbone,
                  "head": {k: v.to(dev) for k, v in head.items()}}


def check_trainable(plan) -> None:
    """Raise for a backbone the train walks do not cover: a ViT plan
    (`ValueError`), or UNet options the JAX package refuses as well
    (`NotImplementedError`, from `models.unet.check_supported`)."""
    if not isinstance(plan, UnetPlan):
        raise ValueError("segmentation finetunes the UNet backbones")
    check_supported(plan.config)


def make_seg_predictor(plan: UnetPlan, params: dict[str, Any], *,
                       compute_dtype: torch.dtype | None = None,
                       plain: bool | None = None
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """`x (B, D, H, W, 1) -> logits (B, D, H, W, n_classes + 1)` f32 of the
    model in eval mode, from the parameters as they are now: the batch
    norms folded into the convs and packed for the fused forward on the
    port's kernels (`compute_dtype`, default bf16 on the card and f32 on
    the CPU), or with `plain=True` (the default on the CPU) the eager f32
    `Unet`. Extents divisible by 2**num_downs."""
    # a snapshot: the optimizer updates the parameters in place
    backbone = {k: v.detach().clone() for k, v in params["backbone"].items()}
    head = {k: v.detach().clone() for k, v in params["head"].items()}
    dev = next(iter(backbone.values())).device
    plain = dev.type != "cuda" if plain is None else plain
    if plain:
        net = Unet.from_state_dict(plan, backbone).to(dev)

        def features(x):
            return net(x.float())
    else:
        cd = compute_dtype or (torch.bfloat16 if dev.type == "cuda"
                               else torch.float32)
        fplan, fsd = fold_batchnorm(plan, backbone)
        packed = prepack_fused(fplan, fsd, device=dev, compute_dtype=cd)

        def features(x):
            return unet_apply_fused(fplan, packed, x, compute_dtype=cd)

    @torch.no_grad()
    def predict(x):
        return apply_head(head, features(x))

    return predict


def seg_forward(
    plan: UnetPlan,
    params: dict[str, Any],
    x: torch.Tensor,
    *,
    train: bool = False,
    compute_dtype: torch.dtype | None = None,
    plain: bool | None = None,
):
    """Backbone features -> class logits (f32) of `x` (B, D, H, W, 1). With
    `train=True` returns `(logits, new_stats)`, batch norm on the batch's
    statistics and `new_stats[str(idx)] = (running_mean, running_var)`
    updated (momentum 0.1, unbiased variance; empty for instance norms):
    the train walk on the
    kernels in `compute_dtype` (default bf16 on the card, f32 on the CPU,
    where the kernel wrappers run their plain versions), or with
    `plain=True` (the default off the card) in f32 with `F.conv3d` under
    autograd. In eval mode returns the logits of `make_seg_predictor`."""
    plain = x.device.type != "cuda" if plain is None else plain
    if not train:
        return make_seg_predictor(plan, params, compute_dtype=compute_dtype,
                                  plain=plain)(x)
    check_trainable(plan)
    feats, _, new_stats = unet_train_forward(
        plan, params["backbone"], x, layers=(),
        compute_dtype=compute_dtype or (
            torch.bfloat16 if x.device.type == "cuda" else torch.float32),
        plain=plain)
    return apply_head(params["head"], feats), new_stats


def from_jax_seg_params(plan: UnetPlan, params: dict[str, Any]):
    """The JAX package's `{"backbone": pytree, "head": {"w", "b"}}` (numpy
    leaves) -> the port's parameters (CPU f32)."""
    backbone = trainable_state(plan,
                               from_jax_params(plan, params["backbone"]))
    w = np.asarray(params["head"]["w"], np.float32)  # (1, 1, 1, C, O)
    return {"backbone": backbone, "head": {
        "weight": torch.from_numpy(
            np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2)))),
        "bias": torch.from_numpy(np.array(params["head"]["b"], np.float32)),
    }}


def to_jax_seg_params(plan: UnetPlan, params: dict[str, Any]):
    """The port's parameters -> the JAX package's layout, numpy leaves."""
    w = params["head"]["weight"].detach().cpu().float().numpy()
    return {"backbone": to_jax_params(plan, params["backbone"]), "head": {
        "w": np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0))),
        "b": params["head"]["bias"].detach().cpu().float().numpy(),
    }}
