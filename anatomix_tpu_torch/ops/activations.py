"""Activations of the reference UNet factory, with an explicit slope.

The UNet-level LeakyReLU slope is 0.3 (`get_actvn_layer` in the reference
network); the JAX package's fused Pallas epilogue hard-codes 0.2 instead
(`anatomix_tpu/ops/pallas/conv_block.py:61-62`). The port takes the slope as
an argument everywhere and its UNet passes 0.3, matching `unet_apply`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

UNET_LRELU_SLOPE = 0.3

# activations the conv kernels' epilogue implements, by kernel code
EPILOGUE_ACTS = {"none": 0, "relu": 1, "lrelu": 2, "elu": 3, "tanh": 4}


def apply_activation(
    x: torch.Tensor, name: str, *, slope: float = UNET_LRELU_SLOPE
) -> torch.Tensor:
    """Apply activation `name` ('none' returns `x` unchanged)."""
    if name == "none":
        return x
    if name == "relu":
        return F.relu(x)
    if name == "lrelu":
        return F.leaky_relu(x, negative_slope=slope)
    if name == "elu":
        return F.elu(x)
    if name == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unsupported activation: {name!r}")
