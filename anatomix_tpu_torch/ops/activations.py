"""Activations of the reference UNet factory, with an explicit slope.

The UNet-level LeakyReLU slope is 0.3 (`get_actvn_layer` in the reference
network); the JAX package's fused Pallas epilogue hard-codes 0.2 instead
(`anatomix_tpu/ops/pallas/conv_block.py:61-62`). The port takes the slope as
an argument everywhere and its UNet passes 0.3, matching `unet_apply`.

PReLU (torch's `nn.PReLU()`: one learned scalar, `max(0, x) + w min(0, x)`)
is the LeakyReLU with the slope read from its weight: the kernels run it as
their `lrelu` epilogue, given the weight's value as the slope.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

UNET_LRELU_SLOPE = 0.3

# activations the conv kernels' epilogue implements, by kernel code
EPILOGUE_ACTS = {"none": 0, "relu": 1, "lrelu": 2, "elu": 3, "tanh": 4,
                 "selu": 5}


def prelu(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """torch `nn.PReLU` with one shared scalar `weight` (shape (1,)), as
    the JAX package's `where(x >= 0, x, w x)`."""
    return torch.where(x >= 0, x, weight.to(x.dtype) * x)


def apply_activation(
    x: torch.Tensor, name: str, *, slope: float = UNET_LRELU_SLOPE,
    weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply activation `name` ('none' returns `x` unchanged); `prelu`
    takes its learned `weight`."""
    if name == "none":
        return x
    if name == "relu":
        return F.relu(x)
    if name == "lrelu":
        return F.leaky_relu(x, negative_slope=slope)
    if name == "elu":
        return F.elu(x)
    if name == "selu":
        return F.selu(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "prelu":
        if weight is None:
            raise ValueError("prelu needs its weight")
        return prelu(x, weight)
    raise ValueError(f"unsupported activation: {name!r}")


def epilogue(name: str, weight: torch.Tensor | None = None
             ) -> tuple[str, float]:
    """(epilogue activation, slope) that computes activation `name` in a
    kernel: PReLU is `lrelu` with its weight's value as the slope (read
    once, when the weights are packed), LeakyReLU the UNet's 0.3."""
    if name == "prelu":
        if weight is None:
            raise ValueError("prelu needs its weight")
        return "lrelu", float(weight.reshape(-1)[0])
    return name, UNET_LRELU_SLOPE
