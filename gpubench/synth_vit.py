"""Seeded weights of the ViT configuration, made on the run's device.

As `synth.unet_weights` does for the UNets: one normal and one uniform draw
on the device from `--seed`, cut into the leaves of
`reference/primus.parameter_shapes` and shaped, so that the same seed gives
the same weights and no norm or scale is trivial.
"""

from __future__ import annotations

import math

import torch

from gpubench import synth

TRUNC = 2.0  # the truncated normal's cut, in standard deviations


def vit_weights(shapes: dict[str, tuple[int, ...]], cfg: dict, seed: int,
                device) -> dict[str, torch.Tensor]:
    """A state dict in the program's keys and layouts, float32: linears and
    the position embedding truncated normal (+-2 std) with std 0.02; convs
    He-normal (std sqrt(2 / fan_in), fan_in the taps times the input
    channels; a transposed conv's input channels come first); every bias
    N(0, 0.05); LayerNorm scales 1 + N(0, 0.1), their biases N(0, 0.05);
    LayerScale `init_values`; registers N(0, register_init_std)."""
    total = sum(math.prod(s) for s in shapes.values())
    z_all = torch.randn(total, generator=synth.generator(seed, 3, device),
                        device=device)
    u_all = torch.rand(total, generator=synth.generator(seed, 4, device),
                       device=device)
    # the truncated normal by the inverse of its distribution function
    lo = 0.5 * (1.0 + math.erf(-TRUNC / math.sqrt(2.0)))
    sd: dict[str, torch.Tensor] = {}
    at = 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        z = z_all[at:at + n].view(shape)
        u = u_all[at:at + n].view(shape)
        at += n
        leaf = key.rsplit(".", 1)[-1]
        if len(shape) == 5:
            fan_in = math.prod(shape[2:]) * (
                shape[0] if key.startswith("decoder.") else shape[1])
            v = z * math.sqrt(2.0 / fan_in)
        elif key == "pos_embed" or (leaf == "weight" and len(shape) == 2):
            p = lo + (1.0 - 2.0 * lo) * u
            v = 0.02 * math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
        elif key == "register_tokens":
            v = cfg["register_init_std"] * z
        elif leaf in ("gamma1", "gamma2"):
            v = torch.full(shape, float(cfg["init_values"]), device=device)
        elif leaf == "weight":  # a LayerNorm's scale
            v = 1.0 + 0.1 * z
        else:  # a bias
            v = 0.05 * z
        sd[key] = v.contiguous()
    return sd
