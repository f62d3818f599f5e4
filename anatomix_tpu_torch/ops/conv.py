"""Plain 3D convolution with torch 'same' padding on NDHWC volumes, and the
weight-layout helpers the port uses.

This is the plain version for the CPU, the eager `Unet` and the tests; the
main path on the card runs the hand-written kernels of `kernels/conv.py`
and `kernels/conv_down.py`.

Layouts:
  * torch   (O, I, kD, kH, kW) -- the reference `.pth` and the port's
    state dict;
  * DHWIO   (kD, kH, kW, I, O) -- the JAX package's pytree;
  * packed  (27 * I, O)        -- the kernels' GEMM B operand, row index
    `((kd * 3 + kh) * 3 + kw) * I + i`.

The three-term split: a bf16 conv reads an f32 operand pair to about 2^-16
of its product when the input is the channel blocks [hi | lo | hi]
(`split3`: hi = bf16(x), lo = bf16(x - hi)) and the weights [w_hi; w_hi;
w_lo] along I (`split3_weight`): x_hi w_hi + x_lo w_hi + x_hi w_lo, summed
in f32. The ViT tokenizer takes it on the card (`models/vit3d`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PAD_MODES = {
    "reflect": "reflect",      # mirror, edge not repeated (torch 'reflect')
    "zeros": "constant",
    "replicate": "replicate",  # the edge voxel repeated (jnp 'edge')
    "circular": "circular",    # periodic (jnp 'wrap')
}


def pad_modes(pad_type) -> tuple[str, str, str]:
    """The padding of each of the D, H, W axes: `pad_type` names one mode
    for all three, or gives a mode per axis (a 1-D or 2-D UNet's lifted
    axes pad with zeros, `models/unet.kernel_pad`)."""
    modes = (pad_type,) * 3 if isinstance(pad_type, str) else tuple(pad_type)
    if len(modes) != 3 or any(m not in _PAD_MODES for m in modes):
        raise ValueError(f"unsupported pad_type {pad_type!r}")
    return modes


def pad_axes(xc: torch.Tensor, widths, pad_type) -> torch.Tensor:
    """Pad the three trailing axes of `xc` (B, C, D, H, W) by `widths`
    ((lo, hi) per axis, D first) with each axis's mode of `pad_type`."""
    modes = pad_modes(pad_type)
    for ax, ((lo, hi), mode) in enumerate(zip(widths, modes)):
        if lo or hi:
            pads = [0] * 6
            pads[2 * (2 - ax):2 * (2 - ax) + 2] = [lo, hi]
            xc = F.pad(xc, pads, mode=_PAD_MODES[mode])
    return xc


def conv3d_same(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    pad_type="zeros",
) -> torch.Tensor:
    """Stride-1 'same' conv of NDHWC `x` with a torch-layout kernel `w`,
    as `nn.Conv3d(..., padding='same', padding_mode=pad_type)` (a mode per
    axis, `pad_modes`; a kernel axis of extent 1 is not padded)."""
    kd, kh, kw = w.shape[2:]
    xc = pad_axes(x.permute(0, 4, 1, 2, 3),
                  [(k // 2, (k - 1) // 2) for k in (kd, kh, kw)], pad_type)
    y = F.conv3d(xc, w, b)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def lift_weight(w: torch.Tensor) -> torch.Tensor:
    """A 1-D or 2-D conv weight (O, I, k) / (O, I, kh, kw) as the 3-D
    kernel of the lifted volume, leading kernel axes of extent 1
    (`anatomix_tpu/ops/conv.py` torch_conv_weight_to_jax); 3-D as it is."""
    return w.reshape(w.shape[:2] + (1,) * (5 - w.dim()) + w.shape[2:])


def full_kernel(w: torch.Tensor) -> torch.Tensor:
    """A lifted kernel (O, I, 1 or 3, 1 or 3, 3) as the 3x3x3 kernel with
    zero taps on its extent-1 axes, the layout the conv kernels pack."""
    pads = []
    for k in reversed(w.shape[2:]):
        pads += [0, 0] if k == 3 else [1, 1]
    return F.pad(w, pads) if any(pads) else w


def conv3d_down2(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
) -> torch.Tensor:
    """Stride-2 3x3x3 conv of NDHWC `x` with zero padding 1 on each side
    (`nn.Conv3d(..., stride=2, padding=1)`, the JAX package's
    `conv3d(stride=2, padding=[(1, 1)] * 3)`); output extents
    `(n - 1) // 2 + 1`."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, stride=2, padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def torch_to_dhwio(w: torch.Tensor) -> torch.Tensor:
    """(O, I, kD, kH, kW) -> (kD, kH, kW, I, O)."""
    return w.permute(2, 3, 4, 1, 0).contiguous()


def dhwio_to_torch(w: torch.Tensor) -> torch.Tensor:
    """(kD, kH, kW, I, O) -> (O, I, kD, kH, kW)."""
    return w.permute(4, 3, 0, 1, 2).contiguous()


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """torch-layout 3x3x3 kernel (O, I, 3, 3, 3) -> packed (27 * I, O)."""
    if tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"expected a 3x3x3 kernel, got {tuple(w.shape)}")
    co, ci = w.shape[:2]
    return torch_to_dhwio(w).reshape(27 * ci, co)


def unpack_conv_weight(w_packed: torch.Tensor, ci: int) -> torch.Tensor:
    """Packed (27 * I, O) -> torch layout (O, I, 3, 3, 3)."""
    co = w_packed.shape[1]
    return dhwio_to_torch(w_packed.reshape(3, 3, 3, ci, co))


def split3(x: torch.Tensor) -> torch.Tensor:
    """f32 (..., C) -> bf16 (..., 3 C) [hi | lo | hi]."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo, hi], dim=-1)


def merge3(t: torch.Tensor) -> torch.Tensor:
    """bf16 (..., 3 C) [hi | lo | hi] -> f32 (..., C) hi + lo."""
    c = t.shape[-1] // 3
    return t[..., :c].float() + t[..., c:2 * c].float()


def split3_weight(w: torch.Tensor) -> torch.Tensor:
    """f32 torch-layout (O, I, ...) -> (O, 3 I, ...) [w_hi; w_hi; w_lo]
    along I, f32 (each term exact in bf16 but w_lo, which rounds)."""
    hi = w.to(torch.bfloat16).float()
    return torch.cat([hi, hi, w - hi], dim=1)
