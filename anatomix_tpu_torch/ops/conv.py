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
}


def conv3d_same(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    pad_type: str = "zeros",
) -> torch.Tensor:
    """Stride-1 'same' conv of NDHWC `x` with a torch-layout kernel `w`,
    as `nn.Conv3d(..., padding='same', padding_mode=pad_type)`."""
    if pad_type not in _PAD_MODES:
        raise ValueError(f"unsupported pad_type {pad_type!r}")
    kd, kh, kw = w.shape[2:]
    xc = x.permute(0, 4, 1, 2, 3)
    pads = (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2,
            kd // 2, (kd - 1) // 2)
    if any(pads):
        xc = F.pad(xc, pads, mode=_PAD_MODES[pad_type])
    y = F.conv3d(xc, w, b)
    return y.permute(0, 2, 3, 4, 1).contiguous()


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
