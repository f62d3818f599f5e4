"""Factor-8 depth-to-space, the ViT patch decoder's exit: wrapper, plain
version, counter.

`depth_to_space8_ndhwc` replaces the JAX package's V1 Pallas kernel
(`anatomix_tpu/ops/pallas/reshuffle.py` depth_to_space8, its `emit=
"spatial"` form with the optional f32 subtract) with the kernel of
`csrc/depth_to_space8.cu`, whose header says what bounds it on the card and
what its design does about it. Input `(B, d, h, w, 512 * C)` bf16 with the
channel order `(a1, a2, a3, c)` of the three stacked transposed-conv GEMMs,
`a_i = z_i * 4 + y_i * 2 + x_i`; output f32 `(B, 8d, 8h, 8w, C)` at
`D = 8 dz + 4 z1 + 2 z2 + z3` (likewise H, W), minus `sub[b, channel]`
where `sub` (B, 512 * C) f32 is given.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (a reshape and a permute). `.launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from anatomix_tpu_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns: dict = {}


def _fn():
    fn = _fns.get("depth_to_space8_ndhwc")
    if fn is None:
        fn = build.load("depth_to_space8").depth_to_space8_ndhwc
        # y, sub, out; B, d, h, w, C; stream
        fn.argtypes = [_P] * 3 + [_I] * 5 + [_P]
        fn.restype = ctypes.c_int
        _fns["depth_to_space8_ndhwc"] = fn
    return fn


def depth_to_space8_ndhwc_plain(y, sub=None):
    """f32 arithmetic on the same inputs."""
    B, d, h, w, c512 = y.shape
    C = c512 // 512
    t = y.float()
    if sub is not None:
        t = t - sub.float()[:, None, None, None, :]
    # (z1, y1, x1, z2, y2, x2, z3, y3, x3, c) -> interleave each bit with
    # its coarse axis, coarsest bit first
    t = t.reshape(B, d, h, w, 2, 2, 2, 2, 2, 2, 2, 2, 2, C)
    t = t.permute(0, 1, 4, 7, 10, 2, 5, 8, 11, 3, 6, 9, 12, 13)
    return t.reshape(B, 8 * d, 8 * h, 8 * w, C)


def depth_to_space8_ndhwc(
    y: torch.Tensor,                 # (B, d, h, w, 512 * C) bf16
    sub: torch.Tensor | None = None,  # (B, 512 * C) f32
) -> torch.Tensor:
    """(B, d, h, w, 512 C) -> (B, 8d, 8h, 8w, C) f32, minus `sub`."""
    if y.device.type == "cpu":
        return depth_to_space8_ndhwc_plain(y, sub)
    if (y.dtype != torch.bfloat16 or y.dim() != 5 or y.shape[-1] % 512
            or not y.is_contiguous()):
        raise ValueError(f"y must be a contiguous bf16 (B, d, h, w, 512*C) "
                         f"tensor, got {y.dtype} {tuple(y.shape)}")
    B, d, h, w, c512 = y.shape
    if sub is not None and (
            sub.dtype != torch.float32 or tuple(sub.shape) != (B, c512)
            or sub.device != y.device or not sub.is_contiguous()):
        raise ValueError(f"sub must be contiguous f32 {(B, c512)} on "
                         f"{y.device}, got {sub.dtype} {tuple(sub.shape)}")
    C = c512 // 512
    out = torch.empty((B, 8 * d, 8 * h, 8 * w, C), dtype=torch.float32,
                      device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = _fn()(y.data_ptr(), None if sub is None else sub.data_ptr(),
               out.data_ptr(), B, d, h, w, C, stream)
    build.check(rc, "depth_to_space8_ndhwc")
    depth_to_space8_ndhwc.launches += 1
    return out


depth_to_space8_ndhwc.launches = 0
