"""Gaussian-blend scatter-accumulate of window outputs: wrapper, plain
version, counter.

`blend_scatter` replaces the JAX package's K4 Pallas kernel
(`anatomix_tpu/ops/pallas/scatter.py` blend_scatter_fold) with the kernel of
`csrc/blend_scatter.cu`, whose header says what bounds it on the card and
what its design does about it. The canvas is `(D, H, W, C)` f32, the same
row-major order as the JAX kernel's folded `(D, H, W*C/128, 128)` canvas, so
no fold is needed; the window outputs are f32 or bf16 (the ViT's fold exit
writes bf16 windows), every product and sum f32.

On a CUDA canvas the wrapper launches the kernel or raises; on a CPU canvas
it runs the plain version (slice adds). `.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from anatomix_tpu_torch.kernels import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fns: dict = {}


def _fn():
    fn = _fns.get("blend_scatter")
    if fn is None:
        fn = build.load("blend_scatter").blend_scatter
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _F] + [_I] * 9 + [_P]
        fn.restype = ctypes.c_int
        _fns["blend_scatter"] = fn
    return fn


def blend_scatter_plain(canvas, out, starts, mask, gd, gh, gw, minv):
    r0, r1, r2 = out.shape[1:4]
    imp = torch.clamp(
        (gd[:, None, None] * gh[None, :, None]) * gw[None, None, :], min=minv
    )
    for b, (s, m) in enumerate(zip(starts.tolist(), mask.tolist())):
        # the clamp comes before the mask: a masked window adds nothing
        w = (imp * float(m))[..., None]
        canvas[s[0]:s[0] + r0, s[1]:s[1] + r1, s[2]:s[2] + r2] += (
            out[b].float() * w
        )
    return canvas


def blend_scatter(
    canvas: torch.Tensor,  # (D, H, W, C) f32, updated in place
    out: torch.Tensor,     # (B, r0, r1, r2, C) f32 or bf16 window outputs
    starts: torch.Tensor,  # (B, 3) int32 window starts, in bounds
    mask: torch.Tensor,    # (B,) int32, 1 = real window, 0 = padding
    gd: torch.Tensor,      # (r0,) f32 separable blend factors
    gh: torch.Tensor,      # (r1,)
    gw: torch.Tensor,      # (r2,)
    minv: float,
) -> torch.Tensor:
    """canvas[s + (i, j, k), c] += out[b, i, j, k, c]
    * max(gd[i] * gh[j] * gw[k], minv) * mask[b]; returns `canvas`.

    The caller keeps `starts` in bounds (`ops/sliding_window.py` checks them
    on the host); the kernel skips a window that is not."""
    if canvas.device.type == "cpu":
        return blend_scatter_plain(canvas, out, starts, mask, gd, gh, gw, minv)
    dev = canvas.device
    B, r0, r1, r2, C = out.shape
    D, H, W = canvas.shape[:3]
    win_dtype = (torch.bfloat16 if out.dtype == torch.bfloat16
                 else torch.float32)
    checks = [
        (canvas, torch.float32, (D, H, W, C)),
        (out, win_dtype, (B, r0, r1, r2, C)),
        (starts, torch.int32, (B, 3)),
        (mask, torch.int32, (B,)),
        (gd, torch.float32, (r0,)),
        (gh, torch.float32, (r1,)),
        (gw, torch.float32, (r2,)),
    ]
    for t, dtype, shape in checks:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"blend_scatter: expected contiguous {dtype} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if r0 > D or r1 > H or r2 > W:
        raise ValueError(f"window {(r0, r1, r2)} exceeds canvas {(D, H, W)}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn()(
        canvas.data_ptr(), out.data_ptr(), starts.data_ptr(),
        mask.data_ptr(), gd.data_ptr(), gh.data_ptr(), gw.data_ptr(),
        float(minv), B, D, H, W, C, r0, r1, r2,
        int(win_dtype == torch.bfloat16), stream,
    )
    build.check(rc, "blend_scatter")
    blend_scatter.launches += 1
    return canvas


blend_scatter.launches = 0
