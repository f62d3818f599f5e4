"""Non-causal softmax attention over (B, H, N, hd): wrapper, plain version,
counter.

`flash_attention` replaces the JAX package's V3 Pallas kernel
(`anatomix_tpu/models/vit3d/primus.py` _flash_attention, the stock Pallas
TPU flash kernel) with the kernel of `csrc/flash_attention.cu`, whose
header says what bounds it on the card and what its design does about it.
It keeps the JAX layout at the public function: q, k and v are
`(B, H, N, hd)` bf16, the output `(B, H, N, hd)` bf16, the softmax and the
sums f32. Any N is taken (the ragged key tail is masked in the kernel) and
any even hd up to 128 (zero-filled to a multiple of 16 in shared memory).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version, the einsum/softmax of `primus.py:448-456`.
`.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from anatomix_tpu_torch.kernels import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fns: dict = {}


def _fn():
    fn = _fns.get("flash_attention")
    if fn is None:
        fn = build.load("flash_attention").flash_attention
        # q, k, v, out; BH, N, hd; scale; stream
        fn.argtypes = [_P] * 4 + [_I] * 3 + [_F, _P]
        fn.restype = ctypes.c_int
        _fns["flash_attention"] = fn
    return fn


def flash_attention_plain(q, k, v, scale: float):
    """f32 logits and softmax; the probabilities are rounded to q's dtype
    before the f32 product with v, as JAX's einsum path does
    (`attn.astype(dt)`); returns q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(attn.float(), v.float()).to(q.dtype)


def flash_attention(
    q: torch.Tensor,  # (B, H, N, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """softmax(q k^T * scale) v, non-causal, per (batch, head)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != torch.bfloat16
                or t.dim() != 4 or t.shape != q.shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous bf16 (B, H, N, hd) tensor of "
                f"q's shape {tuple(q.shape)} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    B, H, N, hd = q.shape
    if hd % 2 or hd > 128 or N < 1 or B * H > 65535:
        raise ValueError(f"the kernel takes an even hd <= 128, N >= 1 and "
                         f"B*H <= 65535; got {tuple(q.shape)}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               B * H, N, hd, float(scale), stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
