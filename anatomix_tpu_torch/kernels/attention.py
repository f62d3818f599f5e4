"""Non-causal softmax attention over (B, H, N, hd) and its backward:
wrappers, plain versions, counters, and the differentiable attention of the
ViT's pretraining step.

`flash_attention` replaces the JAX package's V3 Pallas kernel
(`anatomix_tpu/models/vit3d/primus.py` _flash_attention, the stock Pallas
TPU flash kernel); `flash_attention_bwd_dkv` and `flash_attention_bwd_dq`
replace the two kernels of its custom VJP (`jax/experimental/pallas/ops/
tpu/flash_attention.py` _flash_attention_bwd_dkv, _flash_attention_bwd_dq),
all three in `csrc/flash_attention.cu`, whose header says what bounds them
on the card and what their design does about it (all three on Hopper's
warpgroup MMA, each operand tile staged once through a cp.async ring and
read both K-major and MN-major). The JAX layout stays at
the public functions: q, k, v and dO are `(B, H, N, hd)` bf16, the output
`(B, H, N, hd)` bf16, the log-sum-exp `lse` and `di = sum(o * dO, -1)`
`(B, H, N)` f32, the gradients `(B, H, N, hd)` f32. Any N is taken (the
ragged tail is masked in the kernels), any even hd up to 128 forward and up
to 80 backward (zero-filled to a multiple of 16 in shared memory).

`qkv_prologue` feeds the forward in the ViT's EVA blocks: from the f32
(B, N, H hd) q/k/v projections it takes the per-head q/k LayerNorm and the
interleaved RoPE in f32 and stores the three bf16 (B, H, N, hd) operands in
one launch (`csrc/flash_attention.cu`, `qkv_prologue_kernel`); it replaces
no Pallas kernel, since the JAX package leaves that work to XLA.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version (f32 arithmetic on the same inputs, rounded where
the kernel rounds). Each wrapper counts its launches in `.launches`.

`flash_attention_train(q, k, v, scale, compute_dtype)` is the counterpart of
`_flash_attention` under `jax.grad`: the forward on V3 with the lse, the
backward on the dkv and dq kernels (`backward_route` swaps them).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from anatomix_tpu_torch.kernels import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, q_w, q_b, k_w, k_b, cos, sin, qo, ko, vo; B, N, H, hd, R;
    # eps; stream
    "qkv_prologue": [_P] * 12 + [_I] * 5 + [_F, _P],
    # q, k, v, out, lse; BH, N, hd; scale; stream
    "flash_attention": [_P] * 5 + [_I] * 3 + [_F, _P],
    # q, k, v, dout, lse, di, dk, dv; BH, N, hd; scale; stream
    "flash_attention_bwd_dkv": [_P] * 8 + [_I] * 3 + [_F, _P],
    # q, k, v, dout, lse, di, dq; BH, N, hd; scale; stream
    "flash_attention_bwd_dq": [_P] * 7 + [_I] * 3 + [_F, _P],
}
_fns: dict = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("flash_attention"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


# -----------------------------------------------------------------------------
# plain versions

def _logits(q, k, scale):
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def flash_attention_plain(q, k, v, scale: float):
    """f32 logits and softmax; the probabilities are rounded to q's dtype
    before the f32 product with v, as JAX's einsum path does
    (`attn.astype(dt)`); returns q's dtype."""
    attn = torch.softmax(_logits(q, k, scale), dim=-1).to(q.dtype)
    return torch.matmul(attn.float(), v.float()).to(q.dtype)


def flash_attention_lse_plain(q, k, v, scale: float):
    """`(out, lse)`: the plain forward and the f32 natural log-sum-exp of
    each row's scaled logits, (B, H, N)."""
    return (flash_attention_plain(q, k, v, scale),
            torch.logsumexp(_logits(q, k, scale), dim=-1))


def _probs(q, k, lse, scale):
    """P = exp(q k^T * scale - lse), f32, from the forward's lse."""
    return torch.exp(_logits(q, k, scale) - lse.float()[..., None])


def _dscores(p, do, v, di, dtype):
    """dS = P (dO v^T - di), f32, rounded to `dtype` where the kernels
    round it."""
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return (p * (dp - di.float()[..., None])).to(dtype).float()


def flash_attention_bwd_dkv_plain(q, k, v, lse, do, di, scale: float):
    """`(dk, dv)` f32: dV = P^T dO with P rounded to q's dtype, dK = dS^T q
    * scale with dS rounded to q's dtype."""
    p = _probs(q, k, lse, scale)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    ds = _dscores(p, do, v, di, q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dk, dv


def flash_attention_bwd_dq_plain(q, k, v, lse, do, di, scale: float):
    """dQ = dS k * scale, f32, with dS rounded to q's dtype."""
    ds = _dscores(_probs(q, k, lse, scale), do, v, di, q.dtype)
    return torch.matmul(ds, k.float()) * scale


def attention_di(o, do):
    """di = sum(o * dO) over hd, f32 (B, H, N): the stock backward's
    XLA-side reduction."""
    return (o.float() * do.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """`(dq, dk, dv)` f32 of `flash_attention` given the forward's output
    `o` and `lse` and the output gradient `do`: the two plain passes."""
    di = attention_di(o, do)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, lse, do, di, scale)
    return flash_attention_bwd_dq_plain(q, k, v, lse, do, di, scale), dk, dv


def qkv_prologue_plain(q, k, v, heads: int, *, q_norm=None, k_norm=None,
                       rope=None, registers: int = 0, eps: float = 1e-5,
                       out_dtype: torch.dtype = torch.bfloat16):
    """The EVA block's attention prologue in torch, as the ViT composed it
    before `qkv_prologue`: q, k and v (B, N, heads hd) f32 from the
    projections -> `(q, k, v)` (B, heads, N, hd) in `out_dtype`,
    contiguous. q and k take the per-head LayerNorm when `q_norm` and
    `k_norm` give its (weight, bias) over hd (eps `eps`), then, with `rope =
    (cos, sin)` (each (N - registers, hd / 2)), the interleaved RoPE of
    every token after the first `registers`; f32 arithmetic, one rounding."""
    # the model's module imports this one
    from anatomix_tpu_torch.models.vit3d.primus import _apply_rope

    B, N, D = q.shape
    hd = D // heads
    q, k, v = (t.view(B, N, heads, hd) for t in (q, k, v))
    if q_norm is not None:
        q = F.layer_norm(q, (hd,), *q_norm, eps)
        k = F.layer_norm(k, (hd,), *k_norm, eps)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, hd)
    if rope is not None:
        R = registers
        q = torch.cat([q[:, :, :R], _apply_rope(q[:, :, R:], *rope)], dim=2)
        k = torch.cat([k[:, :, :R], _apply_rope(k[:, :, R:], *rope)], dim=2)
    return tuple(t.to(out_dtype).contiguous() for t in (q, k, v))


# -----------------------------------------------------------------------------
# kernel wrappers

def _check_qkv(q, named, max_hd: int):
    for name, t in named:
        if (t.device != q.device or t.dtype != torch.bfloat16
                or t.dim() != 4 or t.shape != q.shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous bf16 (B, H, N, hd) tensor of "
                f"q's shape {tuple(q.shape)} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    B, H, N, hd = q.shape
    if hd % 2 or hd > max_hd or N < 1 or B * H > 65535:
        raise ValueError(f"the kernel takes an even hd <= {max_hd}, N >= 1 "
                         f"and B*H <= 65535; got {tuple(q.shape)}")


def _check_rows(q, named):
    for name, t in named:
        if (t.device != q.device or t.dtype != torch.float32
                or t.shape != q.shape[:3] or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous f32 (B, H, N) tensor "
                f"{tuple(q.shape[:3])} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def flash_attention(
    q: torch.Tensor,  # (B, H, N, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    *,
    return_lse: bool = False,
):
    """softmax(q k^T * scale) v, non-causal, per (batch, head); with
    `return_lse`, `(out, lse)` with the f32 (B, H, N) log-sum-exp of the
    scaled logits."""
    if q.device.type == "cpu":
        if return_lse:
            return flash_attention_lse_plain(q, k, v, scale)
        return flash_attention_plain(q, k, v, scale)
    _check_qkv(q, (("q", q), ("k", k), ("v", v)), 128)
    B, H, N, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, N), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, B * H, N, hd, float(scale),
        stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd_dkv(q, k, v, lse, do, di, scale: float):
    """`(dk, dv)` f32 (B, H, N, hd) of `flash_attention` from the forward's
    `lse`, the output gradient `do` and `di = sum(o * do, -1)`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, lse, do, di, scale)
    _check_qkv(q, (("q", q), ("k", k), ("v", v), ("do", do)), 80)
    _check_rows(q, (("lse", lse), ("di", di)))
    B, H, N, hd = q.shape
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn("flash_attention_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, N, hd, float(scale), stream)
    build.check(rc, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, lse, do, di, scale: float):
    """dq f32 (B, H, N, hd) of `flash_attention`, from the same inputs as
    `flash_attention_bwd_dkv`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, lse, do, di, scale)
    _check_qkv(q, (("q", q), ("k", k), ("v", v), ("do", do)), 80)
    _check_rows(q, (("lse", lse), ("di", di)))
    B, H, N, hd = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn("flash_attention_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B * H, N, hd,
        float(scale), stream)
    build.check(rc, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def _check_prologue(q, k, v, heads, q_norm, k_norm, rope, registers,
                    out_dtype):
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the kernel stores bf16, not {out_dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != torch.float32
                or t.dim() != 3 or t.shape != q.shape
                or not t.is_contiguous() or t.data_ptr() % 8):
            raise ValueError(
                f"{name} must be a contiguous 8-byte aligned f32 (B, N, D) "
                f"tensor of q's shape {tuple(q.shape)} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    B, N, D = q.shape
    hd = D // heads if heads > 0 else 0
    if heads < 1 or hd * heads != D or hd % 2 or not 2 <= hd <= 128:
        raise ValueError(f"the kernel takes D = heads hd with an even hd <= "
                         f"128; got D {D}, heads {heads}")
    if not 0 <= registers <= N:
        raise ValueError(f"registers must lie in [0, N = {N}], got "
                         f"{registers}")
    if (q_norm is None) != (k_norm is None):
        raise ValueError("q_norm and k_norm come together")
    named = [(f"{n}_norm {part}", t, (hd,))
             for n, pair in (("q", q_norm), ("k", k_norm)) if pair is not None
             for part, t in zip(("weight", "bias"), pair)]
    if rope is not None:
        named += [(name, t, (N - registers, hd // 2))
                  for name, t in zip(("cos", "sin"), rope)]
    for name, t, shape in named:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 8):
            raise ValueError(
                f"{name} must be a contiguous 8-byte aligned f32 {shape} "
                f"tensor on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def qkv_prologue(
    q: torch.Tensor,  # (B, N, heads hd) f32
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    *,
    q_norm=None,
    k_norm=None,
    rope=None,
    registers: int = 0,
    eps: float = 1e-5,
    out_dtype: torch.dtype = torch.bfloat16,
):
    """`qkv_prologue_plain` in one launch: the LayerNorms and the rotation in
    f32, each of q, k and v rounded once into the contiguous bf16 (B, heads,
    N, hd) that `flash_attention` takes (bf16 is the only `out_dtype` the
    kernel stores)."""
    kw = dict(q_norm=q_norm, k_norm=k_norm, rope=rope, registers=registers,
              eps=eps, out_dtype=out_dtype)
    if q.device.type == "cpu":
        return qkv_prologue_plain(q, k, v, heads, **kw)
    _check_prologue(q, k, v, heads, q_norm, k_norm, rope, registers,
                    out_dtype)
    B, N, D = q.shape
    hd = D // heads
    outs = tuple(torch.empty((B, heads, N, hd), dtype=torch.bfloat16,
                             device=q.device) for _ in range(3))
    (q_w, q_b), (k_w, k_b) = (
        (p if p is not None else (None, None)) for p in (q_norm, k_norm))
    cos, sin = rope if rope is not None else (None, None)
    ptrs = [t.data_ptr() if t is not None else None
            for t in (q, k, v, q_w, q_b, k_w, k_b, cos, sin, *outs)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn("qkv_prologue")(*ptrs, B, N, heads, hd, registers, float(eps),
                             stream)
    build.check(rc, "qkv_prologue")
    qkv_prologue.launches += 1
    return outs


qkv_prologue.launches = 0


# -----------------------------------------------------------------------------
# the differentiable attention

# (dkv, dq) that `flash_attention_train`'s backward calls instead of the
# wrappers, inside `backward_route` only
_route = None


@contextlib.contextmanager
def backward_route(dkv, dq):
    """Within the block, `flash_attention_train`'s backward calls
    `dkv(q, k, v, lse, do, di, scale)` and `dq(...)` in place of
    `flash_attention_bwd_dkv` and `flash_attention_bwd_dq`. A check uses it
    to record what the step's backward launched (functions that call the
    wrappers, whose counts go on as ever) or to run the step's backward on
    the plain versions from the same forward."""
    global _route
    saved, _route = _route, (dkv, dq)
    try:
        yield
    finally:
        _route = saved


class _FlashAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, compute_dtype):
        qc, kc, vc = (t.to(compute_dtype).contiguous() for t in (q, k, v))
        o, lse = flash_attention(qc, kc, vc, scale, return_lse=True)
        ctx.save_for_backward(qc, kc, vc, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dkv, dq = _route or (flash_attention_bwd_dkv, flash_attention_bwd_dq)
        do = do.to(q.dtype).contiguous()
        di = attention_di(o, do)
        dk, dv = dkv(q, k, v, lse, do, di, ctx.scale)
        return dq(q, k, v, lse, do, di, ctx.scale), dk, dv, None, None


def flash_attention_train(
    q: torch.Tensor,  # (B, H, N, hd) f32
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Differentiable `flash_attention` of q, k and v cast to
    `compute_dtype` (as the JAX package casts them): the output in
    `compute_dtype`, the gradients of q, k and v in f32 from the dkv and dq
    kernels."""
    return _FlashAttentionTrain.apply(q, k, v, scale, compute_dtype)
