"""The differentiable forward of the Primus v2 ViT, for its pretraining step.

The counterpart of the JAX package's `primus_apply` under `jax.grad`
(`anatomix_tpu/models/vit3d/primus.py`), over the port's ViT state dict
(`convert.from_jax_primus_params` layout, the keys of `Primus.state_dict()`)
as a flat dict of f32 leaves. It computes what `Primus.forward` computes,
with gradients:
- the tokenizer's stride-1 convs (zero padding) on
  `kernels/conv_train.conv3x3x3_train` (K1 forward, T-x dx, T-w dW; the stem
  takes no dx) and its stride-2 convs on `kernels/conv_down.conv_down2_train`
  (V2 forward, T-x and T-w on the zero-inserted gradient); as on the
  inference path, the stem reads the f32 volume as two bf16 terms `hi + lo`
  (its weights repeated along Ci) and every tokenizer conv stores f32, since
  an instance norm follows each one;
- instance norm (the one-pass E[x^2] - E[x]^2 statistics of the JAX
  package's `instance_norm` and of the inference path) + LeakyReLU(0.01)
  (+ the residual) as f32 torch autograd;
- attention on `kernels/attention.flash_attention_train` (V3 forward with
  the log-sum-exp, the dkv and dq kernels backward), q, k and v cast to the
  compute dtype; the linears, LayerNorms, RoPE, LayerScale, registers and
  position embedding as f32 torch autograd, the precision split of the
  inference path;
- the decoder's per-sub-voxel GEMMs on `torch.matmul` in the compute dtype,
  the channel LayerNorm and tanh-GELU in f32, and the exit on V1
  (`depth_to_space8_ndhwc`, which subtracts the `demean` mean in f32) in an
  autograd Function whose backward is the inverse permutation of
  `g - mean_c(g)` as torch glue. The walk takes the `demean` output norm
  only, the one `build_all` sets.
`plain=True` is the f32 plain path: `F.conv3d`, einsum/softmax attention and
torch's reshapes under autograd.
"""

from __future__ import annotations

import functools
import math
from typing import Mapping

import torch
import torch.nn.functional as F

from anatomix_tpu_torch.kernels.attention import (
    flash_attention_plain,
    flash_attention_train,
)
from anatomix_tpu_torch.kernels.conv_down import conv_down2_train
from anatomix_tpu_torch.kernels.conv_train import conv3x3x3_train
from anatomix_tpu_torch.kernels.reshuffle import (
    depth_to_space8_ndhwc,
    depth_to_space8_ndhwc_plain,
)
from anatomix_tpu_torch.models.vit3d.primus import (
    TOKENIZER_LRELU_SLOPE,
    PrimusConfig,
    _apply_rope,
    _out_norm_mode,
    _rope_tables,
    check_supported,
)
from anatomix_tpu_torch.ops.conv import conv3d_down2, conv3d_same
from anatomix_tpu_torch.ops.norms import channel_layer_norm, instance_norm

Params = Mapping[str, torch.Tensor]


@functools.lru_cache(maxsize=8)
def _rope(cfg: PrimusConfig, device: str):
    return tuple(t.to(device) for t in _rope_tables(cfg))


class _Exit8Demean(torch.autograd.Function):
    """(B, d, h, w, 512 C) block tensor -> f32 (B, 8d, 8h, 8w, C) volume on
    V1, minus each channel's mean."""

    @staticmethod
    def forward(ctx, y):
        B, C = y.shape[0], y.shape[-1] // 512
        # the per-channel mean over every voxel and sub-position is the
        # full-resolution mean
        m = torch.mean(y.reshape(B, -1, C), dim=1, dtype=torch.float32)
        ctx.block_shape = y.shape
        ctx.dtype = y.dtype
        return depth_to_space8_ndhwc(y, m.repeat(1, 512).contiguous())

    @staticmethod
    def backward(ctx, g):
        g = g - g.mean(dim=(1, 2, 3), keepdim=True)
        B, d, h, w, c512 = ctx.block_shape
        t = g.reshape(B, d, 2, 2, 2, h, 2, 2, 2, w, 2, 2, 2, c512 // 512)
        t = t.permute(0, 1, 5, 9, 2, 6, 10, 3, 7, 11, 4, 8, 12, 13)
        return t.reshape(ctx.block_shape).to(ctx.dtype)


def _norm_act(cfg, y, residual=None):
    y = instance_norm(y, eps=cfg.in_eps)
    if residual is not None:
        y = y + residual
    return F.leaky_relu(y, TOKENIZER_LRELU_SLOPE)


def _tokenizer(cfg, p: Params, x, cd, plain):
    """`_tokenizer_v2`: (B, D, H, W, 1) f32 -> (B, d, h, w, E) f32."""
    f32 = torch.float32

    def conv(key, v):
        w, b = p[f"{key}.weight"], p[f"{key}.bias"]
        if plain:
            return conv3d_same(v, w, b, pad_type="zeros")
        return conv3x3x3_train(v.to(cd).contiguous(), w, b, "zeros",
                               out_dtype=f32)

    def down(key, v):
        w, b = p[f"{key}.weight"], p[f"{key}.bias"]
        if plain:
            return conv3d_down2(v, w, b)
        return conv_down2_train(v.to(cd).contiguous(), w, b)

    w, b = p["tokenizer.stem.weight"], p["tokenizer.stem.bias"]
    if plain:
        y = conv3d_same(x, w, b, pad_type="zeros")
    else:
        # the f32 volume exactly as hi + lo terms in the compute dtype
        # against repeated weights (lo is zero when that is f32)
        hi = x.to(cd)
        xin = torch.cat([hi, (x - hi.float()).to(cd)], dim=-1)
        y = conv3x3x3_train(xin, torch.cat([w, w], dim=1), b, "zeros",
                            out_dtype=f32)
    y = _norm_act(cfg, y)
    for i, depth in enumerate(cfg.tokenizer_depth_per_level):
        base = f"tokenizer.stages.{i}"
        y = _norm_act(cfg, down(f"{base}.down", y))
        for j in range(depth):
            z = _norm_act(cfg, conv(f"{base}.blocks.{j}.conv1", y))
            z = conv(f"{base}.blocks.{j}.conv2", z)
            y = _norm_act(cfg, z, residual=y)
    w = p["tokenizer.proj.weight"]
    return torch.matmul(y, w.reshape(w.shape[0], -1).t()) + \
        p["tokenizer.proj.bias"]


def _ln(p: Params, key, x, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{key}.weight"],
                        p[f"{key}.bias"], eps)


def _linear(p: Params, key, x):
    return F.linear(x, p[f"{key}.weight"], p.get(f"{key}.bias"))


def _attention(cfg, p: Params, base, h, cd, plain):
    B, N, D = h.shape
    H, hd, R = cfg.eva_numheads, cfg.head_dim, cfg.num_register_tokens
    q = _linear(p, f"{base}.q_proj", h).view(B, N, H, hd)
    k = _linear(p, f"{base}.k_proj", h).view(B, N, H, hd)
    v = _linear(p, f"{base}.v_proj", h).view(B, N, H, hd)
    if cfg.qk_norm:
        q = _ln(p, f"{base}.q_norm", q, 1e-5)
        k = _ln(p, f"{base}.k_norm", k, 1e-5)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, hd)
    if cfg.use_rot_pos_emb:
        cos, sin = _rope(cfg, str(h.device))
        q = torch.cat([q[:, :, :R], _apply_rope(q[:, :, R:], cos, sin)],
                      dim=2)
        k = torch.cat([k[:, :, :R], _apply_rope(k[:, :, R:], cos, sin)],
                      dim=2)
    scale = 1.0 / math.sqrt(hd)
    if plain:
        o = flash_attention_plain(q, k, v, scale)
    else:
        o = flash_attention_train(q, k, v, scale, cd)
    o = o.transpose(1, 2).reshape(B, N, D).float()
    if cfg.scale_attn_inner:
        o = _ln(p, f"{base}.attn_inner_norm", o, 1e-6)
    return _linear(p, f"{base}.proj", o)


def _decoder(cfg, p: Params, grid, cd, plain):
    """`_decoder`: (B, d, h, w, E) -> f32 (B, 8d, 8h, 8w, C), demeaned (the
    final bias cancels). Each stride-2 kernel-2 transposed conv is one GEMM
    into block layout, sub-positions coarsest first."""
    B, d, h, w, _ = grid.shape
    y = grid.to(cd)
    K = 1
    n = len([k for k in p if k.startswith("decoder.")
             and k.endswith(".weight")])
    for i in range(n):
        wt, b = p[f"decoder.{i}.weight"], p[f"decoder.{i}.bias"]
        ci, co = wt.shape[:2]
        w2 = wt.permute(0, 2, 3, 4, 1).reshape(ci, 8 * co).to(cd)
        y = torch.matmul(y.reshape(B, d, h, w, K, ci), w2)
        K *= 8
        y = y.reshape(B, d, h, w, K, co)
        if i < n - 1:
            # jax.nn.gelu defaults to the tanh approximation
            y = F.gelu(channel_layer_norm(y.float() + b, eps=1e-6),
                       approximate="tanh").to(cd)
    y = y.reshape(B, d, h, w, K * y.shape[-1])
    if plain:
        vol = depth_to_space8_ndhwc_plain(y)
        return vol - vol.mean(dim=(1, 2, 3), keepdim=True)
    return _Exit8Demean.apply(y.contiguous())


def primus_train_apply(
    cfg: PrimusConfig,
    params: Params,
    x: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
) -> torch.Tensor:
    """The f32 (B, D, H, W, num_classes) output volume of NDHWC `x` (spatial
    `cfg.input_shape`, or (B, D, H, W)), differentiable with respect to
    every leaf of `params`. `plain=True` runs the f32 plain path."""
    check_supported(cfg)
    if _out_norm_mode(cfg.out_norm) not in ("demean", "center"):
        raise NotImplementedError(
            "the ViT's train walk takes the 'demean' output norm, which "
            "build_all sets")
    if x.dim() == 4:
        x = x[..., None]
    if tuple(x.shape[1:4]) != tuple(cfg.input_shape):
        raise ValueError(f"Primus is bound to input_shape={cfg.input_shape};"
                         f" got {tuple(x.shape[1:4])}")
    cd = torch.float32 if plain else compute_dtype
    B = x.shape[0]
    grid = _tokenizer(cfg, params, x.float().contiguous(), cd, plain)
    tokens = grid.reshape(B, cfg.num_tokens, cfg.embed_dim)
    if cfg.use_abs_pos_embed:
        tokens = tokens + params["pos_embed"]
    R = cfg.num_register_tokens
    if R > 0:
        tokens = torch.cat([params["register_tokens"].expand(
            B, R, cfg.embed_dim), tokens], dim=1)
    for i in range(cfg.eva_depth):
        base = f"blocks.{i}"
        a = _attention(cfg, params, base, _ln(params, f"{base}.norm1",
                                               tokens, 1e-6), cd, plain)
        if cfg.init_values is not None:
            a = a * params[f"{base}.gamma1"]
        tokens = tokens + a
        h = _ln(params, f"{base}.norm2", tokens, 1e-6)
        m = _linear(params, f"{base}.mlp_w3",
                    F.silu(_linear(params, f"{base}.mlp_w1", h))
                    * _linear(params, f"{base}.mlp_w2", h))
        if cfg.init_values is not None:
            m = m * params[f"{base}.gamma2"]
        tokens = tokens + m
    tokens = _ln(params, "norm", tokens, 1e-6)[:, R:]
    grid = tokens.reshape(B, *cfg.grid_shape, cfg.embed_dim)
    return _decoder(cfg, params, grid, cd, plain)
