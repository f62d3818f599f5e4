"""The differentiable forward of the Primus ViT, for its pretraining step.

The counterpart of the JAX package's `primus_apply` under `jax.grad`
(`anatomix_tpu/models/vit3d/primus.py`), over the port's ViT state dict
(`convert.from_jax_primus_params` layout, the keys of `Primus.state_dict()`)
as a flat dict of f32 leaves. It takes every config `Primus.forward` takes
(`primus.check_supported`) and computes what that forward computes, with
gradients:
- v2's tokenizer: its stride-1 convs (zero padding) on
  `kernels/conv_train.conv3x3x3_train` (K1 forward, T-x dx, T-w dW; the stem
  takes no dx) and its stride-2 convs on `kernels/conv_down.conv_down2_train`
  (V2 forward, T-x and T-w in their stride-2 mode); as on the
  inference path, the stem reads the f32 volume as two bf16 terms `hi + lo`
  (its weights repeated along Ci) and every tokenizer conv stores f32, since
  an instance norm follows each one; instance norm (the one-pass
  E[x^2] - E[x]^2 statistics of the JAX package's `instance_norm` and of
  the inference path) + LeakyReLU(0.01) (+ the residual) as f32 torch
  autograd;
- v1's patch embed: the inference path's f32 block-layout chain on the
  volume (`space_to_depth_c1_ndhwc`, L-c1, then `log2(p) - 1`
  `space_to_depth2_ndhwc`, L), outside autograd since the image takes no
  gradient, then one f32 `torch.matmul` against the `tokenizer.proj.weight`
  leaf permuted to the chain's lanes (`primus._patch_embed_matrix`, a
  differentiable permutation, so dW lands in the leaf's (E, Ci, p, p, p)
  layout), the bias and the token LayerNorm (eps 1e-6), f32 autograd;
- attention on `kernels/attention.flash_attention_train` (V3 forward with
  the log-sum-exp, the dkv and dq kernels backward), q, k and v cast to the
  compute dtype; the linears, LayerNorms, RoPE, LayerScale, registers and
  position embedding as f32 torch autograd, the precision split of the
  inference path;
- the decoder's GEMMs on `torch.matmul` in the compute dtype. Three stages
  (patch 8) run in block space with the channel LayerNorm and tanh-GELU in
  f32 between them and exit on V1 (`depth_to_space8_ndhwc`), which
  subtracts in f32 the `demean` mean or, under any other output norm, the
  final bias's negative, in an autograd Function whose backward is the
  inverse permutation as torch glue (of `g - mean_c(g)` under `demean`).
  Any other number of stages runs the inference model's stage path: each
  GEMM into the block layout, `reshuffle.depth_to_space2` (L; its backward
  is `space_to_depth2_ndhwc`), the bias, the channel LayerNorm and GELU in
  f32; the last stage exits on `depth_to_space_interleave_ndhwc` (L-il, f32,
  minus the mean or the final bias's negative) in a Function whose backward
  is `space_to_depth2_ndhwc` of `g` (`g - mean_c(g)` under `demean`) in the
  compute dtype. The output norms `none`, `instance` and `layernorm` (and
  their aliases) then run as f32 torch autograd (`primus.build_out_norm`).
`plain=True` is the f32 plain path: `F.conv3d` (stride p for v1's patch
embed), einsum/softmax attention and torch's reshapes under autograd.
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
    depth_to_space2,
    depth_to_space2_ndhwc_plain,
    depth_to_space8_ndhwc,
    depth_to_space8_ndhwc_plain,
    depth_to_space_interleave_ndhwc,
    space_to_depth2_ndhwc,
    space_to_depth_c1_ndhwc,
)
from anatomix_tpu_torch.models.vit3d.primus import (
    TOKENIZER_LRELU_SLOPE,
    PrimusConfig,
    _apply_rope,
    _out_norm_mode,
    _patch_embed_matrix,
    _rope_tables,
    build_out_norm,
    check_supported,
)
from anatomix_tpu_torch.ops.conv import conv3d_down2, conv3d_same
from anatomix_tpu_torch.ops.norms import channel_layer_norm, instance_norm

Params = Mapping[str, torch.Tensor]


def check_train_supported(cfg: PrimusConfig) -> None:
    """Raise on the configs the train walk does not run: those
    `Primus.forward` does not run (`primus.check_supported`)."""
    check_supported(cfg)


@functools.lru_cache(maxsize=8)
def _rope(cfg: PrimusConfig, device: str):
    return tuple(t.to(device) for t in _rope_tables(cfg))


def _exit_sub(y, b, groups):
    """The exit's f32 subtract (B, groups C) of block tensor `y` (..., groups
    C): each channel's mean over every voxel and sub-position (the
    full-resolution mean; the final bias cancels under `demean`) when `b` is
    None, else the final bias's negative."""
    B, C = y.shape[0], y.shape[-1] // groups
    if b is None:
        m = torch.mean(y.reshape(B, -1, C), dim=1, dtype=torch.float32)
        return m.repeat(1, groups).contiguous()
    return (-b.float()).repeat(groups)[None].expand(B, -1).contiguous()


def _exit_grads(ctx, g):
    """`g` minus its channel means under `demean`, and the final bias's
    gradient otherwise."""
    if ctx.demean:
        return g - g.mean(dim=(1, 2, 3), keepdim=True), None
    return g, g.sum(dim=(0, 1, 2, 3))


class _Exit8(torch.autograd.Function):
    """(B, d, h, w, 512 C) block tensor -> f32 (B, 8d, 8h, 8w, C) volume on
    V1, minus each channel's mean (`b` None: `demean`) or plus the final
    bias `b`."""

    @staticmethod
    def forward(ctx, y, b):
        ctx.demean = b is None
        ctx.block_shape = y.shape
        ctx.dtype = y.dtype
        return depth_to_space8_ndhwc(y, _exit_sub(y, b, 512))

    @staticmethod
    def backward(ctx, g):
        g, db = _exit_grads(ctx, g)
        B, d, h, w, c512 = ctx.block_shape
        t = g.reshape(B, d, 2, 2, 2, h, 2, 2, 2, w, 2, 2, 2, c512 // 512)
        t = t.permute(0, 1, 5, 9, 2, 6, 10, 3, 7, 11, 4, 8, 12, 13)
        return t.reshape(ctx.block_shape).to(ctx.dtype), db


class _ExitInterleave(torch.autograd.Function):
    """The stage path's last stage: (B, d, h, w, 8 C) block tensor -> f32
    (B, 2d, 2h, 2w, C) on L-il, minus each channel's mean (`b` None:
    `demean`) or plus the final bias `b`; the backward is L's
    space-to-depth."""

    @staticmethod
    def forward(ctx, yb, b):
        ctx.demean = b is None
        ctx.dtype = yb.dtype
        return depth_to_space_interleave_ndhwc(yb, _exit_sub(yb, b, 8),
                                               out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        g, db = _exit_grads(ctx, g)
        return space_to_depth2_ndhwc(g.to(ctx.dtype).contiguous()), db


def _norm_act(cfg, y, residual=None):
    y = instance_norm(y, eps=cfg.in_eps)
    if residual is not None:
        y = y + residual
    return F.leaky_relu(y, TOKENIZER_LRELU_SLOPE)


def _tokenizer(cfg, p: Params, x, cd, plain):
    """`_tokenizer_v2`: (B, D, H, W, 1) f32 -> (B, d, h, w, E) f32."""
    f32 = torch.float32

    # in bf16 each conv reads its f32 input and weights through the
    # three-term split (`ops/conv.split3`), as the inference path does; the
    # backward runs on their bf16 roundings
    split = cd == torch.bfloat16

    def conv(key, v):
        w, b = p[f"{key}.weight"], p[f"{key}.bias"]
        if plain:
            return conv3d_same(v, w, b, pad_type="zeros")
        v = v.contiguous() if split else v.to(cd).contiguous()
        return conv3x3x3_train(v, w, b, "zeros", out_dtype=f32, split=split)

    def down(key, v):
        w, b = p[f"{key}.weight"], p[f"{key}.bias"]
        if plain:
            return conv3d_down2(v, w, b)
        v = v.contiguous() if split else v.to(cd).contiguous()
        return conv_down2_train(v, w, b, split=split)

    y = conv("tokenizer.stem", x)
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


def _tokenizer_v1(cfg, p: Params, x, plain):
    """v1's patch embed: (B, D, H, W, Ci) f32 -> (B, d, h, w, E) f32, the
    stride-p conv and the token LayerNorm (eps 1e-6)."""
    w, b = p["tokenizer.proj.weight"], p["tokenizer.proj.bias"]
    if plain:
        grid = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b,
                        stride=tuple(cfg.patch_embed_size))
        grid = grid.permute(0, 2, 3, 4, 1)
    else:
        # the chain moves the data, which takes no gradient
        xb = (space_to_depth_c1_ndhwc(x[..., 0].contiguous())
              if x.shape[-1] == 1 else space_to_depth2_ndhwc(x))
        for _ in range(int(round(math.log2(cfg.patch_embed_size[0]))) - 1):
            xb = space_to_depth2_ndhwc(xb)
        grid = torch.matmul(xb, _patch_embed_matrix(w)) + b
    return _ln(p, "tokenizer.norm", grid, 1e-6)


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


def _decoder_weights(p: Params, cd):
    """Each stage's GEMM weight (ci, 8 co), columns (kd, kh, kw, co), in
    `cd`, and its bias."""
    n = len([k for k in p if k.startswith("decoder.")
             and k.endswith(".weight")])
    out = []
    for i in range(n):
        wt = p[f"decoder.{i}.weight"]
        ci, co = wt.shape[:2]
        out.append((wt.permute(0, 2, 3, 4, 1).reshape(ci, 8 * co).to(cd),
                    p[f"decoder.{i}.bias"]))
    return out


def _gelu_ln(y):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(channel_layer_norm(y, eps=1e-6), approximate="tanh")


def _decoder(cfg, p: Params, grid, cd, plain):
    """`_decoder`: (B, d, h, w, E) -> f32 (B, pd, ph, pw, C), out-norm
    applied. Three stages run in block space (each stride-2 kernel-2
    transposed conv one GEMM into block layout, sub-positions coarsest
    first), any other number stage by stage."""
    demean = _out_norm_mode(cfg.out_norm) in ("demean", "center")
    stages = _decoder_weights(p, cd)
    if len(stages) == 3:
        B, d, h, w, _ = grid.shape
        y = grid.to(cd)
        K = 1
        for i, (w2, b) in enumerate(stages):
            ci, co = w2.shape[0], w2.shape[1] // 8
            y = torch.matmul(y.reshape(B, d, h, w, K, ci), w2)
            K *= 8
            y = y.reshape(B, d, h, w, K, co)
            if i < 2:
                y = _gelu_ln(y.float() + b).to(cd)
        y = y.reshape(B, d, h, w, K * y.shape[-1])
        if plain:
            vol = depth_to_space8_ndhwc_plain(y) + b
        else:
            vol = _Exit8.apply(y.contiguous(), None if demean else b)
            if demean:
                return vol
    else:
        y = grid.to(cd)
        for i, (w2, b) in enumerate(stages):
            yb = torch.matmul(y, w2)  # (B, d, h, w, 8 co) in cd
            if i == len(stages) - 1:
                break
            y = (depth_to_space2_ndhwc_plain(yb) if plain
                 else depth_to_space2(yb.contiguous()))
            y = _gelu_ln(y.float() + b).to(cd)
        if plain:
            vol = depth_to_space2_ndhwc_plain(yb).float() + b
        else:
            vol = _ExitInterleave.apply(yb.contiguous(),
                                        None if demean else b)
            if demean:
                return vol
    return build_out_norm(cfg.out_norm, cfg.out_norm_eps)(vol)


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
    check_train_supported(cfg)
    if x.dim() == 4:
        x = x[..., None]
    if tuple(x.shape[1:4]) != tuple(cfg.input_shape):
        raise ValueError(f"Primus is bound to input_shape={cfg.input_shape};"
                         f" got {tuple(x.shape[1:4])}")
    cd = torch.float32 if plain else compute_dtype
    B = x.shape[0]
    x = x.float().contiguous()
    grid = (_tokenizer(cfg, params, x, cd, plain) if cfg.version == "v2"
            else _tokenizer_v1(cfg, params, x, plain))
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
