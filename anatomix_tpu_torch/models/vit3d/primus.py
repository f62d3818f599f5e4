"""Primus, the 26M `anatomix-dev-vit` 3D ViT, on the port's kernels.

The port of `anatomix_tpu/models/vit3d/primus.py`: a tokenizer, EVA blocks
(pre-norm, q/k/v projections with no k bias, per-head q/k LayerNorm, axial
rotary embedding on the non-register tokens, learned absolute position
embedding, register tokens, the inner attention norm, LayerScale, SwiGLU
MLP), the final norm, and the patch decoder (`log2(patch)` stride-2
kernel-2 transposed convs as per-sub-voxel GEMMs on the token grid,
tanh-GELU after a channel LayerNorm between stages) with its output norm.
The tokenizer is v2's residual conv tower (stem, three stride-2 stages with
instance norm + LeakyReLU(0.01) residual blocks, a 1x1x1 projection; patch
8^3) or v1's single patch-embed conv (stride = kernel = any cubic
power-of-two patch) and its token LayerNorm.

The model is an `nn.Module` whose state dict mirrors the JAX pytree in
torch layouts (`convert.from_jax_primus_params`). Its forward runs, in
`compute_dtype`, on the hand-written kernels:
- v2: the tokenizer's stride-1 convs on `conv3x3x3_ndhwc` (K1), zero
  padding, and its stride-2 convs on `conv_down2_ndhwc` (V2); in bf16
  each reads its input and weights as the three-term split of
  `ops/conv.split3` (an f32 product to about 2^-16), since an instance norm
  follows each of them and divides by a std that on a smooth volume is
  small against the values a bf16 rounding is relative to, and each stores
  f32; every instance norm + LeakyReLU(0.01) on `norm_apply_ndhwc` (D1),
  which stores the split, the residual block's `IN(conv2(...)) + r` through
  its residual operand; the statistics are torch reductions
  (`ops/norms.instance_norm_stats`);
- v1: the stride-p patch-embed conv as a block-layout chain,
  `space_to_depth_c1_ndhwc` on the channel-less window (L-c1) and
  `log2(p) - 1` `space_to_depth2_ndhwc` (L), then one f32 GEMM
  (`torch.matmul`, as JAX leaves it to XLA) against the weight permuted once
  to the chain's lane order, then the token LayerNorm. The chain moves the
  f32 volume: the LayerNorm divides out each patch's mean, so on a smooth
  volume what is left is the small variation within a patch, against which
  a bf16 rounding of the input (relative to the mean) would not be small;
- attention on `flash_attention` (V3), fed by `qkv_prologue`, which takes
  the f32 q/k/v projections through the per-head q/k LayerNorm and RoPE in
  f32 and stores q, k and v once in the compute dtype, in V3's (B, H, N,
  hd) layout (the JAX package casts them as well); the residual stream,
  the linears, the other LayerNorms and the MLP are f32 torch glue, as they
  are XLA in JAX;
- the decoder's GEMMs on `torch.matmul` in the compute dtype. With three
  stages and `emit="spatial"` it runs in block space (the JAX package's
  `_decoder_block_space`) and exits on `depth_to_space8_ndhwc` (V1), which
  subtracts the `demean` mean (or the final bias) in f32 and writes the f32
  volume. Otherwise it runs stage by stage (JAX's `_decoder` stage path):
  each GEMM into the block layout, `depth_to_space2_ndhwc` (L), the bias,
  and between stages the channel LayerNorm and GELU, in the compute dtype;
  under `demean` the last stage exits on `depth_to_space_fold_ndhwc`
  (`emit="fold"`: the compute-dtype folded rows the sliding stitch reads)
  or `depth_to_space_interleave_ndhwc` (`emit="spatial"`: f32), each
  subtracting the mean in f32.
`plain=True` runs each kernel's plain PyTorch version instead (with
`compute_dtype=torch.float32`, the port's f32 plain path); on CPU tensors
the kernel wrappers run their plain versions anyway.

RoPE is the interleaved form (`_apply_rope`, pairs (2i, 2i+1)); the JAX
package's rotate-half form on permuted q/k channels gives the same scores.
`forward`'s `record` hook receives each stage's output (the tokenizer grid,
each block's residual stream, the final norm, each decoder GEMM), which
`chip_smoke.py` reads to bisect the bf16 path's error. `record_function`
ranges (opened only while a profiler runs, `utils/profiling.annotate`):
`vit/tokenizer` around the tokenizer, per block `vit/attention` (norm1, the
projections, the prologue, V3, the inner norm and proj) and `vit/mlp`
(norm2 and the SwiGLU MLP), and `vit/decoder` around the decoder and its
exit.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anatomix_tpu_torch.device import resolve_device
from anatomix_tpu_torch.kernels.attention import (
    flash_attention,
    flash_attention_plain,
    qkv_prologue,
    qkv_prologue_plain,
)
from anatomix_tpu_torch.kernels.conv import (
    conv3x3x3_ndhwc,
    conv3x3x3_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.conv_down import (
    conv_down2_ndhwc,
    conv_down2_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.norm import (
    norm_apply_ndhwc,
    norm_apply_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.reshuffle import (
    depth_to_space2_ndhwc,
    depth_to_space2_ndhwc_plain,
    depth_to_space8_ndhwc,
    depth_to_space8_ndhwc_plain,
    depth_to_space_fold_ndhwc,
    depth_to_space_fold_ndhwc_plain,
    depth_to_space_interleave_ndhwc,
    depth_to_space_interleave_ndhwc_plain,
    fold_rows,
    fold_supported,
    space_to_depth2_ndhwc,
    space_to_depth2_ndhwc_plain,
    space_to_depth_c1_ndhwc,
    space_to_depth_c1_ndhwc_plain,
)
from anatomix_tpu_torch.ops.conv import (
    merge3,
    pack_conv_weight,
    split3,
    split3_weight,
)
from anatomix_tpu_torch.ops.norms import (
    channel_demean,
    channel_layer_norm,
    fold_affine,
    instance_norm,
    instance_norm_stats,
    tile_maps,
)
from anatomix_tpu_torch.utils.profiling import annotate

PRIMUS_CONFIGS = {
    "S": {"eva_depth": 12, "eva_numheads": 6, "embed_dim": 396},
    "B": {"eva_depth": 12, "eva_numheads": 12, "embed_dim": 792},
    "M": {"eva_depth": 16, "eva_numheads": 12, "embed_dim": 864},
    "L": {"eva_depth": 24, "eva_numheads": 16, "embed_dim": 1056},
}

# the tokenizer's LeakyReLU slope (`primus._tokenizer_v2`); the JAX TPU path
# runs 0.2 instead (ROADMAP F1), the port passes 0.01 everywhere
TOKENIZER_LRELU_SLOPE = 0.01

_KERNELS = SimpleNamespace(conv=conv3x3x3_ndhwc, down=conv_down2_ndhwc,
                           norm=norm_apply_ndhwc, attn=flash_attention,
                           prologue=qkv_prologue,
                           d2s8=depth_to_space8_ndhwc,
                           d2s2=depth_to_space2_ndhwc,
                           s2d2=space_to_depth2_ndhwc,
                           c1=space_to_depth_c1_ndhwc,
                           fold=depth_to_space_fold_ndhwc,
                           interleave=depth_to_space_interleave_ndhwc)
_PLAIN = SimpleNamespace(conv=conv3x3x3_ndhwc_plain,
                         down=conv_down2_ndhwc_plain,
                         norm=norm_apply_ndhwc_plain,
                         attn=flash_attention_plain,
                         prologue=qkv_prologue_plain,
                         d2s8=depth_to_space8_ndhwc_plain,
                         d2s2=depth_to_space2_ndhwc_plain,
                         s2d2=space_to_depth2_ndhwc_plain,
                         c1=space_to_depth_c1_ndhwc_plain,
                         fold=depth_to_space_fold_ndhwc_plain,
                         interleave=depth_to_space_interleave_ndhwc_plain)

EMITS = ("spatial", "fold")


@dataclasses.dataclass(frozen=True)
class PrimusConfig:
    input_channels: int = 1
    num_classes: int = 32
    embed_dim: int = 396
    eva_depth: int = 12
    eva_numheads: int = 6
    patch_embed_size: tuple = (8, 8, 8)
    input_shape: tuple = (128, 128, 128)
    num_register_tokens: int = 8
    init_values: float | None = 0.1
    scale_attn_inner: bool = False
    qk_norm: bool = False
    out_norm: str = "none"
    out_norm_eps: float = 1e-5
    register_init_std: float = 1e-6
    in_eps: float = 1e-5  # tokenizer InstanceNorm eps (v2)
    mlp_ratio: float = 4 * 2 / 3  # EVA-02 SwiGLU ratio
    use_rot_pos_emb: bool = True
    use_abs_pos_embed: bool = True
    version: str = "v2"  # 'v1' single-conv patch embed; 'v2' deep tokenizer
    tokenizer_base_features: int = 32
    tokenizer_depth_per_level: tuple = (1, 1, 1)
    rope_theta: float = 100.0

    @property
    def grid_shape(self):
        return tuple(
            s // p for s, p in zip(self.input_shape, self.patch_embed_size)
        )

    @property
    def num_tokens(self):
        g = self.grid_shape
        return g[0] * g[1] * g[2]

    @property
    def head_dim(self):
        return self.embed_dim // self.eva_numheads

    @property
    def mlp_hidden(self):
        return int(self.embed_dim * self.mlp_ratio)


def primus_config(vit_kwargs: dict[str, Any]) -> PrimusConfig:
    """The v2 config of a registry entry's `vit_kwargs` (as the JAX
    package's `load_primus_v2` builds it)."""
    kw = dict(vit_kwargs)
    for key in ("patch_embed_size", "input_shape"):
        kw[key] = tuple(kw[key])
    return PrimusConfig(version="v2", **kw)


def check_supported(cfg: PrimusConfig) -> None:
    """Raise on the options the port does not run: v2 downsamples by 8 in
    three stages (patch 8^3), v1 takes a cubic power-of-two patch of 2 or
    more that divides the input."""
    p = tuple(cfg.patch_embed_size)
    if cfg.version == "v2":
        if p != (8, 8, 8):
            raise NotImplementedError(
                "the v2 tokenizer downsamples by 8: patch 8^3 only")
        if len(cfg.tokenizer_depth_per_level) != 3:
            raise NotImplementedError("the v2 tokenizer has three stages")
    elif cfg.version == "v1":
        if len(set(p)) != 1 or p[0] < 2 or p[0] & (p[0] - 1):
            raise NotImplementedError(
                f"v1 takes a cubic power-of-two patch of 2 or more, got {p}")
    else:
        raise ValueError(f"unknown Primus version {cfg.version!r}")
    if any(s % q for s, q in zip(cfg.input_shape, p)):
        raise NotImplementedError(
            f"patch {p} must divide input_shape {cfg.input_shape}")


def _out_norm_mode(mode) -> str:
    if isinstance(mode, bool):
        mode = "instance" if mode else "none"
    return (mode or "none").lower()


def build_out_norm(mode, eps: float):
    """Output-volume normalization of NDHWC volumes (the JAX package's
    `build_out_norm`)."""
    mode = _out_norm_mode(mode)
    if mode in ("none", "identity", "off"):
        return lambda x: x
    if mode in ("instance", "instancenorm", "in"):
        return lambda x: instance_norm(x, eps=eps)
    if mode in ("demean", "center"):
        return channel_demean
    if mode in ("layernorm", "layer", "ln"):
        return lambda x: channel_layer_norm(x, eps=eps)
    raise ValueError(f"unsupported output normalization: {mode!r}")


# -----------------------------------------------------------------------------
# the module

def _tokenizer_widths(cfg: PrimusConfig):
    """(ci, co) of each stride-2 stage and the tokenizer's last width."""
    ch = cfg.tokenizer_base_features
    stages = []
    for _ in cfg.tokenizer_depth_per_level:
        out = min(ch * 2, cfg.embed_dim)
        stages.append((ch, out))
        ch = out
    return stages, ch


def _decoder_widths(cfg: PrimusConfig):
    """(ci, co) of each of the `log2(patch)` transposed-conv stages."""
    n_up = int(round(math.log2(cfg.patch_embed_size[0])))
    ch, widths = cfg.embed_dim, []
    for i in range(n_up):
        out = cfg.num_classes if i == n_up - 1 else max(ch // 2, 32)
        widths.append((ch, out))
        ch = out
    return widths


class _ResBlock(nn.Module):
    def __init__(self, ch, device):
        super().__init__()
        self.conv1 = nn.Conv3d(ch, ch, 3, device=device)
        self.conv2 = nn.Conv3d(ch, ch, 3, device=device)


class _Stage(nn.Module):
    def __init__(self, ci, co, depth, device):
        super().__init__()
        self.down = nn.Conv3d(ci, co, 3, device=device)
        self.blocks = nn.ModuleList(
            _ResBlock(co, device) for _ in range(depth))


class _Tokenizer(nn.Module):
    def __init__(self, cfg: PrimusConfig, device):
        super().__init__()
        stages, ch = _tokenizer_widths(cfg)
        self.stem = nn.Conv3d(cfg.input_channels,
                              cfg.tokenizer_base_features, 3, device=device)
        self.stages = nn.ModuleList(
            _Stage(ci, co, depth, device) for (ci, co), depth in
            zip(stages, cfg.tokenizer_depth_per_level))
        self.proj = nn.Conv3d(ch, cfg.embed_dim, 1, device=device)


class _PatchEmbed(nn.Module):
    """v1: the stride = kernel = patch conv and the token LayerNorm."""

    def __init__(self, cfg: PrimusConfig, device):
        super().__init__()
        p = tuple(cfg.patch_embed_size)
        self.proj = nn.Conv3d(cfg.input_channels, cfg.embed_dim, p, stride=p,
                              device=device)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-6, device=device)


def _patch_embed_matrix(w: torch.Tensor) -> torch.Tensor:
    """The v1 patch-embed conv weight (E, Ci, p, p, p) as the (p^3 Ci, E)
    matrix of the block-layout chain's lanes: sub-positions (ad, ah, aw) of
    each factor-2 level, coarsest first, then the input channel."""
    E, ci, p = w.shape[0], w.shape[1], w.shape[2]
    n = int(round(math.log2(p)))
    t = w.reshape(E, ci, *(2,) * (3 * n))
    order = [a for level in range(n)
             for a in (2 + level, 2 + n + level, 2 + 2 * n + level)]
    return t.permute(*order, 1, 0).reshape(p ** 3 * ci, E)


class _EvaBlock(nn.Module):
    def __init__(self, cfg: PrimusConfig, device):
        super().__init__()
        d, hd = cfg.embed_dim, cfg.head_dim
        kw = dict(device=device)
        self.norm1 = nn.LayerNorm(d, eps=1e-6, **kw)
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, bias=False, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.proj = nn.Linear(d, d, **kw)
        if cfg.qk_norm:
            self.q_norm = nn.LayerNorm(hd, eps=1e-5, **kw)
            self.k_norm = nn.LayerNorm(hd, eps=1e-5, **kw)
        if cfg.scale_attn_inner:
            self.attn_inner_norm = nn.LayerNorm(d, eps=1e-6, **kw)
        if cfg.init_values is not None:
            self.gamma1 = nn.Parameter(torch.empty(d, **kw))
            self.gamma2 = nn.Parameter(torch.empty(d, **kw))
        self.norm2 = nn.LayerNorm(d, eps=1e-6, **kw)
        self.mlp_w1 = nn.Linear(d, cfg.mlp_hidden, **kw)
        self.mlp_w2 = nn.Linear(d, cfg.mlp_hidden, **kw)
        self.mlp_w3 = nn.Linear(cfg.mlp_hidden, d, **kw)


def _rope_tables(cfg: PrimusConfig):
    """Axial 3-D rotary tables (cos, sin), each (N, head_dim // 2) f32: 11
    pairs per axis at hd 66, theta 100, zero angles for the rest."""
    hd = cfg.head_dim
    per_axis = (hd // 2) // 3
    g = cfg.grid_shape
    coords = np.stack(np.meshgrid(np.arange(g[0]), np.arange(g[1]),
                                  np.arange(g[2]), indexing="ij"),
                      axis=-1).reshape(-1, 3)
    freqs = cfg.rope_theta ** (
        -np.arange(per_axis, dtype=np.float64) / max(per_axis, 1))
    angles = np.concatenate(
        [coords[:, a:a + 1] * freqs[None, :] for a in range(3)], axis=1)
    pad = hd // 2 - angles.shape[1]
    if pad > 0:
        angles = np.concatenate([angles, np.zeros((len(angles), pad))],
                                axis=1)
    return (torch.from_numpy(np.cos(angles).astype(np.float32)),
            torch.from_numpy(np.sin(angles).astype(np.float32)))


def _apply_rope(x, cos, sin):
    """Rotate the interleaved pairs (2i, 2i+1) of x (..., N, hd)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).flatten(-2)


class Primus(nn.Module):
    """The Primus ViT on `device` (the card unless the caller names another
    device; a CUDA device raises, as `resolve_device` does, when no card is
    present). `forward(x)` takes (B, D, H, W) or (B, D, H, W, Ci) f32 with
    spatial `cfg.input_shape` and returns the (B, D, H, W, num_classes)
    output volume, f32 (or, with `emit="fold"`, the folded rows of the
    stitch)."""

    def __init__(self, cfg: PrimusConfig, *,
                 device: str | torch.device = "cuda"):
        super().__init__()
        check_supported(cfg)
        if torch.device(device).type == "cuda":
            resolve_device(device)
        self.cfg = cfg
        kw = dict(device=device)
        d = cfg.embed_dim
        self.tokenizer = (_Tokenizer(cfg, device) if cfg.version == "v2"
                          else _PatchEmbed(cfg, device))
        if cfg.use_abs_pos_embed:
            self.pos_embed = nn.Parameter(torch.empty(cfg.num_tokens, d, **kw))
        if cfg.num_register_tokens > 0:
            self.register_tokens = nn.Parameter(
                torch.empty(cfg.num_register_tokens, d, **kw))
        self.blocks = nn.ModuleList(
            _EvaBlock(cfg, device) for _ in range(cfg.eva_depth))
        self.norm = nn.LayerNorm(d, eps=1e-6, **kw)
        self.decoder = nn.ModuleList(
            nn.ConvTranspose3d(ci, co, 2, stride=2, **kw)
            for ci, co in _decoder_widths(cfg))
        cos, sin = _rope_tables(cfg)
        self.register_buffer("rope_cos", cos.to(device), persistent=False)
        self.register_buffer("rope_sin", sin.to(device), persistent=False)
        self._packs: dict[torch.dtype, dict[str, Any]] = {}

    @classmethod
    def from_state_dict(cls, cfg, state_dict, *, device="cuda"):
        model = cls(cfg, device=device)
        model.load_state_dict(state_dict)
        return model.eval()

    def load_state_dict(self, *args, **kwargs):
        self._packs.clear()  # packed weights follow the parameters
        return super().load_state_dict(*args, **kwargs)

    def _pack(self, cd: torch.dtype) -> dict[str, Any]:
        """The kernels' weight layouts in compute dtype `cd`, packed once:
        v2 convs `(27 * Ci, Co)`, unless `cd` is f32 in the three-term split
        `(27 * 3 Ci, Co)` of `ops/conv.split3_weight`, f32 biases, the
        1x1x1 proj as an f32 (Ci, E) matrix; the v1 patch embed as the f32
        (p^3 Ci, E) matrix of the chain's lanes; the decoder GEMMs (ci,
        8 co) with columns (kd, kh, kw, co)."""
        p = self._packs.get(cd)
        if p is not None:
            return p

        split = cd != torch.float32

        def conv(m):
            w = m.weight.detach().float()
            return (pack_conv_weight(split3_weight(w) if split else w)
                    .to(cd).contiguous(),
                    m.bias.detach().float().contiguous())

        tok = self.tokenizer
        p = {"dec": [(m.weight.detach().permute(0, 2, 3, 4, 1)
                      .reshape(m.in_channels, 8 * m.out_channels)
                      .to(cd).contiguous(), m.bias.detach().float())
                     for m in self.decoder]}
        if self.cfg.version == "v1":
            p["embed"] = (
                _patch_embed_matrix(tok.proj.weight.detach().float())
                .contiguous(), tok.proj.bias.detach().float())
        else:
            proj = tok.proj.weight.detach().float()
            p.update({
                "split": split,
                "stem": conv(tok.stem),
                "stages": [(conv(st.down), [(conv(b.conv1), conv(b.conv2))
                                            for b in st.blocks])
                           for st in tok.stages],
                "proj": (proj.reshape(proj.shape[0], -1).t().contiguous(),
                         tok.proj.bias.detach().float()),
            })
        self._packs[cd] = p
        return p

    def _norm_act(self, y, ops, cd, split, residual=None):
        """Instance norm (eps `in_eps`) + LeakyReLU(0.01) [+ residual before
        the activation]: torch statistics, then D1, which stores the
        three-term split when `split`."""
        mean, var = instance_norm_stats(y)
        a, s = fold_affine(mean, var, self.cfg.in_eps)
        maps = tile_maps(y.shape[1:4], (1, 1, 1), y.device)
        return ops.norm(y, a.contiguous(), s.contiguous(), maps, act="lrelu",
                        slope=TOKENIZER_LRELU_SLOPE, out_dtype=cd,
                        residual=residual, split=split)

    def _tokenizer(self, x, p, ops, cd):
        """`_tokenizer_v2`: (B, D, H, W, 1) f32 -> (B, d, h, w, E) f32. In
        bf16 every conv reads its input and weights as the three-term split
        (`ops/conv.split3`), f32 to about 2^-16: the instance norms divide
        by the std of each channel, which on a smooth volume is small
        against the values a bf16 rounding is relative to, and the plain
        path run in bf16 reads 4e-2 from the f32 one there (PERF.md, P1)."""
        f32 = torch.float32
        split = p["split"]
        xin = split3(x) if split else x.to(cd).contiguous()
        conv = dict(act="none", pad_type="zeros", out_dtype=f32)
        y = self._norm_act(ops.conv(xin, *p["stem"], **conv), ops, cd, split)
        for down, blocks in p["stages"]:
            y = ops.down(y, *down, act="none", out_dtype=f32)
            y = self._norm_act(y, ops, cd, split)
            for conv1, conv2 in blocks:
                z = self._norm_act(ops.conv(y, *conv1, **conv), ops, cd,
                                   split)
                z = ops.conv(z, *conv2, **conv)
                y = self._norm_act(z, ops, cd, split, residual=y)
        w, b = p["proj"]
        return torch.matmul(merge3(y) if split else y.float(), w) + b

    def _tokenizer_v1(self, x, p, ops):
        """v1's patch embed: (B, D, H, W, Ci) f32 -> (B, d, h, w, E) f32,
        the stride-p conv as the f32 block-layout chain and one GEMM, then
        the token LayerNorm (eps 1e-6)."""
        n = int(round(math.log2(self.cfg.patch_embed_size[0])))
        xb = (ops.c1(x[..., 0].contiguous()) if x.shape[-1] == 1
              else ops.s2d2(x))
        for _ in range(n - 1):
            xb = ops.s2d2(xb)
        w, b = p["embed"]
        return self.tokenizer.norm(torch.matmul(xb, w) + b)

    def _attention(self, blk, h, ops, cd):
        cfg = self.cfg
        B, N, D = h.shape
        qk = (dict(q_norm=(blk.q_norm.weight, blk.q_norm.bias),
                   k_norm=(blk.k_norm.weight, blk.k_norm.bias),
                   eps=blk.q_norm.eps) if cfg.qk_norm else {})
        rope = ((self.rope_cos, self.rope_sin) if cfg.use_rot_pos_emb
                else None)
        # the (B, H, N, hd) operands of V3 in the compute dtype
        q, k, v = ops.prologue(
            blk.q_proj(h), blk.k_proj(h), blk.v_proj(h), cfg.eva_numheads,
            rope=rope, registers=cfg.num_register_tokens, out_dtype=cd, **qk)
        o = ops.attn(q, k, v, 1.0 / math.sqrt(cfg.head_dim))
        o = o.transpose(1, 2).reshape(B, N, D).float()
        if cfg.scale_attn_inner:
            o = blk.attn_inner_norm(o)
        return blk.proj(o)

    def _decoder(self, grid, p, ops, cd, emit="spatial", record=None):
        """(B, d, h, w, E) -> the output volume, out-norm applied: f32
        (B, pd, ph, pw, C), or with `emit="fold"` the folded rows (B, pd,
        ph, pw C / 128, 128) in the compute dtype under `demean` (f32
        otherwise). The JAX package's routing: the block-space decoder for
        three stages and a spatial emit, the stage path otherwise."""
        if emit not in EMITS:
            raise ValueError(f"emit must be one of {EMITS}, got {emit!r}")
        if emit == "spatial" and len(p["dec"]) == 3:
            return self._decoder_block_space(grid, p, ops, cd, record)
        return self._decoder_stages(grid, p, ops, cd, emit, record)

    def _decoder_block_space(self, grid, p, ops, cd, record):
        """`_decoder_block_space`: (B, d, h, w, E) -> f32 (B, 8d, 8h, 8w,
        C), out-norm applied."""
        cfg = self.cfg
        B, d, h, w, _ = grid.shape
        y = grid.to(cd)
        K = 1
        for i, (w2, b) in enumerate(p["dec"]):
            ci, co = w2.shape[0], w2.shape[1] // 8
            y = torch.matmul(y.reshape(B, d, h, w, K, ci), w2)
            K *= 8
            y = y.reshape(B, d, h, w, K, co)
            if record is not None:
                record(f"decoder GEMM {i}", y)
            if i < len(p["dec"]) - 1:
                # jax.nn.gelu defaults to the tanh approximation
                y = F.gelu(channel_layer_norm(y.float() + b, eps=1e-6),
                           approximate="tanh").to(cd)
        C = y.shape[-1]
        demean = _out_norm_mode(cfg.out_norm) in ("demean", "center")
        if demean:
            # the per-channel mean over every voxel and sub-position is the
            # full-resolution mean; the final bias cancels under demean
            m = torch.mean(y, dim=(1, 2, 3, 4), dtype=torch.float32)
            sub = m.repeat(1, 512)
        else:
            # the final bias rides the exit's subtract
            sub = (-b).repeat(512)[None].expand(B, -1)
        vol = ops.d2s8(y.reshape(B, d, h, w, 512 * C).contiguous(),
                       sub.contiguous())
        if demean:
            return vol
        return build_out_norm(cfg.out_norm, cfg.out_norm_eps)(vol)

    def _decoder_stages(self, grid, p, ops, cd, emit, record):
        """The JAX package's `_decoder` stage path: per stage one GEMM into
        the block layout (B, d, h, w, 8 co), then the factor-2
        depth-to-space and the bias, in the compute dtype; between stages
        the channel LayerNorm (statistics in f32) and GELU. Under `demean`
        the last stage's exit subtracts the mean of its block tensor in f32
        (the final bias cancels): the fold exit for `emit="fold"` when its
        envelope holds, else the interleave exit (f32)."""
        cfg = self.cfg
        demean = _out_norm_mode(cfg.out_norm) in ("demean", "center")
        y = grid.to(cd)
        n = len(p["dec"])
        for i, (w2, b) in enumerate(p["dec"]):
            yb = torch.matmul(y, w2)  # (B, d, h, w, 8 co) in cd
            if record is not None:
                record(f"decoder GEMM {i}", yb)
            if i == n - 1 and demean:
                B, co = yb.shape[0], w2.shape[1] // 8
                m8 = torch.mean(yb, dim=(1, 2, 3), dtype=torch.float32)
                sub = m8.reshape(B, 8, co).mean(dim=1).repeat(1, 8)
                if emit == "fold" and fold_supported(co, yb.shape[3]):
                    return ops.fold(yb.contiguous(), sub.contiguous(),
                                    out_dtype=cd)
                vol = ops.interleave(yb.contiguous(), sub.contiguous(),
                                     out_dtype=torch.float32)
                return fold_rows(vol) if emit == "fold" else vol
            # stay in the compute dtype between stages (JAX `_decoder`)
            y = ops.d2s2(yb.contiguous()) + b.to(cd)
            if i < n - 1:
                # jax.nn.gelu defaults to the tanh approximation
                y = F.gelu(channel_layer_norm(y, eps=1e-6),
                           approximate="tanh")
        vol = build_out_norm(cfg.out_norm, cfg.out_norm_eps)(y.float())
        return fold_rows(vol.contiguous()) if emit == "fold" else vol

    def _embed(self, grid):
        """The tokenizer grid (B, d, h, w, E) f32 -> the token sequence
        (B, R + N, E): the position embedding, then the registers first."""
        cfg = self.cfg
        B = grid.shape[0]
        tokens = grid.reshape(B, cfg.num_tokens, cfg.embed_dim)
        if cfg.use_abs_pos_embed:
            tokens = tokens + self.pos_embed
        R = cfg.num_register_tokens
        if R > 0:
            tokens = torch.cat(
                [self.register_tokens.expand(B, R, cfg.embed_dim), tokens],
                dim=1)
        return tokens

    def _block(self, blk, tokens, ops, cd):
        """One EVA block on the f32 residual stream."""
        gamma = self.cfg.init_values is not None
        with annotate("vit/attention"):
            a = self._attention(blk, blk.norm1(tokens), ops, cd)
        tokens = tokens + (a * blk.gamma1 if gamma else a)
        with annotate("vit/mlp"):
            h = blk.norm2(tokens)
            m = blk.mlp_w3(F.silu(blk.mlp_w1(h)) * blk.mlp_w2(h))
        return tokens + (m * blk.gamma2 if gamma else m)

    def _unembed(self, tokens):
        """The final norm, without the registers, as the (B, d, h, w, E)
        grid."""
        cfg = self.cfg
        tokens = self.norm(tokens)[:, cfg.num_register_tokens:]
        return tokens.reshape(tokens.shape[0], *cfg.grid_shape,
                              cfg.embed_dim)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16,
                plain: bool = False, emit: str = "spatial",
                record: Callable[[str, torch.Tensor], None] | None = None,
                ) -> torch.Tensor:
        """Inference, without gradients; the differentiable forward of the
        pretraining step is `primus_train.primus_train_apply`. `emit` as in
        `_decoder`; `record(name, tensor)`, when given, sees each stage's
        output."""
        cfg = self.cfg
        if x.dim() == 4:
            x = x[..., None]
        if tuple(x.shape[1:4]) != tuple(cfg.input_shape):
            raise ValueError(
                f"Primus is bound to input_shape={cfg.input_shape}; got "
                f"{tuple(x.shape[1:4])} (use sliding windows for other "
                "sizes).")
        ops = _PLAIN if plain else _KERNELS
        cd = compute_dtype
        p = self._pack(cd)
        x = x.float().contiguous()
        with annotate("vit/tokenizer"):
            grid = (self._tokenizer(x, p, ops, cd) if cfg.version == "v2"
                    else self._tokenizer_v1(x, p, ops))
        if record is not None:
            record("tokenizer", grid)
        tokens = self._embed(grid)
        for i, blk in enumerate(self.blocks):
            tokens = self._block(blk, tokens, ops, cd)
            if record is not None:
                record(f"block {i}", tokens)
        grid = self._unembed(tokens)
        if record is not None:
            record("final norm", grid)
        with annotate("vit/decoder"):
            return self._decoder(grid, p, ops, cd, emit, record)


def primus_apply(cfg: PrimusConfig, state_dict: dict[str, torch.Tensor],
                 x: torch.Tensor, *,
                 compute_dtype: torch.dtype = torch.float32,
                 plain: bool = False, emit: str = "spatial") -> torch.Tensor:
    """Functional form: a `Primus` on `x`'s device with `state_dict`, run
    on `x` under `torch.inference_mode`."""
    model = Primus.from_state_dict(cfg, state_dict, device=x.device)
    with torch.inference_mode():
        return model(x, compute_dtype=compute_dtype, plain=plain, emit=emit)


# -----------------------------------------------------------------------------
# seeded init, with the JAX package's distributions and shapes

def init_primus_params(cfg: PrimusConfig,
                       generator: torch.Generator | None = None):
    """A CPU f32 state dict drawn as `init_primus_params` draws the pytree:
    truncated normal (+-2 std) std 0.02 for linears and the position
    embedding, normal * sqrt(2 / fan_in) for convs (fan_in = taps * Ci),
    zero biases, unit LayerNorms, registers normal * register_init_std,
    LayerScale `init_values`. Torch and JAX draw different numbers."""
    model = Primus(cfg, device="cpu")
    gen = generator

    def normal(t, std):
        t.normal_(generator=gen).mul_(std)

    def trunc(t, std=0.02):
        nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
        t.mul_(std)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv3d):
                normal(m.weight, math.sqrt(2.0 / (m.weight[0].numel())))
                m.bias.zero_()
            elif isinstance(m, nn.ConvTranspose3d):
                normal(m.weight, math.sqrt(2.0 / (8 * m.in_channels)))
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                trunc(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, _EvaBlock) and cfg.init_values is not None:
                m.gamma1.fill_(cfg.init_values)
                m.gamma2.fill_(cfg.init_values)
        if cfg.use_abs_pos_embed:
            trunc(model.pos_embed)
        if cfg.num_register_tokens > 0:
            normal(model.register_tokens, cfg.register_init_std)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def primus_param_count(state_dict: dict[str, torch.Tensor]) -> int:
    return sum(int(v.numel()) for v in state_dict.values())
