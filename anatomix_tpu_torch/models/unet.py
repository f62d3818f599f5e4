"""The anatomix UNet in PyTorch: the layer plan, seeded init and the eager
`nn.Module` that is the port's plain oracle path.

The reference builds a flat `nn.Sequential` encoder-decoder whose indices
key the checkpoint (`model.<idx>.weight`) and the pretraining taps (27, 31,
38, 45, 52, 65). `build_plan` reproduces that index scheme exactly, as the
JAX package's does (`anatomix_tpu/models/unet.py:46-189`); `Unet` holds its
parameters under the same keys and runs the forward on channels-last
volumes with the plain ops of `ops/`.

The port covers every UNet option of the JAX package: batch, instance
(global or per spatial tile), instance-affine or no norm, Max or Avg pool,
nearest or trilinear upsampling, reflect, zeros, replicate or circular
padding, the relu/lrelu/elu/selu/tanh/prelu/none activations, residual
connections (`feat + 0.1 * conv output` at each block's end) and 1-D and
2-D nets, which run as 3-D volumes with leading singleton axes. Other
configs (group norm, bicubic, ...) raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from anatomix_tpu_torch.ops.activations import (
    EPILOGUE_ACTS,
    UNET_LRELU_SLOPE,
    apply_activation,
)
from anatomix_tpu_torch.ops.conv import conv3d_same, lift_weight
from anatomix_tpu_torch.ops.norms import tiled_instance_norm
from anatomix_tpu_torch.ops.pool import avg_pool, max_pool
from anatomix_tpu_torch.ops.resize import upsample2x


@dataclasses.dataclass(frozen=True)
class UnetConfig:
    """Mirrors the reference `Unet.__init__` signature."""

    dimension: int = 3
    input_nc: int = 1
    output_nc: int = 16
    num_downs: int = 4
    ngf: int = 24
    norm: str = "batch"
    final_act: str = "none"
    activation: str = "relu"
    pad_type: str = "reflect"
    doubleconv: bool = True
    residual_connection: bool = False
    pooling: str = "Max"
    interp: str = "nearest"
    use_skip_connection: bool = True
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.dimension not in (1, 2, 3):
            raise ValueError(
                f"dimension must be 1-3; got {self.dimension}"
            )


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str  # conv | norm | act | pool | upsample | final_act | identity
    in_ch: int = 0
    out_ch: int = 0


@dataclasses.dataclass(frozen=True)
class UnetPlan:
    """Static layer plan with the reference's flat-Sequential index scheme."""

    config: UnetConfig
    layers: tuple[LayerSpec, ...]
    encoder_idx: tuple[int, ...]
    decoder_idx: tuple[int, ...]
    res_source: tuple[int, ...]
    res_dest: tuple[int, ...]

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def conv_indices(self) -> tuple[int, ...]:
        return tuple(
            i for i, s in enumerate(self.layers) if s.kind == "conv"
        )

    def tap_channels(self, layers: Sequence[int]) -> tuple[int, ...]:
        """Channel width of the activation collected at each tap index."""
        widths = {}
        ch = self.config.input_nc
        enc_stack: list[int] = []
        for i, spec in enumerate(self.layers):
            if spec.kind == "conv":
                ch = spec.out_ch
            if self.config.use_skip_connection:
                if i in self.decoder_idx:
                    ch = enc_stack.pop() + ch
                if i in self.encoder_idx:
                    enc_stack.append(ch)
            widths[i] = ch
        return tuple(widths[i] for i in layers)


def build_plan(config: UnetConfig) -> UnetPlan:
    """Reproduce the reference constructor's layer/index layout."""
    cfg = config
    has_norm = cfg.norm != "none"
    has_act = cfg.activation != "none"
    has_final_act = cfg.final_act != "none"

    layers: list[LayerSpec] = []
    res_source: list[int] = []
    res_dest: list[int] = []
    encoder_idx: list[int] = []
    decoder_idx: list[int] = []

    def add_conv_block(in_ch, out_ch):
        layers.append(LayerSpec("conv", in_ch, out_ch))
        res_source.append(len(layers) - 1)
        if has_norm:
            layers.append(LayerSpec("norm", out_ch, out_ch))
        if has_act:
            layers.append(LayerSpec("act"))
        res_dest.append(len(layers) - 1)

    # Stem
    add_conv_block(cfg.input_nc, cfg.ngf)

    # Encoder
    in_ngf = cfg.ngf
    for i in range(cfg.num_downs):
        mult = 1 if i == 0 else 2
        add_conv_block(in_ngf, in_ngf * mult)
        if cfg.doubleconv:
            add_conv_block(in_ngf * mult, in_ngf * mult)
        encoder_idx.append(len(layers) - 1)
        layers.append(LayerSpec("pool"))
        in_ngf *= mult

    # Bottleneck
    add_conv_block(in_ngf, in_ngf * 2)
    if cfg.doubleconv:
        add_conv_block(in_ngf * 2, in_ngf * 2)

    # Decoder
    mult = 2 ** cfg.num_downs
    for i in range(cfg.num_downs):
        decoder_idx.append(len(layers))
        layers.append(LayerSpec("upsample"))
        m = mult + mult // 2 if cfg.use_skip_connection else mult
        add_conv_block(cfg.ngf * m, cfg.ngf * (mult // 2))
        if cfg.doubleconv:
            add_conv_block(cfg.ngf * (mult // 2), cfg.ngf * (mult // 2))
        mult //= 2

    # Final conv (+ optional final activation), no norm
    layers.append(LayerSpec("conv", cfg.ngf * mult, cfg.output_nc))
    if has_final_act:
        layers.append(LayerSpec("final_act"))

    return UnetPlan(
        config=cfg,
        layers=tuple(layers),
        encoder_idx=tuple(encoder_idx),
        decoder_idx=tuple(decoder_idx),
        res_source=tuple(res_source),
        res_dest=tuple(res_dest),
    )


def check_supported(config: UnetConfig) -> None:
    """Raise `NotImplementedError` for configs the port does not run: the
    options the JAX package refuses as well."""
    if config.norm not in ("batch", "none", "instance", "instance_affine"):
        raise NotImplementedError(f"norm={config.norm!r} is unsupported")
    if config.interp not in ("nearest", "trilinear"):
        raise NotImplementedError(f"interp={config.interp!r} is unsupported")
    if config.pooling not in ("Max", "Avg"):
        raise NotImplementedError(f"pooling={config.pooling!r} is unsupported")
    if config.pad_type not in ("reflect", "zeros", "replicate", "circular"):
        raise NotImplementedError(
            f"pad_type={config.pad_type!r} is unsupported")
    for name in (config.activation, config.final_act):
        if name not in EPILOGUE_ACTS and name != "prelu":
            raise NotImplementedError(f"activation {name!r} is unsupported")


def kernel_pad(config: UnetConfig):
    """The padding of the lifted 3-D conv, per axis: the config's mode on
    the real axes, zeros on the leading axes a 1-D or 2-D net lifts (their
    taps are zero, so any padding is exact; reflect has no meaning at
    extent 1)."""
    off = 3 - config.dimension
    if not off:
        return config.pad_type
    return ("zeros",) * off + (config.pad_type,) * config.dimension


def lift_input(config: UnetConfig, x: torch.Tensor) -> torch.Tensor:
    """A 1-D (B, L, C) or 2-D (B, H, W, C) input as the 3-D volume with
    leading singleton axes (`anatomix_tpu/models/unet.py:341-352`)."""
    off = 3 - config.dimension
    return x.reshape(x.shape[:1] + (1,) * off + x.shape[1:]) if off else x


def deflate(config: UnetConfig, x: torch.Tensor) -> torch.Tensor:
    """The lifted volume back at the caller's rank."""
    off = 3 - config.dimension
    return x.reshape(x.shape[:1] + x.shape[1 + off:]) if off else x


def pool_window(config: UnetConfig) -> tuple[int, int, int]:
    """The 2x pool's window: the real axes only."""
    off = 3 - config.dimension
    return (1,) * off + (2,) * config.dimension


def act_slots(plan: UnetPlan) -> tuple[int, ...]:
    return tuple(i for i, s in enumerate(plan.layers) if s.kind == "act")


def prelu_key(plan: UnetPlan) -> str | None:
    """The state-dict key of the PReLU weight that every `act` slot shares:
    the first slot's. The reference appends one `nn.PReLU` instance at each
    slot (`anatomix_tpu/models/unet.py:218-223`), so its `.pth` repeats the
    value under every slot; a training tree keeps this one leaf (JAX's
    `params["prelu"]["w"]`), whose gradient sums over the slots."""
    slots = act_slots(plan)
    if plan.config.activation != "prelu" or not slots:
        return None
    return f"model.{slots[0]}.weight"


def final_prelu_key(plan: UnetPlan) -> str | None:
    """The state-dict key of the final activation's own PReLU weight."""
    if plan.config.final_act != "prelu":
        return None
    i = next(i for i, s in enumerate(plan.layers) if s.kind == "final_act")
    return f"model.{i}.weight"


def tie_prelu(plan: UnetPlan, sd: dict) -> dict:
    """`sd` with the shared PReLU weight under `prelu_key` alone: the
    other slots' copies dropped, after checking they agree (as the JAX
    package's `convert_state_dict` refuses unequal slots)."""
    key = prelu_key(plan)
    if key is None:
        return dict(sd)
    out = dict(sd)
    for i in act_slots(plan)[1:]:
        v = out.pop(f"model.{i}.weight", None)
        if v is not None and not torch.equal(
                torch.as_tensor(v).float().cpu(),
                torch.as_tensor(out[key]).float().cpu()):
            raise ValueError("PReLU act weights differ across layers: the "
                             "reference shares one instance")
    return out


def untie_prelu(plan: UnetPlan, sd: dict) -> dict:
    """`sd` with the shared PReLU weight under every `act` slot, the
    reference `.pth` layout."""
    key = prelu_key(plan)
    if key is None:
        return dict(sd)
    out = dict(sd)
    for i in act_slots(plan):
        out[f"model.{i}.weight"] = sd[key]
    return out


def layer_acts(plan: UnetPlan, sd) -> tuple:
    """(activation, final activation) as callables of a tensor, PReLU with
    its weight from `sd` (the shared one under `prelu_key`)."""
    cfg = plan.config

    def make(name, key):
        w = sd[key] if key is not None else None
        return lambda v: apply_activation(v, name, slope=UNET_LRELU_SLOPE,
                                          weight=w)

    return (make(cfg.activation, prelu_key(plan)),
            make(cfg.final_act, final_prelu_key(plan)))


# -----------------------------------------------------------------------------
# Parameters

def init_params(
    plan: UnetPlan,
    generator: torch.Generator,
    *,
    init_type: str = "kaiming",
    init_gain: float = 0.02,
) -> dict[str, torch.Tensor]:
    """Seeded init as a reference-keyed state dict (CPU, float32).

    The same distributions as the JAX package's `init_params`: convs normal
    with std sqrt(2 / fan_in) (`kaiming`), gain * sqrt(2 / (fan_in +
    fan_out)) (`xavier`) or gain (`normal`), fans over the 3^dimension
    taps, with a zero bias for `instance` models; batch-norm scale N(1,
    gain), bias 0, running mean 0, running var 1,
    `instance_affine` scale 1 and bias 0 (torch's `InstanceNorm3d` init);
    PReLU weights 0.25 (torch's `nn.PReLU()`), the shared one under every
    act slot. A 1-D or 2-D conv weight has the native rank, (O, I, 3) or
    (O, I, 3, 3), as the reference's `nn.Conv1d` / `nn.Conv2d`.
    The draws differ from JAX's (another generator); tests share weights
    through `convert.from_jax_params`.
    """
    cfg = plan.config
    use_bias = cfg.norm == "instance"
    taps = 3 ** cfg.dimension
    sd: dict[str, torch.Tensor] = {}
    prelu = torch.full((1,), 0.25)
    for idx, spec in enumerate(plan.layers):
        base = f"model.{idx}"
        if spec.kind == "conv":
            fan_in, fan_out = spec.in_ch * taps, spec.out_ch * taps
            if init_type == "kaiming":
                std = math.sqrt(2.0 / fan_in)
            elif init_type == "xavier":
                std = init_gain * math.sqrt(2.0 / (fan_in + fan_out))
            elif init_type == "normal":
                std = init_gain
            else:
                raise ValueError(f"Unsupported init_type: {init_type}")
            sd[f"{base}.weight"] = torch.randn(
                (spec.out_ch, spec.in_ch) + (3,) * cfg.dimension,
                generator=generator) * std
            if use_bias:
                sd[f"{base}.bias"] = torch.zeros(spec.out_ch)
        elif spec.kind == "norm" and cfg.norm == "batch":
            sd[f"{base}.weight"] = 1.0 + torch.randn(
                (spec.out_ch,), generator=generator
            ) * init_gain
            sd[f"{base}.bias"] = torch.zeros(spec.out_ch)
            sd[f"{base}.running_mean"] = torch.zeros(spec.out_ch)
            sd[f"{base}.running_var"] = torch.ones(spec.out_ch)
            sd[f"{base}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long
            )
        elif spec.kind == "norm" and cfg.norm == "instance_affine":
            sd[f"{base}.weight"] = torch.ones(spec.out_ch)
            sd[f"{base}.bias"] = torch.zeros(spec.out_ch)
        elif spec.kind == "act" and cfg.activation == "prelu":
            sd[f"{base}.weight"] = prelu.clone()
        elif spec.kind == "final_act" and cfg.final_act == "prelu":
            sd[f"{base}.weight"] = torch.full((1,), 0.25)
    return sd


def trainable_state(plan: UnetPlan, sd: dict) -> dict[str, torch.Tensor]:
    """The float leaves of a state dict as a training tree: the shared
    PReLU weight tied to one leaf (`tie_prelu`)."""
    return {k: v for k, v in tie_prelu(plan, sd).items()
            if v.is_floating_point()}


# -----------------------------------------------------------------------------
# Eager module

class Unet(nn.Module):
    """Eager inference UNet on NDHWC volumes (batch norm in eval mode,
    instance norm with the statistics of each sample); a 1-D or 2-D net
    takes (B, L, C) or (B, H, W, C) and runs lifted to 3-D.

    `self.model` is an `nn.Sequential` with one entry per plan index, so the
    state dict is keyed `model.<idx>.weight` like the reference `.pth` (one
    `nn.PReLU` shared by every act slot, as in the reference). The conv,
    norm and PReLU modules only hold parameters; the forward runs the plain
    NDHWC ops (`ops/conv.py` with the config's padding).
    """

    def __init__(self, plan: UnetPlan, *, conv_bias: bool | None = None):
        super().__init__()
        cfg = plan.config
        check_supported(cfg)
        if conv_bias is None:
            conv_bias = cfg.norm == "instance"
        self.plan = plan
        conv = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}[cfg.dimension]
        shared = nn.PReLU() if cfg.activation == "prelu" else None
        mods: list[nn.Module] = []
        for spec in plan.layers:
            if spec.kind == "conv":
                mods.append(conv(spec.in_ch, spec.out_ch, 3, bias=conv_bias))
            elif spec.kind == "act" and shared is not None:
                mods.append(shared)
            elif spec.kind == "final_act" and cfg.final_act == "prelu":
                mods.append(nn.PReLU())
            elif spec.kind == "norm" and cfg.norm == "batch":
                mods.append(nn.BatchNorm3d(spec.out_ch, eps=cfg.norm_eps))
            elif spec.kind == "norm":
                mods.append(nn.InstanceNorm3d(
                    spec.out_ch, eps=cfg.norm_eps,
                    affine=cfg.norm == "instance_affine"))
            else:
                mods.append(nn.Identity())
        self.model = nn.Sequential(*mods)

    @classmethod
    def from_state_dict(cls, plan: UnetPlan, state_dict) -> "Unet":
        conv_bias = any(
            f"model.{i}.bias" in state_dict for i in plan.conv_indices
        )
        net = cls(plan, conv_bias=conv_bias)
        net.load_state_dict(untie_prelu(plan, state_dict))
        return net.eval()

    def forward(
        self,
        x: torch.Tensor,
        layers: Sequence[int] = (),
        encode_only: bool = False,
        in_tile_counts: tuple[int, int, int] | None = None,
    ):
        """Semantics of the JAX `unet_apply` in inference: with `layers`,
        returns `(out, [activations at those indices])`; with
        `encode_only`, only the activation list, after the last tap.
        `in_tile_counts` gives instance norms per-tile statistics (the
        `full_tiled` strategy), with each level's tiles split from its own
        extent."""
        plan = self.plan
        cfg = plan.config
        layers = tuple(layers)
        act, final_act = layer_acts(plan, {
            k: self.model[int(k.split(".")[1])].weight
            for k in (prelu_key(plan), final_prelu_key(plan)) if k})
        feat = lift_input(cfg, x)
        feats: list[torch.Tensor] = []
        enc_feats: list[torch.Tensor] = []
        res = None
        for idx, spec in enumerate(plan.layers):
            mod = self.model[idx]
            if spec.kind == "conv":
                feat = conv3d_same(
                    feat, lift_weight(mod.weight), mod.bias,
                    pad_type=cfg.pad_type
                )
            elif spec.kind == "norm" and cfg.norm == "batch":
                inv = mod.weight * torch.rsqrt(mod.running_var + mod.eps)
                feat = feat * inv + (mod.bias - mod.running_mean * inv)
            elif spec.kind == "norm":
                feat = tiled_instance_norm(
                    feat, in_tile_counts or (1, 1, 1), eps=cfg.norm_eps,
                    scale=mod.weight, bias=mod.bias)
            elif spec.kind == "act":
                feat = act(feat)
            elif spec.kind == "pool":
                pool = max_pool if cfg.pooling == "Max" else avg_pool
                feat = pool(feat, pool_window(cfg))
            elif spec.kind == "upsample":
                feat = upsample2x(feat, cfg.interp, pool_window(cfg))
            elif spec.kind == "final_act":
                feat = final_act(feat)
            if cfg.residual_connection:
                # the block's conv output, added after its norm and act
                if idx in plan.res_source:
                    res = feat
                if idx in plan.res_dest:
                    feat = feat + 0.1 * res
            if cfg.use_skip_connection:
                if idx in plan.decoder_idx:
                    # the reference concatenates (encoder, decoder)
                    feat = torch.cat([enc_feats.pop(), feat], dim=-1)
                if idx in plan.encoder_idx:
                    enc_feats.append(feat)
            if layers and idx in layers:
                feats.append(deflate(cfg, feat))
                if encode_only and idx == layers[-1]:
                    return feats
        feat = deflate(cfg, feat)
        if layers:
            return feat, feats
        return feat
