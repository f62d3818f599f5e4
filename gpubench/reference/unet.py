"""Plain float32 PyTorch forward of the anatomix UNet, the benchmark's reference.

The network of neel-dey/anatomix `anatomix/model/network.py` (`Unet`): a
flat `nn.Sequential` whose indices key the checkpoint (`model.<idx>.*`):
a stem conv block, `num_downs` encoder levels of two conv blocks and a 2x
pool, a bottleneck of two conv blocks, `num_downs` decoder levels of a 2x
upsample, the concatenation (encoder, decoder) and two conv blocks, and a
final conv. A conv block is a 3x3x3 conv with reflect padding, its norm and
its activation. The layout is rebuilt here from the configuration alone;
this module imports nothing of the program under test.

It runs in NCDHW with `torch.nn.functional` only: convs, eval-mode batch
norm with the running statistics, instance norm (biased variance, no
affine), relu, max or average pool, nearest or trilinear
(`align_corners=False`) upsampling. TF32 is switched off around it.

`operand_dtype` rounds every conv's input and weight to that type (fp8
per tensor, scaled so the largest magnitude maps to the type's largest
value; bf16 unscaled) before an f32 conv: the control in a lower precision than the program's.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F


class Layer(NamedTuple):
    kind: str  # conv | norm | act | pool | upsample
    in_ch: int = 0
    out_ch: int = 0


class Layout(NamedTuple):
    layers: tuple[Layer, ...]
    encoder_idx: tuple[int, ...]  # last layer of each encoder level
    decoder_idx: tuple[int, ...]  # the upsample of each decoder level


def layout(cfg: dict) -> Layout:
    """The flat layer list of the reference constructor for `cfg` (the keys
    of a configuration file's `unet`)."""
    ngf, downs = cfg["ngf"], cfg["num_downs"]
    layers: list[Layer] = []
    enc: list[int] = []
    dec: list[int] = []

    def block(ci, co):
        layers.append(Layer("conv", ci, co))
        if cfg.get("norm", "batch") != "none":
            layers.append(Layer("norm", co, co))
        layers.append(Layer("act"))

    block(cfg["input_nc"], ngf)
    ch = ngf
    for i in range(downs):
        mult = 1 if i == 0 else 2
        block(ch, ch * mult)
        block(ch * mult, ch * mult)
        enc.append(len(layers) - 1)
        layers.append(Layer("pool"))
        ch *= mult
    block(ch, ch * 2)
    block(ch * 2, ch * 2)
    mult = 2 ** downs
    for _ in range(downs):
        dec.append(len(layers))
        layers.append(Layer("upsample"))
        block(ngf * (mult + mult // 2), ngf * (mult // 2))
        block(ngf * (mult // 2), ngf * (mult // 2))
        mult //= 2
    layers.append(Layer("conv", ngf * mult, cfg["output_nc"]))
    return Layout(tuple(layers), tuple(enc), tuple(dec))


def parameter_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter and buffer of the reference's state dict, by key."""
    out: dict[str, tuple[int, ...]] = {}
    norm = cfg.get("norm", "batch")
    for i, layer in enumerate(layout(cfg).layers):
        if layer.kind == "conv":
            out[f"model.{i}.weight"] = (layer.out_ch, layer.in_ch, 3, 3, 3)
            if norm == "instance":
                out[f"model.{i}.bias"] = (layer.out_ch,)
        elif layer.kind == "norm" and norm == "batch":
            for name in ("weight", "bias", "running_mean", "running_var"):
                out[f"model.{i}.{name}"] = (layer.out_ch,)
    return out


@contextlib.contextmanager
def no_tf32():
    """Full float32 matrix products and convolutions on the card."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_to(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """`x` rounded to `dtype`, back in f32. A type with less range than
    f32 (fp8) takes one scale per tensor, so that the largest magnitude
    maps to the type's largest value; one with f32's range (bf16) takes
    none, since that scale would overflow f32 for a tensor under 1."""
    if dtype is None:
        return x
    if torch.finfo(dtype).max > torch.finfo(torch.float32).max / 2:
        return x.to(dtype).float()
    amax = x.abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).float() / scale


def forward(cfg: dict, sd: dict[str, torch.Tensor], x: torch.Tensor,
            operand_dtype: torch.dtype | None = None) -> torch.Tensor:
    """`x` (B, C, D, H, W) f32 -> features (B, output_nc, D, H, W) f32."""
    lay = layout(cfg)
    norm = cfg.get("norm", "batch")
    eps = cfg.get("norm_eps", 1e-5)
    feat = x.float()
    skips: list[torch.Tensor] = []
    with no_tf32(), torch.no_grad():
        for i, layer in enumerate(lay.layers):
            key = f"model.{i}"
            if layer.kind == "conv":
                w = sd[f"{key}.weight"].float()
                b = sd.get(f"{key}.bias")
                inp = F.pad(round_to(feat, operand_dtype), (1,) * 6,
                            mode="reflect")
                feat = F.conv3d(inp, round_to(w, operand_dtype),
                                None if b is None else b.float())
            elif layer.kind == "norm" and norm == "batch":
                feat = F.batch_norm(
                    feat, sd[f"{key}.running_mean"].float(),
                    sd[f"{key}.running_var"].float(),
                    sd[f"{key}.weight"].float(), sd[f"{key}.bias"].float(),
                    training=False, eps=eps)
            elif layer.kind == "norm":
                feat = F.instance_norm(feat, eps=eps)
            elif layer.kind == "act":
                feat = F.relu(feat)
            elif layer.kind == "pool":
                feat = (F.max_pool3d(feat, 2) if cfg.get("pooling", "Max")
                        == "Max" else F.avg_pool3d(feat, 2))
            elif layer.kind == "upsample":
                if cfg.get("interp", "nearest") == "nearest":
                    feat = F.interpolate(feat, scale_factor=2, mode="nearest")
                else:
                    feat = F.interpolate(feat, scale_factor=2,
                                         mode="trilinear",
                                         align_corners=False)
                feat = torch.cat([skips.pop(), feat], dim=1)
            if i in lay.encoder_idx:
                skips.append(feat)
    return feat
