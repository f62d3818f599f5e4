"""Checkpoint-conversion CLI: a reference `.pth` -> the JAX package's
`.npz` pytree (the port of `anatomix_tpu/models/convert_cli.py`, with its
flags), so that `anatomix_tpu.models.load` and the port's own loaders read
what it writes. Runs on the CPU; nothing is downloaded.

Usage:
  python -m anatomix_tpu_torch.models.convert_cli anatomix.pth anatomix.npz \
      --variant anatomix
  python -m anatomix_tpu_torch.models.convert_cli custom.pth custom.npz \
      --num_downs 4 --ngf 16 --output_nc 16 --norm batch

UNets go through `convert.load_pth` (prefixes stripped, keys checked
against the plan) and `convert.to_jax_params` into `load.save_npz`'s flat
`"<idx>/<leaf>"` file; the ViT variant through
`vit3d.convert.convert_primus_state_dict` into `utils/checkpoint.
save_pytree`'s file. Every UNet option of the JAX package's CLI converts,
1-D and 2-D nets and PReLU among them.
"""

from __future__ import annotations

import argparse

import torch

from anatomix_tpu_torch.models.convert import load_pth, to_jax_params
from anatomix_tpu_torch.models.load import save_npz
from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
from anatomix_tpu_torch.models.unet import (
    UnetConfig,
    build_plan,
    check_supported,
)


def _convert_vit(kw: dict, src: str, dst: str) -> None:
    from anatomix_tpu_torch.models.vit3d import PrimusConfig
    from anatomix_tpu_torch.models.vit3d.convert import (
        convert_primus_state_dict,
    )
    from anatomix_tpu_torch.utils.checkpoint import save_pytree

    cfg = PrimusConfig(
        input_channels=kw["input_channels"], num_classes=kw["num_classes"],
        embed_dim=kw["embed_dim"], eva_depth=kw["eva_depth"],
        eva_numheads=kw["eva_numheads"],
        patch_embed_size=tuple(kw["patch_embed_size"]),
        input_shape=tuple(kw["input_shape"]),
        num_register_tokens=kw["num_register_tokens"], qk_norm=kw["qk_norm"],
        scale_attn_inner=kw["scale_attn_inner"], out_norm=kw["out_norm"],
        version="v2",
    )
    raw = torch.load(src, map_location="cpu", weights_only=True)
    params, unmapped, unfilled = convert_primus_state_dict(cfg, raw)
    if unmapped:
        print(f"WARNING unmapped source keys: {unmapped[:10]}...")
    if unfilled:
        print(f"WARNING unfilled targets: {unfilled[:10]}...")
    save_pytree(dst, params)
    print(f"wrote {dst}")


def main(argv=None):
    p = argparse.ArgumentParser(description=".pth -> .npz conversion")
    p.add_argument("src", type=str)
    p.add_argument("dst", type=str)
    p.add_argument("--variant", type=str, default=None,
                   help="registry variant supplying the architecture")
    p.add_argument("--num_downs", type=int, default=4)
    p.add_argument("--ngf", type=int, default=16)
    p.add_argument("--output_nc", type=int, default=16)
    p.add_argument("--input_nc", type=int, default=1)
    p.add_argument("--norm", type=str, default="batch")
    p.add_argument("--interp", type=str, default="nearest")
    p.add_argument("--pooling", type=str, default="Max")
    p.add_argument("--norm_eps", type=float, default=1e-5)
    p.add_argument("--dimension", type=int, default=3, choices=(1, 2, 3))
    p.add_argument("--activation", type=str, default="relu")
    p.add_argument("--final_act", type=str, default="none")
    p.add_argument("--pad_type", type=str, default="reflect")
    args = p.parse_args(argv)

    if args.variant:
        cfg_kw = ANATOMIX_VARIANTS[args.variant]
        if "vit_kwargs" in cfg_kw:
            _convert_vit(cfg_kw["vit_kwargs"], args.src, args.dst)
            return
        config = UnetConfig(**cfg_kw["unet_kwargs"])
    else:
        config = UnetConfig(
            dimension=args.dimension, input_nc=args.input_nc,
            output_nc=args.output_nc, num_downs=args.num_downs, ngf=args.ngf,
            norm=args.norm, activation=args.activation,
            final_act=args.final_act, pad_type=args.pad_type,
            interp=args.interp, pooling=args.pooling, norm_eps=args.norm_eps,
        )
    check_supported(config)
    plan = build_plan(config)
    params = to_jax_params(plan, load_pth(args.src, plan))
    save_npz(args.dst, params)
    print(f"wrote {args.dst} ({len(params)} layers)")


if __name__ == "__main__":
    main()
