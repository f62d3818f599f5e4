"""Variant registry: the port's own copy of `ANATOMIX_VARIANTS`.

The 6M `anatomix` UNet, the 94M `anatomix-dev` UNet and the 26M
`anatomix-dev-vit` 3D ViT, with the constructor arguments of the reference
`load_from_hf.py`. The port runs all three (the ViT through
`models/vit3d`).
"""

from __future__ import annotations

ANATOMIX_VARIANTS = {
    "anatomix": {
        "unet_kwargs": dict(
            dimension=3, input_nc=1, output_nc=16, num_downs=4, ngf=16,
        ),
        "output_channels": 16,
    },
    "anatomix-dev": {
        "unet_kwargs": dict(
            dimension=3, input_nc=1, output_nc=32, num_downs=5, ngf=32,
            norm="instance", pooling="Avg", interp="trilinear",
            norm_eps=1e-2,
        ),
        "output_channels": 32,
    },
    "anatomix-dev-vit": {
        "vit_kwargs": dict(
            input_channels=1, num_classes=32, embed_dim=396, eva_depth=12,
            eva_numheads=6, patch_embed_size=(8, 8, 8),
            input_shape=(128, 128, 128), num_register_tokens=8,
            init_values=0.1, scale_attn_inner=True, qk_norm=True,
            out_norm="demean", out_norm_eps=1e-2,
            register_init_std=0.02, in_eps=1e-2,
        ),
        "output_channels": 32,
    },
}
