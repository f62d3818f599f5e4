"""anatomix_tpu_torch: the PyTorch/CUDA port of anatomix-tpu for NVIDIA Hopper.

The package mirrors `anatomix_tpu`'s module names. Volumes at public
functions are channels-last `(B, D, H, W, C)`, as in the JAX package. Entry
points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; on the CPU every kernel wrapper runs its plain PyTorch
version.

Importing this package imports nothing heavy; submodules load on first use.
"""

__version__ = "0.1.0"

_LAZY = {
    "models": "anatomix_tpu_torch.models",
    "ops": "anatomix_tpu_torch.ops",
    "kernels": "anatomix_tpu_torch.kernels",
    "extract": "anatomix_tpu_torch.extract",
    "utils": "anatomix_tpu_torch.utils",
    "pretraining": "anatomix_tpu_torch.pretraining",
    "registration": "anatomix_tpu_torch.registration",
}

_LAZY_ATTRS = {
    "Unet": ("anatomix_tpu_torch.models.unet", "Unet"),
    "UnetConfig": ("anatomix_tpu_torch.models.unet", "UnetConfig"),
    "Primus": ("anatomix_tpu_torch.models.vit3d", "Primus"),
    "PrimusConfig": ("anatomix_tpu_torch.models.vit3d", "PrimusConfig"),
    "load_model": ("anatomix_tpu_torch.models.load", "load_model"),
    "load_from_hf": ("anatomix_tpu_torch.models.load", "load_from_hf"),
    "ANATOMIX_VARIANTS": (
        "anatomix_tpu_torch.models.registry", "ANATOMIX_VARIANTS"
    ),
    "make_feature_extractor": (
        "anatomix_tpu_torch.extract", "make_feature_extractor"
    ),
}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        mod = importlib.import_module(_LAZY[name])
        globals()[name] = mod
        return mod
    if name in _LAZY_ATTRS:
        mod_name, attr = _LAZY_ATTRS[name]
        val = getattr(importlib.import_module(mod_name), attr)
        globals()[name] = val
        return val
    raise AttributeError(
        f"module 'anatomix_tpu_torch' has no attribute {name!r}"
    )


def __dir__():
    return sorted(list(globals()) + list(_LAZY) + list(_LAZY_ATTRS))
