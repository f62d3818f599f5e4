"""Pretraining of the port: the contrastive train step (config, SupPatchNCE
loss, patch sampling and projectors, schedules, the train-mode UNet or ViT
on the kernels and their backward kernels, AdamW) and `build_all`.

Importing this package imports none of its modules; names load on first
use.
"""

_LAZY_ATTRS = {
    "PretrainConfig": "anatomix_tpu_torch.pretraining.config",
    "sup_patch_nce_loss": "anatomix_tpu_torch.pretraining.losses",
    "make_schedule": "anatomix_tpu_torch.pretraining.schedulers",
    "PlateauState": "anatomix_tpu_torch.pretraining.schedulers",
    "TrainState": "anatomix_tpu_torch.pretraining.train_step",
    "NCEOptions": "anatomix_tpu_torch.pretraining.train_step",
    "init_train_state": "anatomix_tpu_torch.pretraining.train_step",
    "build_train_step": "anatomix_tpu_torch.pretraining.train_step",
    "nce_forward": "anatomix_tpu_torch.pretraining.train_step",
    "nce_loss_and_grads": "anatomix_tpu_torch.pretraining.train_step",
    "backbone_tap_channels": "anatomix_tpu_torch.pretraining.train_step",
    "make_optimizer": "anatomix_tpu_torch.pretraining.train_step",
    "build_all": "anatomix_tpu_torch.pretraining.train",
}


def __getattr__(name):
    import importlib

    if name in _LAZY_ATTRS:
        val = getattr(importlib.import_module(_LAZY_ATTRS[name]), name)
        globals()[name] = val
        return val
    raise AttributeError(
        f"module 'anatomix_tpu_torch.pretraining' has no attribute {name!r}"
    )


def __dir__():
    return sorted(list(globals()) + list(_LAZY_ATTRS))
