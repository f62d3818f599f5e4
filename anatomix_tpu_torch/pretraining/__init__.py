"""Pretraining of the port: the contrastive train step (config, SupPatchNCE
loss, patch sampling and projectors, schedules, the train-mode UNet or ViT
on the kernels and their backward kernels, AdamW), `build_all`, the
two-view dataset with its paired augmentation, warm start, and the trainer
loop with its CLI (`python -m anatomix_tpu_torch.pretraining.train`).

Importing this package imports none of its modules; names load on first
use. The loop itself is `pretraining.train.train`: the name `train` here is
the submodule (which the import system binds on the package whenever it is
imported), so it is not also a lazy name for the function.
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
    "compute_val_loss": "anatomix_tpu_torch.pretraining.train",
    "build_parser": "anatomix_tpu_torch.pretraining.train",
    "config_from_args": "anatomix_tpu_torch.pretraining.train",
    "H5TwoViewDataset": "anatomix_tpu_torch.pretraining.dataset",
    "make_pair_augment": "anatomix_tpu_torch.pretraining.dataset",
    "normalize_img": "anatomix_tpu_torch.pretraining.dataset",
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
