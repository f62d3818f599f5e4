"""Typed pretraining configuration: the port's copy of the JAX package's
`anatomix_tpu/pretraining/config.py` (pure Python; the port imports nothing
of the JAX package).

Defaults reproduce the reference launcher's (`pretrain_anatomix.py`) and
its base options: 6M UNet, crop 128, bs 1, nce_T 0.33, AdamW lr 2e-4 wd
1e-5, 512 patches, netF 256x3 MLPs, const_linear schedule, kaiming init,
taps 27,31,38,45,52,65, full augmentation with shared spatial and per-view
intensity transforms.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence


@dataclasses.dataclass
class PretrainConfig:
    # experiment
    name: str = "demo"
    ckpt_dir: str = "./checkpoints/pretrain"
    dataroot: str = "./h5_w_segs"
    seed: int = 1234567

    # model (generator)
    netG: str = "unet"  # 'unet' | 'primus'
    ndims: int = 3
    input_nc: int = 1
    output_nc: int = 16
    ngf: int = 16
    num_downs: int = 4
    normG: str = "batch"
    norm_eps_G: float = 1e-5
    actG: str = "relu"
    pool_type: str = "Max"
    interp_type: str = "nearest"
    init_type: str = "kaiming"
    init_gain: float = 0.02

    # projector (netF)
    netF_nc: int = 256
    n_mlps: int = 3
    normF: str = "batch"
    norm_eps_F: float = 1e-5

    # NCE
    nce_layers: Sequence[int] = (27, 31, 38, 45, 52, 65)
    nce_weights: Sequence[float] | None = None  # None -> uniform
    nce_T: float = 0.33
    lambda_NCE: float = 1.0
    num_patches: int = 512
    weigh_rarity: bool = False
    balance_denominator: bool = False
    weighting_mode: str = "raw"
    load_mask: bool = False  # sample patches from foreground (seg>0) only

    # data
    crop_size: int = 128
    batch_size: int = 1
    percentile: float = 99.99
    zero_centered: bool = True
    view_order: bool = False
    augment: bool = True
    geo_augment: bool = True
    inten_augment: bool = True
    apply_same_inten_augment: bool = False
    blur: bool = True
    noise: bool = True
    bias: bool = True
    gamma: bool = True
    motion: bool = True

    # optimization
    lr: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 1e-5
    grad_accum_iters: int = 1
    clip_grad: bool = False
    max_norm_G: float = 2.0
    max_norm_F: float = 2.0
    lr_policy: str = "const_linear"
    n_epochs: int = 0
    n_epochs_decay: int = 4

    # loop cadences
    print_freq: int = 100
    display_freq: int = 100
    save_latest_freq: int = 400
    save_freq: int = 4000
    evaluation_freq: int = 200
    n_val_during_train: int = 50
    max_iters: int = 0  # 0 = unlimited (smoke-test hook)
    continue_train: bool = False
    pretrained_name: str = "None"  # warm-start G+F from another run dir
    pretrained_G_only_ckpt: str = "None"  # warm-start G only, F fresh
    unfreeze_layers: str = ""  # comma list; others up to last tap frozen

    # parallelism
    data_parallel_devices: int = 0  # 0 = all local devices
    # multi-host data parallelism (SURVEY §2.6/§5.8): one trainer process
    # per host, global 'data' mesh over every device, batch_size = GLOBAL
    # batch; each process reads only its contiguous shard of the batch and
    # the pipeline is per-item deterministic, so the loss is identical for
    # any process count on the same global batch.
    multihost: bool = False

    def tap_layers(self):
        return tuple(int(i) for i in self.nce_layers)

    def save(self, path: str) -> None:
        """Persist the resolved config (the reference's train_opt.txt role,
        `base_options.py:392-427`)."""
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=list)

    @classmethod
    def load(cls, path: str) -> "PretrainConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls(**raw)
