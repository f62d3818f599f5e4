"""Few-shot segmentation data handling (the port of
`anatomix_tpu/segmentation/data.py`).

`data_handler` matches the reference's: natural-sorted globs of
imagesTr/labelsTr/imagesVal/labelsVal, the same seeded (12345) numpy
permutation, the first `finetuning_amount` pairs, replicated
x(iters * bs // amount) to fill an epoch, so the file lists equal the JAX
package's. `VolumeCache` holds every volume it has read as an f32 tensor on
one device: the few-shot set is a handful of volumes, so on the card they
are read and sent once, and each training sample is cropped and augmented
where it lies instead of crossing the bus again.
"""

from __future__ import annotations

import os
import re
from glob import glob

import numpy as np
import torch

from anatomix_tpu_torch.utils.nifti import load_volume


def natsorted(items):
    """Natural sort: numeric runs compare numerically ('img2' < 'img10')."""

    def key(s):
        return [
            int(tok) if tok.isdigit() else tok.lower()
            for tok in re.split(r"(\d+)", str(s))
        ]

    return sorted(items, key=key)


def data_handler(
    basedir: str,
    finetuning_amount: int = 3,
    iters_per_epoch: int = 75,
    batch_size: int = 3,
    seed: int = 12345,
    ext: str = "*.nii.gz",
):
    """`(train images, train labels, val images, val labels)` path lists."""
    trimages = natsorted(glob(os.path.join(basedir, "imagesTr", ext)))
    trsegs = natsorted(glob(os.path.join(basedir, "labelsTr", ext)))
    if not trimages or len(trimages) != len(trsegs):
        raise ValueError(
            f"{basedir}: {len(trimages)} training images and {len(trsegs)} "
            "labels; need at least one of each, paired")

    trimages = np.random.RandomState(seed=seed).permutation(trimages).tolist()
    trsegs = np.random.RandomState(seed=seed).permutation(trsegs).tolist()
    trimages = trimages[:finetuning_amount]
    trsegs = trsegs[:finetuning_amount]

    samples_per_epoch = iters_per_epoch * batch_size
    repeats = max(1, samples_per_epoch // finetuning_amount)
    trimages = trimages * repeats
    trsegs = trsegs * repeats

    vaimages = natsorted(glob(os.path.join(basedir, "imagesVal", ext)))
    vasegs = natsorted(glob(os.path.join(basedir, "labelsVal", ext)))
    return trimages, trsegs, vaimages, vasegs


class VolumeCache:
    """Every volume read once, kept as an f32 tensor on `device` (the
    reference keeps its MONAI CacheDataset in RAM, cache_rate 1.0)."""

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self._cache: dict[str, torch.Tensor] = {}

    def get(self, path: str) -> torch.Tensor:
        if path not in self._cache:
            vol = np.asarray(load_volume(path)[0], np.float32)
            self._cache[path] = torch.from_numpy(vol).to(self.device)
        return self._cache[path]
