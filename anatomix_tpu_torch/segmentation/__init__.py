"""Few-shot semantic segmentation finetuning (the port of
`anatomix_tpu.segmentation`, with the same public names).

The public surface mirrors the reference's `anatomix/segmentation/
__init__.py`: `load_model`, the train and val transforms, `data_handler`;
the loop and its CLI are `segmentation.train`.
"""

from anatomix_tpu_torch.segmentation.data import (
    VolumeCache,
    data_handler,
    natsorted,
)
from anatomix_tpu_torch.segmentation.losses import (
    cross_entropy_loss,
    dice_ce_loss,
    dice_loss,
)
from anatomix_tpu_torch.segmentation.model import (
    apply_head,
    init_head,
    load_seg_model,
    seg_forward,
)
from anatomix_tpu_torch.segmentation.transforms import (
    train_transform,
    val_transform,
)

load_model = load_seg_model  # reference-compatible alias

__all__ = [
    "VolumeCache",
    "apply_head",
    "cross_entropy_loss",
    "data_handler",
    "dice_ce_loss",
    "dice_loss",
    "init_head",
    "load_model",
    "load_seg_model",
    "natsorted",
    "seg_forward",
    "train_transform",
    "val_transform",
]
