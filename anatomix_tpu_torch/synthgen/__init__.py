"""Synthetic training-data generation (TotalSegmentator-derived ensembles):
the port's own copy of `anatomix_tpu.synthgen`.

The reference's `synthetic-data-generation/` (steps 0-3 and the datagen
utils) as a numpy/scipy process-pool pipeline on the host. It writes the
H5 files the pretraining trainer reads; nothing of it runs on the card (the
JAX package runs none of it on an accelerator either), and its numpy draws
equal the JAX package's for the same seeds.
"""

from anatomix_tpu_torch.synthgen.core import (
    apply_random_affine_transform,
    ball,
    crop_and_pad_3d_volume,
    dilation,
    draw_perlin,
    draw_perlin_deformation,
    erosion,
    generate_grid_unit,
    generate_voxel_sphere,
    median_filter_labels,
    minmax,
    rescale_coords,
    sample_corruption,
    sample_gmm,
    transform_uniform,
)
from anatomix_tpu_torch.synthgen.pipeline import (
    generate_label_ensemble,
    generate_training_data,
    merge_vertebrae_and_ribs,
    process_volume,
    run_step1,
    run_step2,
    run_step3,
)
from anatomix_tpu_torch.synthgen.transforms_np import view_corruption_chain

__all__ = [
    "apply_random_affine_transform",
    "ball",
    "crop_and_pad_3d_volume",
    "dilation",
    "draw_perlin",
    "draw_perlin_deformation",
    "erosion",
    "generate_grid_unit",
    "generate_label_ensemble",
    "generate_training_data",
    "generate_voxel_sphere",
    "median_filter_labels",
    "merge_vertebrae_and_ribs",
    "minmax",
    "process_volume",
    "rescale_coords",
    "run_step1",
    "run_step2",
    "run_step3",
    "sample_corruption",
    "sample_gmm",
    "transform_uniform",
    "view_corruption_chain",
]
