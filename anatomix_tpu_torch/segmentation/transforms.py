"""Segmentation train and val transform chains (the port of
`anatomix_tpu/segmentation/transforms.py`, the reference's
`get_train_transforms` / `get_val_transforms`).

Train: scale-intensity -> random crop^3 -> p = 0.33 each of Gaussian noise,
a bias field (coefficients <= 0.05), Gibbs ringing (alpha <= 0.33),
contrast (gamma 0.5-4.5), Gaussian smoothing (sigma <= 0.1 per axis) and
Gaussian sharpening -> an affine with p = 0.98 (rotation +-pi/4, scale
+-0.2, shear +-0.2; bilinear image, nearest label, zero padding) -> a final
rescale. Val: scale-intensity only.

As in `pretraining/dataset.py`, the chain is split in two:
`draw_train_params` draws the crop, the decisions and every parameter from
a CPU `torch.Generator` (the noise field on `field_gen`'s device), and
`apply_train_transform` applies them on the volumes' device with the
applies of `ops/augment.py`. JAX's threefry draws and torch's generators
never agree, so the apply is what is held against the JAX package, fed the
parameters JAX drew.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import torch

from anatomix_tpu_torch.ops.augment import (
    _uniform,
    add_noise,
    apply_affine,
    apply_bias_field,
    crop,
    crop_offsets,
    gamma,
    gaussian_sharpen,
    gibbs_noise,
    n_bias_coeffs,
    rand_affine_params,
    scale_intensity,
    smooth_axis,
)

# the intensity chain: (name, probability), in the order it applies
INTENSITY_CHAIN = (("noise", 0.33), ("bias", 0.33), ("gibbs", 0.33),
                   ("contrast", 0.33), ("smooth", 0.33), ("sharpen", 0.33))
NOISE_MAX_STD = 0.1
BIAS_COEFF_RANGE = (0.0, 0.05)
BIAS_DEGREE = 3
GIBBS_ALPHA_RANGE = (0.0, 0.33)
CONTRAST_GAMMA_RANGE = (0.5, 4.5)
SMOOTH_SIGMA_RANGE = (0.0, 0.1)
SHARPEN_SIGMA_RANGE = (0.5, 1.0)
SHARPEN_ALPHA_RANGE = (10.0, 30.0)
AFFINE_P = 0.98


def draw_train_params(gen: torch.Generator, shape: Sequence[int], crop_size: int,
                      field_gen: torch.Generator | None = None
                      ) -> dict[str, Any]:
    """One sample's transform parameters for a volume of `shape` (D, H, W):
    `crop` (offsets z, y, x) and `size`; for each step of the intensity
    chain its parameters or None (`noise`: {"std", "field" (crop^3)},
    `bias`: 20 coefficients, `gibbs`: alpha, `contrast`: gamma, `smooth`:
    three sigmas, `sharpen`: (sigma1, sigma2, alpha)); `affine`: a 3x4
    matrix or None. Decisions and scalars come from `gen` (CPU); the noise
    field from `field_gen` (default `gen`) on its device."""
    field_gen = field_gen or gen
    params: dict[str, Any] = {"crop": crop_offsets(gen, shape, crop_size),
                              "size": crop_size}
    for name, p in INTENSITY_CHAIN:
        params[name] = None
        if not _uniform(gen, 0.0, 1.0) < p:
            continue
        if name == "noise":
            params[name] = {
                "std": _uniform(gen, 0.0, NOISE_MAX_STD),
                "field": torch.randn((crop_size,) * 3, generator=field_gen,
                                     device=field_gen.device)}
        elif name == "bias":
            params[name] = _uniform(gen, *BIAS_COEFF_RANGE,
                                    n_bias_coeffs(BIAS_DEGREE))
        elif name == "gibbs":
            params[name] = _uniform(gen, *GIBBS_ALPHA_RANGE)
        elif name == "contrast":
            params[name] = _uniform(gen, *CONTRAST_GAMMA_RANGE)
        elif name == "smooth":
            params[name] = _uniform(gen, *SMOOTH_SIGMA_RANGE, 3)
        else:
            params[name] = (_uniform(gen, *SHARPEN_SIGMA_RANGE),
                            _uniform(gen, *SHARPEN_SIGMA_RANGE),
                            _uniform(gen, *SHARPEN_ALPHA_RANGE))
    params["affine"] = (rand_affine_params(gen, rotate_range=math.pi / 4,
                                           scale_range=0.2, shear_range=0.2)
                        if _uniform(gen, 0.0, 1.0) < AFFINE_P else None)
    return params


def apply_train_transform(image: torch.Tensor, label: torch.Tensor,
                          params: Mapping[str, Any]):
    """One training sample with drawn parameters (`draw_train_params`'
    layout), image and label (D, H, W) on one device -> (image, label),
    each (size^3) f32, the label's values integral."""
    img = scale_intensity(image.float())
    img, lab = crop([img, label], params["crop"], params["size"])
    if params["noise"] is not None:
        img = add_noise(img, params["noise"]["field"].to(img.device),
                        params["noise"]["std"])
    if params["bias"] is not None:
        img = apply_bias_field(img, params["bias"], BIAS_DEGREE)
    if params["gibbs"] is not None:
        img = gibbs_noise(img, params["gibbs"])
    if params["contrast"] is not None:
        img = gamma(img, params["contrast"])
    if params["smooth"] is not None:
        for axis, s in enumerate(params["smooth"]):
            img = smooth_axis(img, s, axis, max_sigma=SMOOTH_SIGMA_RANGE[1])
    if params["sharpen"] is not None:
        s1, s2, alpha = params["sharpen"]
        img = gaussian_sharpen(img, s1, s2, alpha,
                               max_sigma1=SHARPEN_SIGMA_RANGE[1],
                               max_sigma2=SHARPEN_SIGMA_RANGE[1])
    lab = lab.float()
    if params["affine"] is not None:
        img = apply_affine(img, params["affine"], mode="bilinear")
        lab = apply_affine(lab, params["affine"], mode="nearest")
    return scale_intensity(img), lab


def train_transform(gen: torch.Generator, image: torch.Tensor,
                    label: torch.Tensor, crop_size: int,
                    field_gen: torch.Generator | None = None):
    """One training sample: a draw (`draw_train_params`) and its apply."""
    params = draw_train_params(gen, image.shape, crop_size, field_gen)
    return apply_train_transform(image, label, params)


def val_transform(image: torch.Tensor) -> torch.Tensor:
    return scale_intensity(image.float())
