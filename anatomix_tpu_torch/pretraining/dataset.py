"""Two-view dataset and paired augmentation of the pretraining loop (the
port of `anatomix_tpu/pretraining/dataset.py`).

Host side: per item, two timepoints of a subject (`img` (T, D, H, W),
shared `seg` (D, H, W)), each percentile min-max normalized. The source is
an H5 file (opened with `h5py`, imported when a path is given) or any
mapping of subject -> {"img", "seg"} holding arrays, which is what an open
H5 file is; the timepoints come from the same numpy `Generator` calls as in
the JAX package, so one seed picks the same subjects, timepoints and
arrays.

Augmentation, on the volumes' device: spatial transforms (flips p 0.9,
affine p 0.5, scale 1 +- 0.4, +-45 degrees; bilinear for the images,
nearest for the seg) shared by the two views and the seg; intensity
transforms (blur and noise p 0.33, bias field and gamma p 0.5, motion
ghosting p 0.33) per view, or shared with `apply_same_inten_augment`; then
a shared random crop to crop^3. It is split into a draw,
`draw_pair_params` (decisions and parameters from a CPU generator; the
noise fields on the device), and a deterministic apply,
`apply_pair_augment`.
"""

from __future__ import annotations

import math
import os
from typing import Any, Mapping

import numpy as np
import torch

from anatomix_tpu_torch.ops.augment import (
    _gamma_of,
    _randint,
    _uniform,
    add_noise,
    affine_matrix_3d,
    apply_affine,
    apply_bias_field,
    crop,
    crop_offsets,
    flip,
    gamma,
    motion_ghosting,
    n_bias_coeffs,
    smooth_axis,
)

# the intensity chain: (name, probability), in the order it applies
INTENSITY_CHAIN = (("blur", 0.33), ("noise", 0.33), ("bias", 0.5),
                   ("gamma", 0.5), ("motion", 0.33))
BLUR_MAX_SIGMA = 2.0
NOISE_MAX_STD = 0.25
BIAS_COEFF_RANGE = (-0.5, 0.5)
BIAS_DEGREE = 3
LOG_GAMMA_RANGE = (-0.4, 0.4)
MOTION_GHOSTS = (2, 10)
MOTION_INTENSITY = (0.1, 0.5)
FLIP_P = 0.9
AFFINE_P = 0.5
AFFINE_DEGREES = 45.0
AFFINE_SCALE = 0.4


def normalize_img(array: np.ndarray, percentile: float | None = None,
                  zero_centered: bool = True) -> np.ndarray:
    """[0, 1] (or [-1, 1]) normalization with a percentile upper bound
    (`data/data_utils.py:4-46` of the reference)."""
    array = np.asarray(array, np.float32)
    min_ = array.min()
    max_ = (np.percentile(array, percentile) if percentile is not None
            else array.max())
    if max_ - min_ > 0:
        array = (array - min_) / (max_ - min_)
    if zero_centered:
        array = array * 2 - 1
    return array


# -----------------------------------------------------------------------------
# intensity chain: draw and apply

def _draw_intensity(gen, cfg, shape, field_gen) -> dict[str, Any]:
    """Parameters of one view's intensity chain: each transform's entry is
    None where it is switched off or its coin said no."""
    out: dict[str, Any] = {}
    for name, p in INTENSITY_CHAIN:
        out[name] = None
        if not getattr(cfg, name) or not _uniform(gen, 0.0, 1.0) < p:
            continue
        if name == "blur":
            out[name] = _uniform(gen, 0.0, BLUR_MAX_SIGMA, 3)
        elif name == "noise":
            out[name] = {"std": _uniform(gen, 0.0, NOISE_MAX_STD),
                         "field": torch.randn(tuple(shape),
                                              generator=field_gen,
                                              device=field_gen.device)}
        elif name == "bias":
            out[name] = _uniform(gen, *BIAS_COEFF_RANGE,
                                 n_bias_coeffs(BIAS_DEGREE))
        elif name == "gamma":
            out[name] = _gamma_of(_uniform(gen, *LOG_GAMMA_RANGE))
        else:
            out[name] = (_randint(gen, 0, 3),
                         _randint(gen, MOTION_GHOSTS[0], MOTION_GHOSTS[1] + 1),
                         _uniform(gen, *MOTION_INTENSITY))
    return out


def apply_intensity(x: torch.Tensor, chain: Mapping[str, Any]):
    """The intensity chain with drawn parameters (`_draw_intensity`'s
    layout), in the order blur, noise, bias, gamma, motion."""
    if chain.get("blur") is not None:
        for axis, s in enumerate(chain["blur"]):
            x = smooth_axis(x, s, axis, max_sigma=BLUR_MAX_SIGMA)
    if chain.get("noise") is not None:
        x = add_noise(x, chain["noise"]["field"].to(x.device),
                      chain["noise"]["std"])
    if chain.get("bias") is not None:
        x = apply_bias_field(x, chain["bias"], BIAS_DEGREE)
    if chain.get("gamma") is not None:
        x = gamma(x, chain["gamma"])
    if chain.get("motion") is not None:
        x = motion_ghosting(x, *chain["motion"])
    return x


# -----------------------------------------------------------------------------
# the pair augment: draw and apply

def draw_pair_params(gen: torch.Generator, cfg, shape,
                     field_gen: torch.Generator | None = None):
    """Draw one item's augment parameters for volumes of `shape` (D, H, W):
    decisions and parameters from `gen` (a CPU generator), the noise
    fields from `field_gen` on its device (default `gen`). Returns
    {"flip": 3 bools or None, "affine": a 3x4 matrix or None, "inten":
    [view a's chain, view b's chain] or None, "crop": offsets or None}."""
    field_gen = field_gen or gen
    params: dict[str, Any] = {"flip": None, "affine": None, "inten": None,
                              "crop": None}
    if cfg.augment and cfg.geo_augment:
        if _uniform(gen, 0.0, 1.0) < FLIP_P:
            params["flip"] = [u < 0.5 for u in _uniform(gen, 0.0, 1.0, 3)]
        if _uniform(gen, 0.0, 1.0) < AFFINE_P:
            deg = math.radians(AFFINE_DEGREES)
            rot = _uniform(gen, -deg, deg, 3)
            scale = [1.0 + u for u in _uniform(gen, -AFFINE_SCALE,
                                               AFFINE_SCALE, 3)]
            params["affine"] = affine_matrix_3d(rotate=rot, scale=scale)
    if cfg.augment and cfg.inten_augment:
        chain_a = _draw_intensity(gen, cfg, shape, field_gen)
        chain_b = (chain_a if cfg.apply_same_inten_augment
                   else _draw_intensity(gen, cfg, shape, field_gen))
        params["inten"] = [chain_a, chain_b]
    if cfg.crop_size > 0:
        params["crop"] = crop_offsets(gen, shape, cfg.crop_size)
    return params


def apply_pair_augment(params: Mapping[str, Any], img_a: torch.Tensor,
                       img_b: torch.Tensor, seg: torch.Tensor, *,
                       crop_size: int):
    """Apply drawn parameters (`draw_pair_params`' layout) to one item:
    img_* (D, H, W) float, seg (D, H, W). Returns views (2, c, c, c, 1) and
    the seg (c, c, c, 1) as f32, c = `crop_size` (the volume's size when
    `params["crop"]` is None)."""
    seg = seg.float()
    if params["flip"] is not None:
        img_a, img_b, seg = (flip(v, params["flip"])
                             for v in (img_a, img_b, seg))
    if params["affine"] is not None:
        m = params["affine"]
        img_a = apply_affine(img_a, m, mode="bilinear")
        img_b = apply_affine(img_b, m, mode="bilinear")
        seg = apply_affine(seg, m, mode="nearest")
    if params["inten"] is not None:
        img_a = apply_intensity(img_a, params["inten"][0])
        img_b = apply_intensity(img_b, params["inten"][1])
    if params["crop"] is not None:
        img_a, img_b, seg = crop((img_a, img_b, seg), params["crop"],
                                 crop_size)
    return torch.stack([img_a, img_b])[..., None], seg[..., None]


def make_pair_augment(cfg):
    """`(gen, img_a, img_b, seg, field_gen=None) -> (views, seg)`: one
    draw (`draw_pair_params`) and its apply (`apply_pair_augment`) at
    `cfg`'s settings."""
    def augment(gen, img_a, img_b, seg, field_gen=None):
        params = draw_pair_params(gen, cfg, img_a.shape, field_gen)
        return apply_pair_augment(params, img_a, img_b, seg,
                                  crop_size=cfg.crop_size)

    return augment


# -----------------------------------------------------------------------------
# the host reader

class H5TwoViewDataset:
    """Host-side reader yielding (img_i, img_j, seg) numpy triples from an
    H5 path or a mapping of subject -> {"img", "seg"}."""

    def __init__(self, source, cfg, train: bool = True):
        if isinstance(source, (str, bytes, os.PathLike)):
            import h5py

            self.h5 = h5py.File(source, "r")
            self._owned = True
        else:
            self.h5 = source
            self._owned = False
        self.subjects = list(self.h5.keys())
        self.cfg = cfg
        self.train = train

    def __len__(self):
        # padded up to batch_size so one epoch always yields a full batch
        # (a batch may then repeat a subject, with other views and augments)
        return max(len(self.subjects), self.cfg.batch_size)

    def _pick(self, item: int, rng: np.random.Generator):
        """The item's subject group and its two timepoints, drawn from
        `rng`."""
        subj = self.subjects[item % len(self.subjects)]
        grp = self.h5[subj]
        n_tps = grp["img"].shape[0]
        if self.cfg.view_order and n_tps > 1:
            i = int(rng.integers(0, n_tps - 1))
            j = i + 1
        elif n_tps > 1:
            i, j = rng.choice(n_tps, size=2, replace=False)
        else:
            i = j = 0
        return grp, i, j

    def draw(self, item: int, rng: np.random.Generator):
        """The draws `get` takes from `rng` for `item`, without reading its
        volumes; returns their (D, H, W)."""
        grp, _, _ = self._pick(item, rng)
        return tuple(grp["img"].shape[1:])

    def get(self, item: int, rng: np.random.Generator):
        grp, i, j = self._pick(item, rng)
        img_a = normalize_img(grp["img"][int(i)], self.cfg.percentile,
                              self.cfg.zero_centered)
        img_b = normalize_img(grp["img"][int(j)], self.cfg.percentile,
                              self.cfg.zero_centered)
        seg = np.asarray(grp["seg"], np.float32)
        return img_a, img_b, seg

    def close(self):
        if self._owned:
            self.h5.close()
