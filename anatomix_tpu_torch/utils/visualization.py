"""Mid-slice figure panels and volume dumps of live training tensors (the
port's copy of `anatomix_tpu/utils/visualization.py`; matplotlib is
imported only when a figure is drawn)."""

from __future__ import annotations

import os

import numpy as np
import torch

from anatomix_tpu_torch.utils.nifti import save_volume


def _numpy(vol) -> np.ndarray:
    if torch.is_tensor(vol):
        return vol.detach().float().cpu().numpy()
    return np.asarray(vol)


def tensor2img(vol, slice_index: int | None = None) -> np.ndarray:
    """Mid-slice (or chosen slice) of a (D, H, W[, C]) volume, normalized to
    [0, 1] for display."""
    vol = _numpy(vol)
    if vol.ndim == 4:
        vol = vol[..., 0]
    idx = vol.shape[0] // 2 if slice_index is None else slice_index
    img = vol[idx].astype(np.float32)
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo + 1e-8)


def panel_figure(volumes: dict, slice_index: int | None = None,
                 ncols: int = 2):
    """Matplotlib figure of mid-slices (TensorBoard `add_figure` style), or
    None when matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    n = len(volumes)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 4 * nrows),
                             squeeze=False)
    for ax in axes.ravel():
        ax.axis("off")
    for ax, (name, vol) in zip(axes.ravel(), volumes.items()):
        ax.imshow(tensor2img(vol, slice_index), cmap="gray")
        ax.set_title(name)
    fig.tight_layout()
    return fig


def log_panels(logger, tag: str, volumes: dict, step: int,
               slice_index: int | None = None):
    """Log mid-slice panels to a `ScalarLogger`'s TensorBoard writer (no-op
    without one)."""
    tb = getattr(logger, "_tb", None)
    if tb is None:
        return
    fig = panel_figure(volumes, slice_index)
    if fig is not None:
        tb.add_figure(tag, fig, int(step))


def save_tensor(vol, path: str, affine=None) -> None:
    """Dump a live training tensor (or array) to .nii.gz / .npy / .npz; a
    5-D batch keeps its first sample's first channel, a 4-D volume its
    first channel."""
    arr = _numpy(vol)
    if arr.ndim == 5:
        arr = arr[0, ..., 0]
    elif arr.ndim == 4:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_volume(path, arr.astype(np.float32), affine)
