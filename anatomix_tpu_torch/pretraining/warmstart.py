"""Warm start and partial checkpoint loading (the port of
`anatomix_tpu/pretraining/warmstart.py`, the reference's `BaseModel`
behaviours, `base_model.py:119-143` and `:267-388`): a partial load that
keeps the fresh init of the output head where its shapes changed and fails
on any other mismatch, the load precedence continue_train >
pretrained_name > pretrained_G_only_ckpt, and validation early stopping.

Parameters are the port's: `params_g` of a UNet is the flat state dict
(`model.<i>.weight`, `.bias`, `.running_mean`, `.running_var`). A
`latest_net_G.npz` the JAX package's trainer wrote is a nested tree (layer
id -> {"w", "b"} or {"scale", "bias", "mean", "var"}, or the ViT's
pytree); `params_g_from_checkpoint` tells the two layouts apart by their
keys and carries the JAX one across.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping

import numpy as np
import torch

from anatomix_tpu_torch.models.unet import UnetPlan

_LAYER = re.compile(r"model\.(\d+)\.")


def head_layer_keys(plan: UnetPlan) -> set[str]:
    """Layer ids (as strings) of the output head, the final conv."""
    return {str(max(i for i, s in enumerate(plan.layers)
                    if s.kind == "conv"))}


def load_partial(plan: UnetPlan, current: Mapping[str, torch.Tensor],
                 loaded: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Merge `loaded` into `current` (flat `model.<i>.<leaf>` keys): a leaf
    of the same shape comes from the checkpoint, on `current`'s device and
    dtype; an output-head leaf that is missing or changed shape keeps its
    fresh init; any other mismatch raises."""
    head = head_layer_keys(plan)
    merged: dict[str, torch.Tensor] = {}
    reinit: list[str] = []
    for key, cur in current.items():
        m = _LAYER.match(key)
        in_head = m is not None and m.group(1) in head
        val = loaded.get(key)
        if val is not None and tuple(np.shape(val)) == tuple(cur.shape):
            merged[key] = torch.as_tensor(np.asarray(val)).to(
                device=cur.device, dtype=cur.dtype)
        elif in_head:
            reinit.append(key)
            merged[key] = cur
        elif val is None:
            raise ValueError(f"Checkpoint is missing {key}")
        else:
            raise ValueError(f"Shape mismatch at {key}: checkpoint "
                             f"{np.shape(val)} vs model {tuple(cur.shape)}")
    if reinit:
        print(f"Partially loaded; re-initialized head params: {reinit}")
    return merged


def params_g_from_checkpoint(plan, loaded: Mapping[str, Any]):
    """A G checkpoint's tree (`load_pytree`) as the port's flat state dict
    (CPU f32 tensors): the port's own layout as it is, or the JAX package's
    nested pytree through `models.convert.from_jax_params` (a UNet plan) or
    `vit3d.convert.from_jax_primus_params` (a `PrimusConfig`)."""
    if not any(isinstance(v, Mapping) for v in loaded.values()):
        return {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in loaded.items()}
    if isinstance(plan, UnetPlan):
        from anatomix_tpu_torch.models.convert import from_jax_params
        from anatomix_tpu_torch.models.unet import trainable_state

        return trainable_state(plan, from_jax_params(plan, loaded))
    from anatomix_tpu_torch.models.vit3d.convert import from_jax_primus_params

    return from_jax_primus_params(plan, loaded)


def resolve_warm_start(run_dir: str, *, continue_train: bool = False,
                       pretrained_name: str | None = None,
                       pretrained_g_only_ckpt: str | None = None,
                       ckpt_root: str | None = None):
    """(g_ckpt_path, f_ckpt_path, resume_state_path) by the reference's
    precedence; any of them may be None."""
    if continue_train:
        state = os.path.join(run_dir, "latest_train_state.npz")
        if os.path.exists(state):
            return None, None, state
        print("continue_train set but no train state found; starting fresh")
    if pretrained_name and pretrained_name != "None":
        base = os.path.join(ckpt_root or os.path.dirname(run_dir),
                            pretrained_name)
        return (os.path.join(base, "latest_net_G.npz"),
                os.path.join(base, "latest_net_F.npz"), None)
    if pretrained_g_only_ckpt and pretrained_g_only_ckpt != "None":
        return pretrained_g_only_ckpt, None, None
    return None, None, None


class EarlyStopping:
    """Validation-loss early stopping (`pretraining_networks.py` of the
    reference, in its API though unused by its loop)."""

    def __init__(self, patience: int = 7, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.counter = 0
        self.should_stop = False

    def step(self, val_loss: float) -> bool:
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop
