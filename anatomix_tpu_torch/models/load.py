"""Model loading: a local `.pth` or `.npz`, a registry variant from a local
file, or seeded random weights. Nothing is downloaded.

Returns `(plan, state_dict)` with the state dict on the requested device;
for the ViT variant the plan is its `PrimusConfig`. The `.npz` format is the
JAX package's native one (`save_npz`: flat `"<idx>/<leaf>"` keys of the
pytree; the ViT's `save_pytree` paths), read here without JAX.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from anatomix_tpu_torch.device import resolve_device
from anatomix_tpu_torch.models.convert import (
    check_state_dict,
    from_jax_params,
    load_pth,
)
from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
from anatomix_tpu_torch.models.unet import (
    UnetConfig,
    UnetPlan,
    build_plan,
    init_params,
)
from anatomix_tpu_torch.models.vit3d import (
    load_primus_state_dict,
    primus_config,
)


def load_npz(path: str) -> dict[str, dict[str, np.ndarray]]:
    """Read a JAX-format `.npz` into the nested pytree (numpy leaves)."""
    params: dict[str, dict[str, np.ndarray]] = {}
    with np.load(path) as flat:
        for key in flat.files:
            idx, leaf = key.split("/", 1)
            params.setdefault(idx, {})[leaf] = flat[key]
    return params


def save_npz(path: str, params: dict[str, dict[str, Any]]) -> None:
    """Write a pytree as the JAX package's flat `.npz`."""
    flat = {
        f"{idx}/{leaf}": np.asarray(val)
        for idx, sub in params.items() for leaf, val in sub.items()
    }
    np.savez(path, **flat)


def _state_dict_from_file(plan: UnetPlan, path: str):
    if path.endswith(".npz"):
        sd = from_jax_params(plan, load_npz(path))
        check_state_dict(plan, sd)
        return sd
    return load_pth(path, plan)


def _to_device(sd: dict[str, torch.Tensor], device: torch.device):
    return {k: v.to(device) for k, v in sd.items()}


def load_from_hf(variant: str, cache_path: str | None = None, *,
                 device: str | torch.device = "cuda"):
    """A registry variant from a local copy of its `<variant>.pth` or
    `.npz` (`cache_path`), on the variant's own plan (for `anatomix-dev`:
    instance norm with eps 1e-2, Avg pool, trilinear; for
    `anatomix-dev-vit`: its `PrimusConfig`, a `.npz` of the JAX pytree or
    the upstream `.pth`); the port makes no download."""
    dev = resolve_device(device)
    if variant not in ANATOMIX_VARIANTS:
        raise ValueError(
            f"Unknown variant {variant!r}. Known: {sorted(ANATOMIX_VARIANTS)}"
        )
    config = ANATOMIX_VARIANTS[variant]
    if cache_path is None:
        raise ValueError(
            "the port downloads nothing: pass cache_path= to a local "
            f"{variant}.pth or .npz"
        )
    if "vit_kwargs" in config:
        cfg = primus_config(config["vit_kwargs"])
        return cfg, _to_device(load_primus_state_dict(cfg, cache_path), dev)
    plan = build_plan(UnetConfig(**config["unet_kwargs"]))
    return plan, _to_device(_state_dict_from_file(plan, cache_path), dev)


def load_model(
    ckpt_path: str | None = None,
    hf_variant: str | None = None,
    *,
    cache_path: str | None = None,
    num_downs: int = 4,
    ngf: int = 16,
    output_nc: int = 16,
    norm: str = "batch",
    interp: str = "nearest",
    pooling: str = "Max",
    allow_scratch: bool = False,
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """Exactly one of `ckpt_path` / `hf_variant`. `ckpt_path="scratch"`
    (with `allow_scratch`) gives seeded random weights. Returns
    `(plan, state_dict)`."""
    dev = resolve_device(device)
    if (ckpt_path is None) == (hf_variant is None):
        raise ValueError("Provide exactly one of `ckpt_path` or `hf_variant`.")
    if hf_variant is not None:
        return load_from_hf(hf_variant, cache_path, device=dev)

    plan = build_plan(UnetConfig(
        dimension=3, input_nc=1, output_nc=output_nc, num_downs=num_downs,
        ngf=ngf, norm=norm, interp=interp, pooling=pooling,
    ))
    if ckpt_path == "scratch":
        if not allow_scratch:
            raise ValueError(
                "'scratch' is not supported for registration; "
                "registration requires pretrained weights."
            )
        gen = torch.Generator().manual_seed(seed)
        return plan, _to_device(init_params(plan, gen), dev)
    if not os.path.isfile(ckpt_path):
        raise FileNotFoundError(f"Checkpoint file not found: {ckpt_path}")
    return plan, _to_device(_state_dict_from_file(plan, ckpt_path), dev)
